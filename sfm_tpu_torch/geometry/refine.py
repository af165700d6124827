"""Two-view motion-only Gauss-Newton on SO(3) x S^2 (counterpart of
``sfm_tpu/geometry/refine.py``).

The JAX package builds the [N, 5] Jacobian with ``jax.jacfwd`` and
vmaps the probe starts; here the poses carry a leading batch dimension.

:func:`refine_relative_pose` sends float32 CUDA inputs to K10
(``csrc/refine.cu``): the whole loop of every start in one launch, one
block per start, the five Jacobian columns written out per point, the
5 x 5 solve and the accept / reject decision inside the block, so the
loop launches once and never waits on the host.  Everything else (CPU
tensors, float64) takes :func:`refine_relative_pose_plain`, whose five
Jacobian columns come from five ``torch.func.jvp`` calls, each pushing
one unit tangent through every batch member at once; it is also the
kernel's yardstick.  The two evaluate the same f32 mathematics in
another order (the kernel's derivatives are the closed forms that
``jvp`` takes at ``params = 0``), so they agree to f32 rounding while
the steps' accept / reject decisions agree.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.ops import _cuda
from sfm_tpu_torch.ops.linalg import cross_matrix
from sfm_tpu_torch.geometry import lie
from sfm_tpu_torch.utils.precision import f32_matmul


class RefineResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    E: torch.Tensor
    cost: torch.Tensor
    initial_cost: torch.Tensor


def essential_from_pose(R, t):
    """E = [t]_x R."""
    return cross_matrix(t) @ R


def _sampson(E, x1, x2):
    """Signed Sampson residuals [..., N]."""
    l1 = torch.einsum("...ij,nj->...ni", E, x1)
    l2 = torch.einsum("...ji,nj->...ni", E, x2)
    num = torch.einsum("ni,...ni->...n", x2, l1)
    den = l1[..., 0] ** 2 + l1[..., 1] ** 2 + l2[..., 0] ** 2 + l2[..., 1] ** 2
    return num / torch.sqrt(torch.clamp(den, min=1e-18))


def _huber_weights(r, delta):
    a = r.abs()
    return torch.where(a <= delta, torch.ones_like(r),
                       delta / torch.clamp(a, min=1e-18))


def _unit(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def refine_relative_pose(R, t, x1, x2, weights=None, *, iters: int = 10,
                         huber_delta: float = 3e-3, damping: float = 1e-8):
    """Refine (R [..., 3, 3], t [..., 3]) against [N, 3] correspondences.

    ``weights`` is [..., N] (or [N]); a leading batch dimension on R, t
    and weights refines several starts independently.  K10 for float32
    CUDA inputs, :func:`refine_relative_pose_plain` for the rest.
    """
    if x1.is_cuda and x1.dtype == torch.float32:
        return _refine_kernel(R, t, x1, x2, weights, iters, huber_delta, damping)
    return refine_relative_pose_plain(R, t, x1, x2, weights, iters=iters,
                                      huber_delta=huber_delta, damping=damping)


def _refine_kernel(R, t, x1, x2, weights, iters, huber_delta, damping):
    """K10 on the current stream; allocates its outputs, does not wait."""
    dev = x1.device
    n = x1.shape[0]
    batched = R.dim() == 3
    Rb = (R if batched else R[None]).contiguous()
    tb = (t if batched else t[None]).contiguous()
    B = Rb.shape[0]
    x1c, x2c = x1.contiguous(), x2.contiguous()
    _cuda.require(Rb, "R", torch.float32, (B, 3, 3), dev)
    _cuda.require(tb, "t", torch.float32, (B, 3), dev)
    _cuda.require(x1c, "x1", torch.float32, (n, 3), dev)
    _cuda.require(x2c, "x2", torch.float32, (n, 3), dev)
    w, w_stride = None, 0
    if weights is not None:
        w = weights.to(torch.float32).contiguous()
        if w.numel() == n and w.dim() <= 2:   # [N] or [1, N]: one row for every start
            w = w.reshape(n)
        else:
            w_stride = n
        _cuda.require(w, "weights", torch.float32, (B, n) if w_stride else (n,), dev)
    out = RefineResult(
        R=torch.empty((B, 3, 3), dtype=torch.float32, device=dev),
        t=torch.empty((B, 3), dtype=torch.float32, device=dev),
        E=torch.empty((B, 3, 3), dtype=torch.float32, device=dev),
        cost=torch.empty(B, dtype=torch.float32, device=dev),
        initial_cost=torch.empty(B, dtype=torch.float32, device=dev))
    if B > 0:
        code = _cuda.library().lib.sfm_refine_relative_pose(
            Rb.data_ptr(), tb.data_ptr(), x1c.data_ptr(), x2c.data_ptr(),
            0 if w is None else w.data_ptr(), w_stride, B, n, max(iters, 0),
            huber_delta, damping, *(v.data_ptr() for v in out), _cuda.stream_ptr(dev))
        _cuda.check(code, "refine_relative_pose")
        _cuda.launched("refine_relative_pose")
    if not batched:
        out = RefineResult(*(v[0] for v in out))
    return out


@f32_matmul
def refine_relative_pose_plain(R, t, x1, x2, weights=None, *, iters: int = 10,
                               huber_delta: float = 3e-3, damping: float = 1e-8):
    """:func:`refine_relative_pose` in PyTorch, any device and dtype: the
    Jacobian by ``torch.func.jvp``, the solve by ``solve_ex``."""
    n = x1.shape[0]
    batched = R.dim() == 3
    if not batched:
        R, t = R[None], t[None]
        if weights is not None:
            weights = weights[None]
    B = R.shape[0]
    if weights is None:
        w_in = torch.ones((B, n), dtype=x1.dtype, device=x1.device)
    else:
        w_in = weights.to(x1.dtype).expand(B, n)
    t = _unit(t)

    def residuals(params, R0, t0):
        Rn = R0 @ lie.so3_exp(params[..., :3])
        Bt = lie.tangent_basis(t0)
        tn = _unit(t0 + (Bt @ params[..., 3:, None])[..., 0])
        return _sampson(essential_from_pose(Rn, tn), x1, x2)

    def cost_of(r, w):
        a = r.abs()
        d = huber_delta
        c = torch.where(a <= d, 0.5 * r * r, d * (a - 0.5 * d))
        return torch.sum(c * w, dim=-1)

    eye5 = torch.eye(5, dtype=x1.dtype, device=x1.device)
    r = _sampson(essential_from_pose(R, t), x1, x2)
    c0 = cost_of(r, w_in)
    lam = torch.full((B,), 1e-4, dtype=x1.dtype, device=x1.device)
    zero = torch.zeros((B, 5), dtype=x1.dtype, device=x1.device)
    for _ in range(iters):
        cols = [
            torch.func.jvp(lambda p: residuals(p, R, t), (zero,),
                           (eye5[k].expand(B, 5),))[1]
            for k in range(5)
        ]
        J = torch.stack(cols, dim=-1)                       # [B, N, 5]
        w = w_in * _huber_weights(r, huber_delta)
        JtW = J.transpose(-1, -2) * w[:, None, :]
        H = JtW @ J
        g = (JtW @ r[..., None])[..., 0]
        tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1) / 5.0
        H = H + ((damping + lam) * torch.clamp(tr, min=1e-12))[:, None, None] * eye5
        delta = -torch.linalg.solve_ex(H, g[..., None])[0][..., 0]
        r_new = residuals(delta, R, t)
        ok = cost_of(r_new, w_in) < cost_of(r, w_in)
        step = torch.where(ok[:, None], delta, torch.zeros_like(delta))
        R = R @ lie.so3_exp(step[:, :3])
        t = _unit(t + (lie.tangent_basis(t) @ step[:, 3:, None])[..., 0])
        lam = torch.clamp(torch.where(ok, lam * 0.33, lam * 8.0), 1e-10, 1e4)
        r = torch.where(ok[:, None], r_new, r)
    res = RefineResult(R=R, t=t, E=essential_from_pose(R, t),
                       cost=cost_of(r, w_in), initial_cost=c0)
    if not batched:
        res = RefineResult(*(v[0] for v in res))
    return res
