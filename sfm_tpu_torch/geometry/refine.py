"""Two-view motion-only Gauss-Newton on SO(3) x S^2 (counterpart of
``sfm_tpu/geometry/refine.py``).

The JAX package builds the [N, 5] Jacobian with ``jax.jacfwd`` and
vmaps the probe starts; here the poses carry a leading batch dimension
and the five Jacobian columns come from five ``torch.func.jvp`` calls,
each pushing one unit tangent through every batch member at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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


@f32_matmul
def refine_relative_pose(R, t, x1, x2, weights=None, *, iters: int = 10,
                         huber_delta: float = 3e-3, damping: float = 1e-8):
    """Refine (R [..., 3, 3], t [..., 3]) against [N, 3] correspondences.

    ``weights`` is [..., N] (or [N]); a leading batch dimension on R, t
    and weights refines several starts independently.
    """
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
