"""Perspective-n-Point camera registration: DLT, RANSAC and a
Gauss-Newton polish (counterpart of ``sfm_tpu/geometry/pnp.py``).

A batched DLT over minimal 6-point sets (ridge inverse iteration for
the null vectors), vectorized hypothesis scoring by reprojection error,
an argmax winner, an optional motion prior and three annealed LO
rounds.  The JAX package differentiates the residuals with ``jacfwd``;
here the Jacobians are written out (``projection_jacobians``), one
batched expression instead of six JVPs.  Accept/reject is
``torch.where`` throughout: no value leaves the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.geometry import lie
from sfm_tpu_torch.geometry.ransac import sample_minimal_sets
from sfm_tpu_torch.ops import linalg
from sfm_tpu_torch.utils.precision import f32_matmul


class PnPResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    num_inliers: torch.Tensor


def safe_project(Xc):
    """Pinhole projection of camera-frame points ``[..., 3]`` with the
    JAX package's depth guard: returns (p [..., 2], z_safe, small)
    where |z| < 1e-8 is replaced by 1e-8."""
    z = Xc[..., 2]
    small = z.abs() < 1e-8
    zs = torch.where(small, torch.full_like(z, 1e-8), z)
    return Xc[..., :2] / zs[..., None], zs, small


def projection_jacobians(R, X, Xc):
    """Jacobians of p(R exp(w) (X + dX) + t + dt) at w = dt = dX = 0,
    for camera-frame points Xc = R X + t.

    Returns (Jc [..., 2, 6] over (w, dt), Jp [..., 2, 3] over dX); the
    depth guard's constant has zero derivative, as in the JAX package.
    """
    p, zs, small = safe_project(Xc)
    inv = 1.0 / zs
    dz = torch.where(small, torch.zeros_like(inv), inv)
    zero = torch.zeros_like(inv)
    Jproj = torch.stack([torch.stack([inv, zero, -p[..., 0] * dz], dim=-1),
                         torch.stack([zero, inv, -p[..., 1] * dz], dim=-1)],
                        dim=-2)                                   # [..., 2, 3]
    # d(R exp(w) X)/dw_k = R (e_k x X) = -R [X]_x e_k
    dXc_dw = -(R @ linalg.cross_matrix(X))
    Jc = torch.cat([Jproj @ dXc_dw, Jproj], dim=-1)
    return Jc, Jproj @ R


def _dlt_rows(x, X):
    """[..., N, 2, 12] DLT rows for x ~ P [X; 1]:
    [X 1 0 0 -u(X 1); 0 0 X 1 -v(X 1)] with (u, v) = x[..., :2] / x[..., 2]."""
    u = x[..., 0] / x[..., 2]
    v = x[..., 1] / x[..., 2]
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    z = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, z, -u[..., None] * Xh], dim=-1)
    r2 = torch.cat([z, Xh, -v[..., None] * Xh], dim=-1)
    return torch.stack([r1, r2], dim=-2)


@f32_matmul
def pnp_dlt(x, X, weights=None):
    """Direct linear PnP from ``[..., N, 3]`` observations and points
    (N >= 6; conditioned coordinates, as ``ransac_pnp`` passes them).
    Returns (R [..., 3, 3], t [..., 3])."""
    A = _dlt_rows(x, X)
    A = A.reshape(*A.shape[:-3], -1, 12)                         # [..., 2N, 12]
    if weights is not None:
        w2 = torch.repeat_interleave(weights, 2, dim=-1)
        G = torch.einsum("...ni,...n,...nj->...ij", A, w2, A)
    else:
        G = torch.einsum("...ni,...nj->...ij", A, A)
    p = linalg.smallest_eigvec_power(G, iters=8)
    P = p.reshape(*p.shape[:-1], 3, 4)
    sgn = torch.sign(linalg.det3(P[..., :, :3]))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    P = P * sgn[..., None, None]
    M = P[..., :, :3]
    _, s, _ = linalg.svd3x3(M)
    scale = torch.clamp(s.mean(dim=-1), min=1e-12)
    R = linalg.so3_project(M / scale[..., None, None])
    return R, P[..., :, 3] / scale[..., None]


def reprojection_residuals(R, t, x, X):
    """[..., N] squared reprojection errors in the normalized plane;
    1e6 behind the camera.  R, t may carry a batch over x, X [N, 3]."""
    Xc = torch.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
    z = Xc[..., 2]
    pred, _, _ = safe_project(Xc)
    d = torch.sum((pred - x[..., :2] / x[..., 2:3]) ** 2, dim=-1)
    return torch.where(z > 0, d, torch.full_like(d, 1e6))


@f32_matmul
def refine_pose(R, t, x, X, weights=None, *, iters: int = 8,
                huber_delta: float = 3e-3):
    """``iters`` damped Gauss-Newton steps on SE(3) minimizing the
    Huber-robust reprojection error of [N, 3] observations x of points X."""
    n = x.shape[0]
    dt, dev = x.dtype, x.device
    w_in = (torch.ones((n,), dtype=dt, device=dev) if weights is None
            else weights.to(dt))
    obs = x[..., :2] / x[..., 2:3]
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def residuals(Rn, tn):
        p, _, _ = safe_project(X @ Rn.T + tn)
        return p - obs                                            # [N, 2]

    def cost_of(r):
        rn2 = torch.sum(r * r, dim=-1)
        rn = torch.sqrt(torch.clamp(rn2, min=1e-24))
        c = torch.where(rn <= huber_delta, 0.5 * rn2,
                        huber_delta * (rn - 0.5 * huber_delta))
        return torch.sum(c * w_in)

    lam = torch.full((), 1e-4, dtype=dt, device=dev)
    for _ in range(iters):
        Xc = X @ R.T + t
        r = residuals(R, t)
        J, _ = projection_jacobians(R, X, Xc)                     # [N, 2, 6]
        J = J.reshape(-1, 6)
        rn = torch.sqrt(torch.clamp(torch.sum(r * r, dim=-1), min=1e-24))
        hw = torch.where(rn <= huber_delta, torch.ones_like(rn), huber_delta / rn)
        w = torch.repeat_interleave(w_in * hw, 2)
        JtW = J.T * w
        H = JtW @ J
        g = JtW @ r.reshape(-1)
        H = H + lam * eye6 * torch.clamp(torch.trace(H) / 6.0, min=1e-10)
        delta = -torch.linalg.solve_ex(H, g[:, None])[0][:, 0]
        r_new = residuals(R @ lie.so3_exp(delta[:3]), t + delta[3:])
        ok = cost_of(r_new) < cost_of(r)
        step = torch.where(ok, delta, torch.zeros_like(delta))
        R = R @ lie.so3_exp(step[:3])
        t = t + step[3:]
        lam = torch.clamp(torch.where(ok, lam * 0.33, lam * 8.0), 1e-10, 1e4)
    return R, t


@f32_matmul
def ransac_pnp(x, X, mask=None, *, generator=None, minimal_sets=None,
               n_hyps: int = 512, threshold: float = 4e-6, refine_iters: int = 8,
               R_init=None, t_init=None) -> PnPResult:
    """Robust PnP from [N, 3] normalized observations and [N, 3] world
    points.

    Exactly one of ``generator`` (a ``torch.Generator`` on the data's
    device) and ``minimal_sets`` ([n_hyps, 6] indices, e.g. the JAX
    package's draws in the parity tests) must be given.  ``R_init`` /
    ``t_init`` enter a prior pose (the previous frame's in incremental
    SfM) compared at a 16x wider gate.
    """
    if (generator is None) == (minimal_sets is None):
        raise ValueError("ransac_pnp needs exactly one of generator and "
                         "minimal_sets")
    n = x.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=x.device)

    # Condition: center and scale the 3D points (x is already O(1)).
    w = mask.to(x.dtype)
    wsum = torch.clamp(w.sum(), min=1.0)
    c3 = torch.sum(X * w[:, None], dim=0) / wsum
    scale3 = torch.sum(torch.linalg.vector_norm(X - c3, dim=-1) * w) / wsum
    scale3 = torch.clamp(scale3, min=1e-3)
    Xn = (X - c3) / scale3

    if minimal_sets is None:
        idx = sample_minimal_sets(generator, mask, n_hyps, k=6)
    else:
        idx = minimal_sets.to(device=x.device, dtype=torch.int64)
    R_bank, t_bank = pnp_dlt(x[idx], Xn[idx])

    def strict(R, t, gate=threshold):
        return torch.sum((reprojection_residuals(R, t, x, Xn) < gate) & mask, dim=-1)

    counts = strict(R_bank, t_bank)
    best = torch.argmax(counts)
    R0, t0 = R_bank[best], t_bank[best]

    if R_init is not None:
        # The prior wins the LO start where it has more support at a
        # wide gate than the best minimal-sample hypothesis.
        t_cond = (R_init @ c3 + t_init) / scale3
        take = strict(R_init, t_cond, threshold * 16) > strict(R0, t0, threshold * 16)
        R0 = torch.where(take, R_init, R0)
        t0 = torch.where(take, t_cond, t0)

    # LO rounds on annealed gates: GN-polish the incumbent and
    # DLT-refit from scratch on its wide-gate support, keep whichever
    # (or the incumbent) has the most strict inliers.
    R_best, t_best, c_best = R0, t0, strict(R0, t0)
    for gate_mult in (16.0, 4.0, 4.0):
        r_cur = reprojection_residuals(R_best, t_best, x, Xn)
        wl = ((r_cur < threshold * gate_mult) & mask).to(x.dtype)
        R1, t1 = refine_pose(R_best, t_best, x, Xn, wl, iters=refine_iters)
        R2, t2 = pnp_dlt(x, Xn, weights=wl)
        R2, t2 = refine_pose(R2, t2, x, Xn, wl, iters=refine_iters)
        c1, c2 = strict(R1, t1), strict(R2, t2)
        take2 = c2 >= c1
        R1 = torch.where(take2, R2, R1)
        t1 = torch.where(take2, t2, t1)
        c1 = torch.maximum(c1, c2)
        better = c1 > c_best
        R_best = torch.where(better, R1, R_best)
        t_best = torch.where(better, t1, t_best)
        c_best = torch.where(better, c1, c_best)

    inl = (reprojection_residuals(R_best, t_best, x, Xn) < threshold) & mask
    # De-condition: R (X - c3) / s + t projects as R X + (s t - R c3).
    t_world = scale3 * t_best - R_best @ c3
    return PnPResult(R=R_best, t=t_world, inliers=inl,
                     num_inliers=inl.sum().to(torch.int32))
