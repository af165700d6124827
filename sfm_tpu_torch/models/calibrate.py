"""Self-calibrating bundle adjustment: shared focal + radial distortion
(counterpart of ``sfm_tpu/models/calibrate.py``).

Model: pixel = c + f * x_n * (1 + k1 r^2 + k2 r^4), r^2 = |x_n|^2,
with shared (f, k1, k2) across all cameras and a fixed principal point.
Pinhole-only BA of distorted narrow-FOV turntable footage collapses into
the bas-relief ambiguity, so the intrinsics must be estimated.

Two routes, as in the JAX package:

  * ``run_ba_selfcal``: block coordinate descent, alternating the
    Schur-complement LM BA over (R, t, X) on normalized observations
    (``models/bundle_adjust.run_ba``) with a closed-form weighted linear
    fit of (f, f k1, f k2) given the structure (``fit_intrinsics``) and
    re-normalization by fixed-point undistortion;
  * ``run_ba_joint``: joint LM over poses, points and the intrinsics in
    pixel space, the point blocks Schur-eliminated and the reduced camera
    system bordered by 3 global columns: one dense [6M + 3] solve per
    LM iteration.

Jacobians are written out (the projection's by
``pnp.projection_jacobians``, chained through the distortion), equal to
the JAX package's ``jacfwd``; LM loops are Python loops whose
accept/reject is ``torch.where``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.geometry import lie
from sfm_tpu_torch.geometry.pnp import projection_jacobians, safe_project
from sfm_tpu_torch.models import bundle_adjust as ba
from sfm_tpu_torch.utils.precision import f32_matmul


class Intrinsics(NamedTuple):
    f: torch.Tensor    # [] shared focal (pixels)
    cx: torch.Tensor   # [] principal point (fixed, not estimated)
    cy: torch.Tensor
    k1: torch.Tensor   # [] radial distortion (normalized-radius poly)
    k2: torch.Tensor


def intrinsics_from_K(K, k1=0.0, k2=0.0) -> Intrinsics:
    K = torch.as_tensor(K)
    return Intrinsics(f=K[0, 0], cx=K[0, 2], cy=K[1, 2],
                      k1=torch.as_tensor(k1, dtype=K.dtype, device=K.device),
                      k2=torch.as_tensor(k2, dtype=K.dtype, device=K.device))


def distort(xn, intr: Intrinsics):
    """Normalized -> distorted normalized: x_d = x_n (1 + k1 r^2 + k2 r^4)."""
    r2 = torch.sum(xn * xn, dim=-1, keepdim=True)
    return xn * (1.0 + intr.k1 * r2 + intr.k2 * r2 * r2)


def project_pixels(xn, intr: Intrinsics):
    """Normalized coords -> pixel coords under the distortion model."""
    return distort(xn, intr) * intr.f + torch.stack([intr.cx, intr.cy])


def undistort_normalize(uv_pix, intr: Intrinsics, iters: int = 5):
    """Pixel observations -> undistorted NORMALIZED coords [.., 2], by
    ``iters`` fixed-point steps (the standard contraction for
    |k1| r^2 < 1)."""
    xd = (uv_pix - torch.stack([intr.cx, intr.cy])) / intr.f
    xn = xd
    for _ in range(iters):
        r2 = torch.sum(xn * xn, dim=-1, keepdim=True)
        denom = 1.0 + intr.k1 * r2 + intr.k2 * r2 * r2
        denom = torch.where(denom.abs() < 0.25, torch.full_like(denom, 0.25), denom)
        xn = xd / denom
    return xn


def _predicted(R, t, X, cam_idx, pt_idx):
    """(R_i, X_j, normalized projections [O, 2]) of every observation."""
    Ri = R[cam_idx]
    Xj = X[pt_idx]
    Xc = torch.einsum("oij,oj->oi", Ri, Xj) + t[cam_idx]
    return Ri, Xj, Xc


@f32_matmul
def fit_intrinsics(R, t, X, cam_idx, pt_idx, mask, uv_pix, intr: Intrinsics,
                   w=None) -> Intrinsics:
    """Closed-form weighted LS update of (f, k1, k2), fixed structure.

    pixel - c = f*x_n + (f*k1)*(x_n r^2) + (f*k2)*(x_n r^4) is LINEAR in
    theta = (f, f*k1, f*k2): one masked 3x3 normal solve over all
    observations.  Falls back to the input intrinsics if the solve is
    not finite or f leaves [0.05, 20] x its input.
    """
    xn = safe_project(_predicted(R, t, X, cam_idx, pt_idx)[2])[0]   # [O, 2]
    r2 = torch.sum(xn * xn, dim=-1, keepdim=True)
    b = uv_pix - torch.stack([intr.cx, intr.cy])                   # [O, 2]
    A = torch.stack([xn, xn * r2, xn * r2 * r2], -1)                # [O, 2, 3]
    m = mask.to(xn.dtype)[:, None, None]
    if w is not None:
        m = m * w[:, None, None]
    G = torch.einsum("oxi,oxj->ij", A * m, A)                      # [3, 3]
    rhs = torch.einsum("oxi,ox->i", A * m, b)
    eye = torch.eye(3, dtype=G.dtype, device=G.device)
    theta = torch.linalg.solve_ex(G + 1e-8 * eye, rhs[:, None])[0][:, 0]
    f_new = theta[0]
    ok = torch.isfinite(f_new) & (f_new > 0.05 * intr.f) & (f_new < 20.0 * intr.f)
    f_new = torch.where(ok, f_new, intr.f)
    return Intrinsics(f=f_new, cx=intr.cx, cy=intr.cy,
                      k1=torch.where(ok, theta[1] / f_new, intr.k1),
                      k2=torch.where(ok, theta[2] / f_new, intr.k2))


def _pixel_residuals(xn, intr: Intrinsics, uv_pix):
    r2 = torch.sum(xn * xn, dim=-1, keepdim=True)
    c = torch.stack([intr.cx, intr.cy])
    return c + intr.f * xn * (1.0 + intr.k1 * r2 + intr.k2 * r2 * r2) - uv_pix, r2


def _obs_jacobians_intr(R, t, X, cam_idx, pt_idx, mask, uv_pix, intr):
    """Per-observation PIXEL residuals + Jacobians wrt camera (6: so3
    right-multiplied, then dt), point (3) and the global intrinsics
    theta = (f, k1, k2); all zero where masked.  Returns (r [O, 2],
    Jc [O, 2, 6], Jp [O, 2, 3], Jt [O, 2, 3])."""
    Ri, Xj, Xc = _predicted(R, t, X, cam_idx, pt_idx)
    xn = safe_project(Xc)[0]
    r, r2 = _pixel_residuals(xn, intr, uv_pix)
    Jc_n, Jp_n = projection_jacobians(Ri, Xj, Xc)        # of x_n
    s = 1.0 + intr.k1 * r2 + intr.k2 * r2 * r2            # [O, 1]
    # d pixel / d x_n = f (s I + 2 (k1 + 2 k2 r^2) x_n x_n^T)
    eye = torch.eye(2, dtype=xn.dtype, device=xn.device)
    Dd = intr.f * (s[..., None] * eye
                   + 2.0 * (intr.k1 + 2.0 * intr.k2 * r2)[..., None]
                   * xn[:, :, None] * xn[:, None, :])
    Jt = torch.stack([xn * s, intr.f * xn * r2, intr.f * xn * r2 * r2], -1)
    m = mask[:, None]
    return (torch.where(m, r, torch.zeros_like(r)), (Dd @ Jc_n) * m[..., None],
            (Dd @ Jp_n) * m[..., None], Jt * m[..., None])


def _huber_cost(r, mask, huber_px):
    rn2 = torch.sum(r * r, -1)
    rn = torch.sqrt(torch.clamp(rn2, min=1e-24))
    c = torch.where(rn <= huber_px, 0.5 * rn2, huber_px * (rn - 0.5 * huber_px))
    return torch.sum(torch.where(mask, c, torch.zeros_like(c)))


@f32_matmul
def run_ba_joint(R, t, X, cam_idx, pt_idx, mask, fixed, uv_pix, intr: Intrinsics, *,
                 iters: int = 20, huber_px: float = 2.0, init_lam: float = 1e-3,
                 estimate_f: bool = True, estimate_k: bool = True):
    """JOINT LM bundle adjustment over poses, points, and shared
    intrinsics (f, k1, k2), pixel-space residuals.

    The point blocks are Schur-eliminated as in models.bundle_adjust;
    the reduced camera system gains a 3-column GLOBAL BORDER for
    theta = (f/f0, k1, k2) (f scaled by its initial value so the three
    columns are comparably conditioned), giving one dense [6M+3, 6M+3]
    solve per LM iteration.  Joint, not block-coordinate, because a
    pinhole-collapsed reconstruction of distorted data is a joint local
    minimum where alternating steps are each stationary.

    Returns ((R, t, X), Intrinsics, costs [iters+1]).
    """
    M, P = R.shape[0], X.shape[0]
    dt, dev = R.dtype, R.device
    f0 = intr.f
    free = (~fixed).to(dt)
    # theta freedom mask: columns we refuse to move.
    tfree = torch.tensor([1.0 if estimate_f else 0.0, 1.0 if estimate_k else 0.0,
                          1.0 if estimate_k else 0.0], dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    ar = torch.arange(M, device=dev)
    n = 6 * M + 3

    def intr_of(th):
        return Intrinsics(f=th[0] * f0, cx=intr.cx, cy=intr.cy, k1=th[1], k2=th[2])

    def cost_of(R, t, X, th):
        xn = safe_project(_predicted(R, t, X, cam_idx, pt_idx)[2])[0]
        r = _pixel_residuals(xn, intr_of(th), uv_pix)[0]
        return _huber_cost(torch.where(mask[:, None], r, torch.zeros_like(r)), mask,
                           huber_px)

    th = torch.stack([torch.ones((), dtype=dt, device=dev), intr.k1.to(dt),
                      intr.k2.to(dt)])
    lam = torch.full((), init_lam, dtype=dt, device=dev)
    cost = cost_of(R, t, X, th)
    costs = [cost]
    for _ in range(iters):
        r, Jc, Jp, Jt = _obs_jacobians_intr(R, t, X, cam_idx, pt_idx, mask, uv_pix,
                                            intr_of(th))
        # theta column scaling: d(resid)/d(theta0) = f0 * d/d f.
        Jt = Jt * torch.stack([f0, torch.ones_like(f0), torch.ones_like(f0)]) * tfree
        w = ba._huber_w(torch.sum(r * r, -1), huber_px) * mask
        Jc_w = Jc * w[:, None, None]
        Jp_w = Jp * w[:, None, None]
        Jt_w = Jt * w[:, None, None]
        U = ba._segment_sum(torch.einsum("oai,oaj->oij", Jc_w, Jc), cam_idx, M)
        V = ba._segment_sum(torch.einsum("oai,oaj->oij", Jp_w, Jp), pt_idx, P)
        gc = ba._segment_sum(torch.einsum("oai,oa->oi", Jc_w, r), cam_idx, M)
        gp = ba._segment_sum(torch.einsum("oai,oa->oi", Jp_w, r), pt_idx, P)
        Wg = ba._segment_sum(torch.einsum("oai,oaj->oij", Jc_w, Jp),
                             pt_idx * M + cam_idx, P * M).reshape(P, M, 6, 3)
        Bp = ba._segment_sum(torch.einsum("oai,oaj->oij", Jp_w, Jt), pt_idx, P)
        Bc = ba._segment_sum(torch.einsum("oai,oaj->oij", Jc_w, Jt), cam_idx, M)
        Ht = torch.einsum("oai,oaj->ij", Jt_w, Jt)                 # [3, 3]
        gt = torch.einsum("oai,oa->i", Jt_w, r)

        dU, dV = ba._damped(U, V, lam)
        dHt = Ht + lam * eye3 * (torch.trace(Ht) / 3.0 + 1e-6)
        Vinv = ba._inv3x3(dV)
        Bv = torch.einsum("pmix,pxy->pmiy", Wg, Vinv)             # [P, M, 6, 3]
        S_cc = -torch.einsum("pmiy,pnjy->minj", Bv, Wg)
        S_cc[ar, :, ar, :] += dU
        S_ct = Bc - torch.einsum("pmiy,pyk->mik", Bv, Bp)        # [M, 6, 3]
        S_tt = dHt - torch.einsum("pxi,pxy,pyj->ij", Bp, Vinv, Bp)
        rhs_c = gc - torch.einsum("pmiy,py->mi", Bv, gp)
        rhs_t = gt - torch.einsum("pxi,pxy,py->i", Bp, Vinv, gp)

        # Gauge / freedom masking.
        S_cc = S_cc * free[:, None, None, None] * free[None, None, :, None]
        S_cc[ar, :, ar, :] += torch.eye(6, dtype=dt, device=dev)[None] \
            * fixed.to(dt)[:, None, None]
        S_ct = S_ct * free[:, None, None] * tfree[None, None, :]
        S_tt = S_tt * tfree[:, None] * tfree[None, :] + torch.diag(1.0 - tfree)
        rhs_c = rhs_c * free[:, None]
        rhs_t = rhs_t * tfree

        S = torch.zeros((n, n), dtype=dt, device=dev)
        S[:6 * M, :6 * M] = S_cc.reshape(6 * M, 6 * M)
        S[:6 * M, 6 * M:] = S_ct.reshape(6 * M, 3)
        S[6 * M:, :6 * M] = S_ct.reshape(6 * M, 3).T
        S[6 * M:, 6 * M:] = S_tt
        rhs = torch.cat([rhs_c.reshape(-1), rhs_t])
        delta = -torch.linalg.solve_ex(S, rhs[:, None])[0][:, 0]
        dc = delta[:6 * M].reshape(M, 6) * free[:, None]
        dth = delta[6 * M:] * tfree
        # Back-substitute points: dp = -Vinv (gp + W^T dc + Bp dth).
        Wtdc = torch.einsum("pmiy,mi->py", Wg, dc)
        dp = -torch.einsum("pxy,py->px", Vinv,
                           gp + Wtdc + torch.einsum("pyk,k->py", Bp, dth))

        Rn = torch.einsum("mij,mjk->mik", R, lie.so3_exp(dc[:, :3]))
        tn, Xn, thn = t + dc[:, 3:], X + dp, th + dth
        c_new = cost_of(Rn, tn, Xn, thn)
        ok = c_new < cost
        R = torch.where(ok, Rn, R)
        t = torch.where(ok, tn, t)
        X = torch.where(ok, Xn, X)
        th = torch.where(ok, thn, th)
        cost = torch.where(ok, c_new, cost)
        lam = torch.clamp(torch.where(ok, lam * 0.33, lam * 8.0), 1e-9, 1e6)
        costs.append(cost)
    return (R, t, X), intr_of(th), torch.stack(costs)


def run_ba_selfcal(R, t, X, cam_idx, pt_idx, mask, fixed, uv_pix, K, *,
                   rounds: int = 3, ba_iters: int = 15, huber_delta: float = 3e-3,
                   estimate_k2: bool = True):
    """Alternating self-calibrating BA.

    Args mirror BAProblem but observations are PIXELS (uv_pix [O, 2]);
    K is the initial guess (f, principal point).  Returns
    (BAState, Intrinsics, costs [rounds, iters+1]).
    """
    intr = intrinsics_from_K(torch.as_tensor(K, dtype=torch.float32,
                                             device=uv_pix.device))
    costs = []
    for rnd in range(rounds):
        problem = ba.BAProblem(cam_idx=cam_idx, pt_idx=pt_idx,
                               uv=undistort_normalize(uv_pix, intr), mask=mask,
                               fixed=fixed)
        state, cost_hist = ba.run_ba(R, t, X, problem, iters=ba_iters,
                                     huber_delta=huber_delta)
        R, t, X = state.R, state.t, state.X
        costs.append(cost_hist)
        if rnd + 1 < rounds:
            intr = fit_intrinsics(R, t, X, cam_idx, pt_idx, mask, uv_pix, intr)
            if not estimate_k2:
                intr = intr._replace(k2=torch.zeros_like(intr.k2))
    return state, intr, torch.stack(costs)
