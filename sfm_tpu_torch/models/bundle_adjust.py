"""Sparse Levenberg-Marquardt bundle adjustment with a Schur complement
(counterpart of ``sfm_tpu/models/bundle_adjust.py``).

Static shapes with masks, as in the JAX package: LM iterations are a
plain Python loop whose accept/reject is ``torch.where`` (no value
leaves the device inside it), per-observation 2x6 / 2x3 Jacobian blocks
(written out: ``pnp.projection_jacobians``), block Hessian assembly by
segment sums (``index_add_``), closed-form batched 3x3 inverses, and
two solvers of the reduced camera system: a dense [6M, 6M] LU
(``schur_solve``) and a matrix-free preconditioned CG
(``schur_solve_cg``).

``index_add_`` on a CUDA tensor accumulates with float atomics, so the
segment sums, and with them an LM accept test ``c_new < cost`` near a
tie, may differ between runs on the card; on the CPU they are
deterministic.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.geometry import lie
from sfm_tpu_torch.geometry.pnp import projection_jacobians, safe_project
from sfm_tpu_torch.utils.precision import f32_matmul


class BAProblem(NamedTuple):
    """Static-shape BA problem; uv are NORMALIZED image coordinates
    (K^-1 applied), so the camera model is pure (R, t)."""

    cam_idx: torch.Tensor   # [O] int64
    pt_idx: torch.Tensor    # [O] int64
    uv: torch.Tensor        # [O, 2] normalized observations
    mask: torch.Tensor      # [O] bool (padding / outlier mask)
    fixed: torch.Tensor     # [M] bool: cameras kept out of the update (gauge)


class BAState(NamedTuple):
    R: torch.Tensor         # [M, 3, 3]
    t: torch.Tensor         # [M, 3]
    X: torch.Tensor         # [P, 3]
    lam: torch.Tensor       # LM damping
    cost: torch.Tensor      # current robust cost


def _camera_points(R, t, X, problem: BAProblem):
    Ri = R[problem.cam_idx]
    Xj = X[problem.pt_idx]
    return Ri, Xj, torch.einsum("oij,oj->oi", Ri, Xj) + t[problem.cam_idx]


def _residuals(R, t, X, problem: BAProblem):
    """[O, 2] reprojection residuals (normalized plane), 0 where masked."""
    _, _, Xc = _camera_points(R, t, X, problem)
    r = safe_project(Xc)[0] - problem.uv
    return torch.where(problem.mask[:, None], r, torch.zeros_like(r))


def _huber_w(rnorm2, delta):
    """IRLS weights of the Huber loss on the residual norm."""
    rn = torch.sqrt(torch.clamp(rnorm2, min=1e-24))
    return torch.where(rn <= delta, torch.ones_like(rn), delta / rn)


def robust_cost(R, t, X, problem: BAProblem, delta):
    r = _residuals(R, t, X, problem)
    rn2 = torch.sum(r * r, dim=-1)
    rn = torch.sqrt(torch.clamp(rn2, min=1e-24))
    c = torch.where(rn <= delta, 0.5 * rn2, delta * (rn - 0.5 * delta))
    return torch.sum(torch.where(problem.mask, c, torch.zeros_like(c)))


def _obs_jacobians(R, t, X, problem: BAProblem):
    """Per-observation residuals and Jacobians over (camera 6-dof: so3
    right-multiplied, then dt; point 3-dof).  Returns (r [O, 2],
    Jc [O, 2, 6], Jp [O, 2, 3]), zero where masked."""
    Ri, Xj, Xc = _camera_points(R, t, X, problem)
    r = safe_project(Xc)[0] - problem.uv
    Jc, Jp = projection_jacobians(Ri, Xj, Xc)
    m = problem.mask
    return (torch.where(m[:, None], r, torch.zeros_like(r)),
            Jc * m[:, None, None], Jp * m[:, None, None])


def _inv3x3(A):
    """Closed-form batched 3x3 inverse by the adjugate."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(det.abs() < 1e-20, torch.full_like(det, 1e-20), det)
    adj = torch.stack([torch.stack([A11, A12, A13], -1),
                       torch.stack([A21, A22, A23], -1),
                       torch.stack([A31, A32, A33], -1)], -2)
    return adj / det[..., None, None]


def _segment_sum(vals, idx, n):
    """[O, ...] -> [n, ...] sums over rows sharing an index."""
    return torch.zeros((n, *vals.shape[1:]), dtype=vals.dtype,
                       device=vals.device).index_add_(0, idx, vals)


def weighted_system(R, t, X, problem: BAProblem, huber_delta, n_cams, n_pts):
    """Robust-weighted GN system pieces shared by both solvers.

    Returns (U [M,6,6], V [P,3,3], gc [M,6], gp [P,3], Jc_w [O,2,6]
    (Huber-weighted camera Jacobians), Jc, Jp, r, w).
    """
    r, Jc, Jp = _obs_jacobians(R, t, X, problem)
    w = _huber_w(torch.sum(r * r, dim=-1), huber_delta) * problem.mask
    Jc_w = Jc * w[:, None, None]
    Jp_w = Jp * w[:, None, None]
    cam, pt = problem.cam_idx, problem.pt_idx
    U = _segment_sum(torch.einsum("oai,oaj->oij", Jc_w, Jc), cam, n_cams)
    V = _segment_sum(torch.einsum("oai,oaj->oij", Jp_w, Jp), pt, n_pts)
    gc = _segment_sum(torch.einsum("oai,oa->oi", Jc_w, r), cam, n_cams)
    gp = _segment_sum(torch.einsum("oai,oa->oi", Jp_w, r), pt, n_pts)
    return U, V, gc, gp, Jc_w, Jc, Jp, r, w


def normal_equation_blocks(R, t, X, problem: BAProblem, huber_delta, n_cams, n_pts):
    """Masked robust GN blocks for the dense path.

    Returns (U [M,6,6], V [P,3,3], Wg [P,M,6,3] cross blocks grouped per
    (point, camera), gc [M,6], gp [P,3]).
    """
    U, V, gc, gp, Jc_w, _, Jp, _, _ = weighted_system(
        R, t, X, problem, huber_delta, n_cams, n_pts)
    W_obs = torch.einsum("oai,oaj->oij", Jc_w, Jp)              # [O, 6, 3]
    Wg = _segment_sum(W_obs, problem.pt_idx * n_cams + problem.cam_idx,
                      n_pts * n_cams).reshape(n_pts, n_cams, 6, 3)
    return U, V, Wg, gc, gp


def _damped(U, V, lam):
    """LM damping: multiplicative on the diagonals plus a small floor."""
    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
    trU = torch.diagonal(U, dim1=-2, dim2=-1).sum(-1)
    trV = torch.diagonal(V, dim1=-2, dim2=-1).sum(-1)
    dU = U + (lam * eye6)[None] * (trU[:, None, None] / 6.0 + 1e-6)
    dV = V + (lam * eye3)[None] * (trV[:, None, None] / 3.0 + 1e-6)
    return dU, dV


def _nonzero(x):
    return torch.where(x.abs() < 1e-30, torch.full_like(x, 1e-30), x)


def schur_solve_cg(U, V, Jc_w, Jp, r, w, problem: BAProblem, gc, gp, lam, fixed,
                   *, cg_iters: int = 32, all_reduce=None):
    """Matrix-free damped Schur solve by block-Jacobi preconditioned CG.

    Never forms S or the grouped cross blocks: each S-product is two
    observation-space einsums and two segment sums, O(O) per CG step.
    Fixed cameras get identity rows (their delta is 0).  Returns
    (delta_cam [M,6], delta_pt [P,3]).

    ``all_reduce`` (the JAX package's ``psum_axis``; e.g.
    ``parallel.mesh.Mesh.all_reduce``): sums a tensor over the ranks of
    a point-partitioned problem (cameras replicated, every point with
    all of its observations on one rank: ``parallel.dist_ba``).  U and
    gc arrive summed; the camera segment sum of each W-product is
    summed here, one [M, 6] reduction per matvec.
    """
    M = U.shape[0]
    dt = U.dtype
    reduce = _identity if all_reduce is None else all_reduce
    dU, dV = _damped(U, V, lam)
    Vinv = _inv3x3(dV)
    free = (~fixed).to(dt)[:, None]
    cam, pt = problem.cam_idx, problem.pt_idx
    n_pts = V.shape[0]

    def WT_v(v):  # [M,6] -> [P,3]   (W^T v, W_o = Jc_w^T Jp)
        a = torch.einsum("oai,oi->oa", Jc_w, v[cam])
        return _segment_sum(torch.einsum("oaj,oa->oj", Jp, a), pt, n_pts)

    def W_z(z):  # [P,3] -> [M,6]
        c = torch.einsum("oaj,oj->oa", Jp, z[pt])
        return reduce(_segment_sum(torch.einsum("oai,oa->oi", Jc_w, c), cam, M))

    def S_mul(v):
        v = v * free
        z = torch.einsum("pxy,py->px", Vinv, WT_v(v))
        out = torch.einsum("mij,mj->mi", dU, v) - W_z(z)
        return out * free + v * (1.0 - free)

    rhs = (gc - W_z(torch.einsum("pxy,py->px", Vinv, gp))) * free
    Uinv = torch.linalg.inv_ex(dU + torch.eye(6, dtype=dt, device=dU.device) * 1e-8)[0]

    def precond(v):
        return torch.einsum("mij,mj->mi", Uinv, v) * free

    x = torch.zeros_like(rhs)
    res = rhs
    z = precond(res)
    p = z
    rz = torch.sum(res * z)
    for _ in range(cg_iters):
        Sp = S_mul(p)
        alpha = rz / _nonzero(torch.sum(p * Sp))
        x = x + alpha * p
        res = res - alpha * Sp
        z = precond(res)
        rz_n = torch.sum(res * z)
        p = z + (rz_n / _nonzero(rz)) * p
        rz = rz_n
    delta_c = -x * free
    delta_p = -torch.einsum("pxy,py->px", Vinv, gp + WT_v(delta_c))
    return delta_c, delta_p


def schur_solve(U, V, Wg, gc, gp, lam, fixed, *, all_reduce=None):
    """Damped dense Schur-complement solve (one [6M, 6M] LU).
    Returns (delta_cam [M,6], delta_pt [P,3]).  ``all_reduce``: as in
    :func:`schur_solve_cg`; here the [M,6,M,6] and [M,6] cross terms
    are summed over the ranks, and the LU is replicated."""
    reduce = _identity if all_reduce is None else all_reduce
    M = U.shape[0]
    dt, dev = U.dtype, U.device
    dU, dV = _damped(U, V, lam)
    Vinv = _inv3x3(dV)                                           # [P,3,3]
    Bv = torch.einsum("pmix,pxy->pmiy", Wg, Vinv)                # [P,M,6,3]
    S = -reduce(torch.einsum("pmiy,pnjy->minj", Bv, Wg))         # [M,6,M,6]
    ar = torch.arange(M, device=dev)
    # S[m, :, m, :] is camera m's diagonal block (split advanced indices
    # put the camera axis first: a [M, 6, 6] view of the blocks).
    S[ar, :, ar, :] += dU
    rhs = gc - reduce(torch.einsum("pmiy,py->mi", Bv, gp))
    # Gauge: zero the rows / columns of fixed cameras, identity blocks.
    free = (~fixed).to(dt)
    S = S * free[:, None, None, None] * free[None, None, :, None]
    S[ar, :, ar, :] += torch.eye(6, dtype=dt, device=dev)[None] * fixed.to(dt)[:, None, None]
    rhs = rhs * free[:, None]
    delta_c = -torch.linalg.solve_ex(S.reshape(6 * M, 6 * M),
                                     rhs.reshape(-1, 1))[0].reshape(M, 6)
    delta_c = delta_c * free[:, None]
    Wtdc = torch.einsum("pmiy,mi->py", Wg, delta_c)
    delta_p = -torch.einsum("pxy,py->px", Vinv, gp + Wtdc)
    return delta_c, delta_p


def _identity(x):
    return x


def _apply(R, t, X, delta_c, delta_p):
    Rn = torch.einsum("mij,mjk->mik", R, lie.so3_exp(delta_c[:, :3]))
    return Rn, t + delta_c[:, 3:], X + delta_p


def resolve_solver(solver: str, n_cams: int, n_pts: int) -> str:
    """The Schur solver ``run_ba`` uses for ``solver`` ("auto", "dense"
    or "cg").

    "auto" is the dense LU up to 8M camera x point products and CG
    beyond, on the CPU (as in the JAX package) and on CUDA alike: the
    grouped cross blocks Wg [P, M, 6, 3] grow with M * P (576 MB at the
    gate).  The JAX package keeps the dense LU off its accelerator,
    whose LU stalled 13% above the CPU's cost on a free-gauge BA (no
    camera fixed: the 7-dimensional gauge held by the damping alone).
    On an H100 (700 W) the dense LU ended 20 LM iterations at CG's cost,
    within 4.3e-5 of a float64 CPU solve, on the 12-frame sequence's
    global BA (12 cameras, 15,360 point slots, 30,546 observations)
    with camera 0 fixed and with none fixed, and within 2.3e-7 on a
    36-camera ring with none fixed, at 3.9-7.6 ms per iteration against
    CG's 19.3-39.1 (three runs; PERF.md §6, chip_smoke.py's solver A/B,
    tests/test_torch_cuda.py's free-gauge tests); and on the turntable
    path's own free-BA stage, where the JAX package's accelerator LU
    stalled (36 cameras, 6,634 tracks, none fixed, 30 iterations), it
    ended +4.7e-5 from float64 against CG's +5.2e-5, at 4.4 ms per
    iteration against 25.6.
    """
    if solver != "auto":
        if solver not in ("dense", "cg"):
            raise ValueError(f"run_ba: unknown solver {solver!r}")
        return solver
    return "dense" if n_cams * n_pts <= 8_000_000 else "cg"


@f32_matmul
def run_ba(R, t, X, problem: BAProblem, *, iters: int = 20,
           huber_delta: float = 3e-3, init_lam: float = 1e-3,
           solver: str = "auto", cg_iters: int = 32, all_reduce=None):
    """LM bundle adjustment; returns (final BAState, costs [iters + 1]:
    the initial cost, then the cost after each iteration).

    ``solver``: "dense" (the exact [6M, 6M] Schur solve; materializes
    Wg [P, M, 6, 3]), "cg" (matrix-free preconditioned CG on the Schur
    complement, O(O) memory) or "auto" (``resolve_solver``).

    ``all_reduce``: the rank's part of a point-partitioned problem
    (``parallel.dist_ba.run_dist_ba``): X and the observations are the
    rank's, R and t replicated; the cost and the camera blocks are
    summed over the ranks, so every rank takes the same LM decisions.
    """
    n_cams, n_pts = R.shape[0], X.shape[0]
    solver = resolve_solver(solver, n_cams, n_pts)
    reduce = _identity if all_reduce is None else all_reduce
    cost = reduce(robust_cost(R, t, X, problem, huber_delta))
    lam = torch.full((), init_lam, dtype=R.dtype, device=R.device)
    costs = [cost]
    for _ in range(iters):
        if solver == "dense":
            U, V, Wg, gc, gp = normal_equation_blocks(
                R, t, X, problem, huber_delta, n_cams, n_pts)
            dc, dp = schur_solve(reduce(U), V, Wg, reduce(gc), gp, lam, problem.fixed,
                                 all_reduce=all_reduce)
        else:
            U, V, gc, gp, Jc_w, _, Jp, r, w = weighted_system(
                R, t, X, problem, huber_delta, n_cams, n_pts)
            dc, dp = schur_solve_cg(reduce(U), V, Jc_w, Jp, r, w, problem, reduce(gc),
                                    gp, lam, problem.fixed, cg_iters=cg_iters,
                                    all_reduce=all_reduce)
        Rn, tn, Xn = _apply(R, t, X, dc, dp)
        c_new = reduce(robust_cost(Rn, tn, Xn, problem, huber_delta))
        ok = c_new < cost
        R = torch.where(ok, Rn, R)
        t = torch.where(ok, tn, t)
        X = torch.where(ok, Xn, X)
        cost = torch.where(ok, c_new, cost)
        lam = torch.clamp(torch.where(ok, lam * 0.33, lam * 8.0), 1e-9, 1e6)
        costs.append(cost)
    return BAState(R, t, X, lam, cost), torch.stack(costs)
