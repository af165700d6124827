"""Turntable-constrained reconstruction: circular-motion SfM
(counterpart of ``sfm_tpu/models/turntable.py``).

On turntable data seen through a narrow field of view the unconstrained
chain collapses along the bas-relief ridge (NOTES_R2.md).  Two
model-free facts pin the truth instead: the sequence closes a full loop
and its angular spacing is uniform, so frame i sits at phase
i * 2 pi / n.  This module fits the remaining turntable parameters
(axis direction, axis position), a shared camera (f, k1) and the point
cloud to the image observations, then polishes by free bundle
adjustment.

The pose chain is generated from the model; points are
variable-projected out by one batched multiview DLT
(``triangulate_tracks``); the Gauss-Newton step on the 8-vector of
parameters takes its Jacobian by forward-mode autodiff
(``torch.func.jacfwd``, 8 JVPs over all observations at once).  The LM
loops are Python loops whose accept/reject is ``torch.where``: no value
leaves the device inside them.  Every entry point runs with TF32 off
(``f32_matmul``): reduced-precision matmuls cost the JAX package's
turntable drive 9.92 +- 2.22 degrees per step where the true answer is
10.00 +- 0.11 (NOTES_R5.md).

``reconstruct_ring`` is the whole request: SIFT on every frame, the
incremental chain, then ``reconstruct_turntable``.  Its spans:
``turntable.run`` (outermost) > ``extract``, the chain's stages, then
``tracks``, ``pinned_lm`` (> ``pinned_lm.triangulate``,
``pinned_lm.jacobian``, ``pinned_lm.solve``), ``free_ba`` and ``snap``
(> ``free_ba.prune``, the host's reads of the residuals, and
``run_ba``'s own).  ``LM_ITERS`` counts the LM iterations run, pinned
and free.
"""

from __future__ import annotations

import math
import os
import sys
from typing import NamedTuple

import numpy as np
import torch

from sfm_tpu_torch.geometry import lie
from sfm_tpu_torch.geometry import triangulate as tri
from sfm_tpu_torch.models import bundle_adjust as ba
from sfm_tpu_torch.models import incremental
from sfm_tpu_torch.models import tracks as tracks_mod
from sfm_tpu_torch.sift import frontend
from sfm_tpu_torch.utils import timing
from sfm_tpu_torch.utils.precision import f32_matmul, f32_precision

# LM iterations run in this process: "pinned" (refine_turntable's steps)
# and "free" (run_ba's in the annealed free BA).  Each is a fixed count
# per call, read on the host without a sync.
LM_ITERS = {"pinned": 0, "free": 0}


class TurntableModel(NamedTuple):
    axis: torch.Tensor    # [3] unit rotation axis (world frame)
    center: torch.Tensor  # [3] a point on the axis
    R0: torch.Tensor      # [3, 3] base camera world->cam rotation (gauge)
    C0: torch.Tensor      # [3] base camera center (gauge)
    sign: torch.Tensor    # [] +1/-1 phase direction


def _rodrigues(axis, ang):
    """Rotations about ``axis`` by the angles ``ang`` (a tensor [...] ->
    [..., 3, 3])."""
    return lie.so3_exp(axis / torch.linalg.vector_norm(axis) * ang[..., None])


def _ref_basis(axis):
    """(b1, b2): the basis of the plane normal to ``axis`` that the JAX
    package seeds with x, or y where the axis is near x."""
    e0 = torch.tensor([1.0, 0.0, 0.0], dtype=axis.dtype, device=axis.device)
    e1 = torch.tensor([0.0, 1.0, 0.0], dtype=axis.dtype, device=axis.device)
    ref = torch.where(axis[0].abs() < 0.9, e0, e1)
    b1 = torch.linalg.cross(axis, ref)
    b1 = b1 / torch.linalg.vector_norm(b1)
    return b1, torch.linalg.cross(axis, b1)


@f32_matmul
def turntable_poses(model: TurntableModel, phases):
    """Generate [n] camera poses from the model at the given phases.

    R_i = R0 Rot_axis(sign*phi_i)^T, C_i = c + Rot(sign*phi_i)(C0 - c).
    """
    Rots = _rodrigues(model.axis, model.sign * phases)          # [n, 3, 3]
    R = torch.einsum("ij,njk->nik", model.R0, Rots.transpose(-1, -2))
    C = model.center + torch.einsum("nij,j->ni", Rots, model.C0 - model.center)
    t = -torch.einsum("nij,nj->ni", R, C)
    return R, t


def _lstsq3(A, b):
    """Least-squares solution of the [n, 3] system A x = b by its normal
    equations in float64 (cast back to A's dtype): CUDA's
    ``torch.linalg.lstsq`` has only the QR driver, and a 3 x 3 system in
    float64 holds the JAX package's SVD solve to its f32 rounding."""
    A64, b64 = A.double(), b.double()
    x = torch.linalg.solve_ex(A64.T @ A64, (A64.T @ b64)[:, None])[0][:, 0]
    return x.to(A.dtype)


@f32_matmul
def fit_turntable(R, t, *, close_loop: bool = True,
                  n_ring: int | None = None) -> TurntableModel:
    """Fit the turntable model to a chain reconstruction.

    Axis = mean relative-rotation axis; axis position = circle fit of
    the camera centers in the plane normal to it.  With ``close_loop``,
    the circle radius is rescaled chord-preservingly so the fitted mean
    step maps onto 2 pi / n.  Camera 0 is kept exactly (gauge).
    """
    n = R.shape[0]
    C = -torch.einsum("mij,mi->mj", R, t)
    dR = torch.einsum("mji,mjk->mik", R[:-1], R[1:])    # R_{i-1}^T R_i
    rv = lie.so3_log(dR)                                 # [n-1, 3]
    angs = torch.linalg.vector_norm(rv, dim=1)
    axes = rv / torch.clamp(angs[:, None], min=1e-12)
    axis = torch.sum(axes, dim=0)
    axis = axis / torch.clamp(torch.linalg.vector_norm(axis), min=1e-12)
    th_old = torch.mean(angs)

    # Circle fit in the plane normal to the axis.
    cm = torch.mean(C, dim=0)
    d = (C - cm) @ axis
    Pp = C - d[:, None] * axis[None, :]
    b1, b2 = _ref_basis(axis)
    Q = (Pp - torch.mean(Pp, dim=0)) @ torch.stack([b1, b2]).T      # [n, 2]
    A2 = torch.cat([2 * Q, torch.ones((n, 1), dtype=Q.dtype, device=Q.device)], 1)
    sol = _lstsq3(A2, torch.sum(Q * Q, dim=1))
    cc = sol[:2]
    rad = torch.sqrt(torch.clamp(sol[2] + cc @ cc, min=1e-18))
    center = torch.mean(Pp, dim=0) + cc[0] * b1 + cc[1] * b2 + torch.mean(d) * axis

    th_new = 2.0 * math.pi / (n_ring if n_ring is not None else n)
    if close_loop:
        rad_new = rad * torch.sin(th_old / 2.0) / torch.sin(torch.full_like(th_old,
                                                                         th_new / 2.0))
    else:
        rad_new = rad
    C0 = C[0]
    u = center - C0
    u = u - (u @ axis) * axis
    center = C0 + u * (rad_new / torch.clamp(torch.linalg.vector_norm(u), min=1e-12))

    # Phase direction: which sign of one step moves C0 toward C1.
    p_pos = center + _rodrigues(axis, th_old) @ (C0 - center)
    p_neg = center + _rodrigues(axis, -th_old) @ (C0 - center)
    one = torch.ones((), dtype=R.dtype, device=R.device)
    sign = torch.where(torch.sum((p_pos - C[1]) ** 2) <= torch.sum((p_neg - C[1]) ** 2),
                       one, -one)
    return TurntableModel(axis=axis, center=center, R0=R[0], C0=C[0], sign=sign)


def _params_to_model(p, base: TurntableModel):
    """5-vector -> model: axis rotated by 2 tangent angles, center + dc."""
    # so3_exp of a [1, 3] batch: no 0-dim intermediate, whose forward-mode
    # tangent torch promotes to float64 when it meets a Python scalar.
    dR = lie.so3_exp(torch.cat([p[:2], torch.zeros((1,), dtype=p.dtype,
                                                   device=p.device)])[None])[0]
    # Rotate the axis by a small rotation expressed in a frame where the
    # current axis is the z-axis.
    b1, b2 = _ref_basis(base.axis)
    B = torch.stack([b1, b2, base.axis], dim=1)       # world <- axis-frame
    axis = B @ dR[:, 2]
    return base._replace(axis=axis, center=base.center + p[2:5])


@f32_matmul
def undistort_pixels(uv_pix, c, f, k1, k2, *, fp_iters: int = 5):
    """Observed pixels -> normalized coords under (f, c, k1, k2).

    Fixed-point inversion of xd = xn * (1 + k1 r^2 + k2 r^4); exact in
    the k=0 limit, <1e-3 px residual at dino-class distortion.
    """
    xd = (uv_pix - c) / f
    xn = xd
    for _ in range(fp_iters):
        r2 = torch.sum(xn * xn, dim=-1, keepdim=True)
        den = 1.0 + k1 * r2 + k2 * r2 * r2
        den = torch.where(den.abs() < 0.25, torch.full_like(den, 0.25), den)
        xn = xd / den
    return xn


def _intrinsics(p, f0):
    """(f, k1, k2) of the parameter vector, each of shape [1]: f0 *
    exp(p[5]), p[6], p[7] (1-element slices, not 0-dim tensors, for the
    forward-mode Jacobian: see ``_params_to_model``)."""
    return f0 * torch.exp(p[5:6]), p[6:7], p[7:8]


def _pixel_residuals(p, X, base, phases, cam_idx, pt_idx, uv_pix, f0, c):
    """[O, 2] pixel residuals of the observations under the model
    ``_params_to_model(p[:5], base)`` at ``phases`` and the camera
    ``_intrinsics(p, f0)`` with principal point ``c``."""
    R, t = turntable_poses(_params_to_model(p[:5], base), phases)
    f, k1, k2 = _intrinsics(p, f0)
    Xc = torch.einsum("oij,oj->oi", R[cam_idx], X[pt_idx]) + t[cam_idx]
    z = Xc[..., 2:3]
    z = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    xn = Xc[..., :2] / z
    r2 = torch.sum(xn * xn, dim=-1, keepdim=True)
    xd = xn * (1.0 + k1 * r2 + k2 * r2 * r2)
    return xd * f + c - uv_pix


@f32_matmul
def refine_turntable(model: TurntableModel, cam_idx, pt_idx, uv_pix, mask, K, *,
                     n_frames: int, n_points: int, iters: int = 15,
                     tri_rounds: int = 4, huber_px: float = 2.0,
                     prune_px: float = 8.0, estimate_intrinsics: bool = True,
                     estimate_k2: bool = False):
    """Alternating Levenberg-Marquardt on the turntable + intrinsics
    parameters with variable-projected structure.

    Pixel-space residuals under a shared (f, k1, k2) camera; parameter
    vector p[8]: axis tangent (2), axis-point shift (3), log focal scale,
    k1, k2 (k2 frozen unless ``estimate_k2``: it trades off against f
    and k1 on narrow-FOV data and runs away).  Per outer round: (1)
    undistort + triangulate all tracks under the current model, (2)
    staged prune on pixel residuals, (3) ``iters`` accept/reject LM
    steps on p with X fixed.  Phases are pinned at i * 2 pi / n.
    Returns (model, (f, k1, k2), R [n], t [n], X [P], obs_mask, rms_px),
    all tensors on ``uv_pix``'s device.
    """
    dt, dev = uv_pix.dtype, uv_pix.device
    K = torch.as_tensor(K, dtype=dt, device=dev)
    f0 = 0.5 * (K[0, 0] + K[1, 1])
    c = torch.stack([K[0, 2], K[1, 2]])
    phases = (2.0 * math.pi / n_frames) * torch.arange(n_frames, dtype=dt, device=dev)
    n_par = 8
    free = torch.ones((n_par,), dtype=dt, device=dev)
    if not estimate_intrinsics:
        free[5:] = 0.0
    if not estimate_k2:
        free[7] = 0.0
    zeros5 = torch.zeros((5,), dtype=dt, device=dev)

    def intr_of(p):
        return _intrinsics(p, f0)

    def residuals(p, X, base):
        return _pixel_residuals(p, X, base, phases, cam_idx, pt_idx, uv_pix, f0, c)

    jac = torch.func.jacfwd(residuals)                 # [O, 2, 8]

    def undistort(p):
        f, k1, k2 = intr_of(p)
        return undistort_pixels(uv_pix, c, f, k1, k2)

    def robust_cost(p, X, base, keep):
        r = residuals(p, X, base)
        rn = torch.sqrt(torch.clamp(torch.sum(r * r, dim=1), min=1e-24))
        cst = torch.where(rn <= huber_px, 0.5 * rn * rn, huber_px * (rn - 0.5 * huber_px))
        return torch.sum(torch.where(keep, cst, torch.zeros_like(cst)))

    base, intr_p, keep = model, torch.zeros((n_par,), dtype=dt, device=dev), mask
    for round_i in range(tri_rounds):
        with timing.span("pinned_lm.triangulate"):
            R, t = turntable_poses(base, phases)
            X, ok = tri.triangulate_tracks(R, t, cam_idx, pt_idx, undistort(intr_p), keep,
                                           n_points)
            rn = torch.linalg.vector_norm(residuals(intr_p, X, base), dim=1)
            # Staged prune: generous on the first round (the chain-fitted
            # init has tens-of-px residuals on real data), tight after.
            thr = 6.0 * prune_px if round_i == 0 else prune_px
            keep = mask & ok[pt_idx] & (rn < thr)

        # Pose deltas restart at 0, intrinsics carry over.
        p = torch.cat([zeros5, intr_p[5:]])
        lam = torch.full((), 1e-3, dtype=dt, device=dev)
        cost = robust_cost(p, X, base, keep)
        for _ in range(iters):
            LM_ITERS["pinned"] += 1
            with timing.span("pinned_lm.jacobian"):
                r = residuals(p, X, base)
                J = jac(p, X, base) * free
            with timing.span("pinned_lm.solve"):
                rn2 = torch.sum(r * r, dim=1)
                w = torch.where(rn2 <= huber_px * huber_px, torch.ones_like(rn2),
                                huber_px / torch.sqrt(torch.clamp(rn2, min=1e-24))) * keep
                Jw = J * w[:, None, None]
                G = torch.einsum("oki,okj->ij", Jw, J) + torch.diag(1.0 - free)
                g = torch.einsum("oki,ok->i", Jw, r)
                D = torch.diag(torch.clamp(torch.diagonal(G), min=1e-12))
                dp = -torch.linalg.solve_ex(G + lam * D, g[:, None])[0][:, 0] * free
                dp = torch.where(torch.isfinite(dp), dp, torch.zeros_like(dp))
                c_new = robust_cost(p + dp, X, base, keep)
                good = c_new < cost
                p = torch.where(good, p + dp, p)
                cost = torch.where(good, c_new, cost)
                lam = torch.clamp(torch.where(good, lam * 0.3, lam * 6.0), 1e-8, 1e8)
        base, intr_p = _params_to_model(p[:5], base), torch.cat([zeros5, p[5:]])

    with timing.span("pinned_lm.triangulate"):
        R, t = turntable_poses(base, phases)
        X, ok = tri.triangulate_tracks(R, t, cam_idx, pt_idx, undistort(intr_p), keep,
                                       n_points)
        rn = torch.linalg.vector_norm(residuals(intr_p, X, base), dim=1)
        keep = keep & ok[pt_idx] & (rn < prune_px)
    rms = torch.sqrt(torch.sum(torch.where(keep, rn * rn, torch.zeros_like(rn)))
                     / torch.clamp(torch.sum(keep), min=1))
    return base, tuple(v[0] for v in intr_of(intr_p)), R, t, X, keep, rms


class TurntableResult(NamedTuple):
    model: TurntableModel   # fitted parametric circular-motion model
    f: float                # recovered shared focal length (px)
    k1: float               # recovered radial distortion
    k2: float
    R: torch.Tensor         # [n, 3, 3] final (BA-polished) poses
    t: torch.Tensor         # [n, 3]
    X: torch.Tensor         # [P, 3] triangulated tracks
    keep: torch.Tensor      # [O] surviving observations
    tracks: tracks_mod.TrackSet
    rms_px: float
    step_deg: torch.Tensor  # [n-1] relative rotation per ring step
    total_deg: float        # total swept rotation incl. the wrap step
    # The ring pairs' matches as build_tracks read them: (i, j) ->
    # (index [K], valid [K]), numpy.
    matches: dict
    ba_obs: np.ndarray      # [O] the last run_ba's observations
    chain: object = None    # reconstruct_ring's IncrementalResult


def _steps_deg_np(R):
    R = np.asarray(torch.as_tensor(R).cpu())
    out = []
    for i in range(1, len(R)):
        tr = np.clip((np.trace(R[i] @ R[i - 1].T) - 1) / 2, -1, 1)
        out.append(math.degrees(math.acos(tr)))
    return np.array(out)


# (Huber px, prune px) per stage of the annealed free BA: from the
# pinned LM's basin, then after the snap to the fitted ring.
FREE_BA_SCHEDULE = [(8.0, 64.0), (2.0, 12.0)]
SNAP_SCHEDULE = [(4.0, 24.0), (2.0, 8.0)]


def _resid_px(R, t, X, cam_idx, pt_idx, uv_n, f_px):
    """Pixel reprojection error norms [O] of every observation, on the
    host (numpy)."""
    Xc = torch.einsum("oij,oj->oi", R[cam_idx], X[pt_idx]) + t[cam_idx]
    z = Xc[:, 2:3]
    z = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    return np.linalg.norm(((Xc[:, :2] / z - uv_n) * f_px).cpu().numpy(), axis=1)


def _stage_problem(R, t, cam_idx, pt_idx, uv_n, mask_np, keep, n_tracks, f_px,
                   prune_px):
    """One free-BA stage's start: the tracks triangulated from the ``keep``
    observations, then every masked observation of a triangulated track
    within ``prune_px`` of its projection.  Returns (X, BAProblem with no
    camera fixed, okm: masked observations of triangulated tracks)."""
    dev = uv_n.device
    X, ok = tri.triangulate_tracks(R, t, cam_idx, pt_idx, uv_n,
                                   torch.as_tensor(keep, device=dev), n_tracks)
    r = _resid_px(R, t, X, cam_idx, pt_idx, uv_n, f_px)
    okm = mask_np & ok.cpu().numpy()[pt_idx.cpu().numpy()]
    fixed = torch.zeros((R.shape[0],), dtype=torch.bool, device=dev)
    m = torch.as_tensor(okm & (r < prune_px), device=dev)
    return X, ba.BAProblem(cam_idx, pt_idx, uv_n, m, fixed), okm


def _anneal_free_ba(R, t, cam_idx, pt_idx, uv_n, mask, n_tracks, f_px,
                    schedule, iters):
    """Annealed unconstrained LM-BA over the trackset: per stage,
    re-triangulate, prune at the stage threshold, run_ba at the stage
    Huber width.  No camera is held fixed: the gauge null space is held
    by the LM damping, and pinning a camera whose init is off the true
    ring leaves a permanent seam at that camera.  The prune reads the
    residuals on the host once per stage (numpy ``keep`` and ``r``, as
    in the JAX package).  ``run_ba`` runs in float64: the gauge's seven
    directions are held by the damping alone, and in float32 their part
    of each step and the accept test near the optimum are rounding
    noise, so on some rings the LM stalled 1e-4 to 4e-4 above the float64
    optimum of its own problem, the poses 0.1-0.3 degrees off (PERF.md
    §6); the stages between run in the poses' float32.  Returns
    (R, t, X, keep, r, the last stage's observation mask)."""
    mask_np = mask.cpu().numpy()
    keep = mask_np
    X = r = problem = None
    for hub, pru in schedule:
        with timing.span("free_ba.prune"):
            X, problem, okm = _stage_problem(R, t, cam_idx, pt_idx, uv_n, mask_np, keep,
                                             n_tracks, f_px, pru)
        LM_ITERS["free"] += iters
        st, _costs = ba.run_ba(R.double(), t.double(), X.double(),
                               problem._replace(uv=problem.uv.double()), iters=iters,
                               huber_delta=hub / f_px)
        R, t, X = (v.to(uv_n.dtype) for v in (st.R, st.t, st.X))
        with timing.span("free_ba.prune"):
            r = _resid_px(R, t, X, cam_idx, pt_idx, uv_n, f_px)
            keep = okm & (r < pru)
    return R, t, X, keep, r, problem.mask.cpu().numpy()


def free_ba_problem(dump, device="cuda"):
    """The first free-BA stage of a run dumped by ``SFM_TPU_TT_DUMP`` (the
    JAX package's keys: R, t, cam_idx, pt_idx, uv_nd, mask, n_tracks,
    f0), rebuilt on ``device`` as ``reconstruct_turntable`` hands it to
    ``run_ba``: returns (R, t, X, BAProblem, huber_delta)."""
    d = np.load(dump)
    dev = torch.device(device)
    R, t, uv = (torch.as_tensor(d[k], device=dev) for k in ("R", "t", "uv_nd"))
    cam_idx, pt_idx = (torch.as_tensor(d[k].astype(np.int64), device=dev)
                       for k in ("cam_idx", "pt_idx"))
    f0 = float(d["f0"])
    hub, pru = FREE_BA_SCHEDULE[0]
    with f32_precision():
        X, problem, _ = _stage_problem(R, t, cam_idx, pt_idx, uv, d["mask"], d["mask"],
                                       int(d["n_tracks"]), f0, pru)
    return R, t, X, problem, hub / f0


def _dbg(tag, R, r_px=None, keep=None):
    """SFM_TPU_TT_DEBUG=1: per-stage step spread to stderr (the
    device/CPU divergence forensics hook)."""
    if not os.environ.get("SFM_TPU_TT_DEBUG"):
        return
    st = _steps_deg_np(R)
    msg = f"[tt] {tag}: step {st.mean():.3f} +- {st.std():.3f} deg"
    if r_px is not None and keep is not None and keep.any():
        rms = float(np.sqrt((np.asarray(r_px)[keep] ** 2).mean()))
        msg += f", rms {rms:.3f} px ({int(keep.sum())} obs)"
    print(msg, file=sys.stderr, flush=True)


@f32_matmul
def reconstruct_turntable(feats, R_chain, t_chain, K, cfg, *,
                          axis_hint=(0.0, 1.0, 0.0), gaps=(1, 2), wrap: bool = True,
                          estimate_intrinsics: bool = True, min_track_len: int = 2,
                          pose_valid=None, ba_iters: int = 20, snap_rounds: int = 1,
                          timer=None) -> TurntableResult:
    """Turntable pipeline (host driver) on the features' device.

    The chain reconstruction is used ONLY for its gauge (camera-0 pose)
    and for the bootstrap pair's triangulated scene depth (the scale
    gauge).  Everything else is model-free:

      1. ring tracks from descriptor matches incl. the wrap loop-closure
         edges (tracks.build_tracks);
      2. uniform-phase init: phases pinned at i*2pi/n, axis init =
         ``axis_hint`` in CAMERA-0 frame, center = camera-0 look-at
         point at the bootstrap depth;
      3. annealed variable-projected LM on (axis, center) over BOTH
         phase directions, keeping the better (refine_turntable);
      4. a final LM round with shared (f, k1) estimation;
      5. annealed UNCONSTRAINED bundle adjustment from the turntable
         basin;
      6. ``snap_rounds`` x (fit_turntable -> snap to uniform ring ->
         free BA).

    ``timer`` (a ``utils.timing.StageTimer``) records synchronized stage
    times: tracks, pinned_lm, free_ba, snap.  SFM_TPU_TT_DEBUG=1 logs
    each stage's step spread; SFM_TPU_TT_DUMP=<path.npz> saves the
    free-BA stage's problem under the JAX package's keys.
    """
    n = len(feats)
    dev = feats[0].descriptors.device
    K = np.asarray(torch.as_tensor(K).cpu(), np.float32)
    f0 = 0.5 * float(K[0, 0] + K[1, 1])
    c_xy = np.array([K[0, 2], K[1, 2]], np.float32)
    R_chain = np.asarray(torch.as_tensor(R_chain).cpu())
    t_chain = np.asarray(torch.as_tensor(t_chain).cpu())
    if pose_valid is not None:
        pv = np.asarray(torch.as_tensor(pose_valid).cpu())
        if not (pv[0] and pv[1]):
            raise ValueError("turntable init needs the bootstrap pair (frames 0, 1) "
                             "registered in the chain")

    with timing.span("tracks", timer=timer):
        pairs = tracks_mod.ring_pairs(n, gaps=gaps, wrap=wrap)
        ring_matches = {}
        ts = tracks_mod.build_tracks(feats, pairs, cfg, min_len=min_track_len,
                                     matches=ring_matches)
    with timing.span("pinned_lm", timer=timer):
        cam_idx_np = ts.cam_idx.cpu().numpy()
        pt_idx_np = ts.pt_idx.cpu().numpy()
        uv_n0 = torch.as_tensor((ts.uv_pix.cpu().numpy() - c_xy) / f0, device=dev)

        # --- scene depth from the bootstrap pair (scale gauge only) ---
        in0 = np.isin(pt_idx_np, pt_idx_np[cam_idx_np == 0])
        in1 = np.isin(pt_idx_np, pt_idx_np[cam_idx_np == 1])
        sel01 = in0 & in1 & ((cam_idx_np == 0) | (cam_idx_np == 1))
        keep01 = ts.mask.cpu().numpy() & sel01
        # Only frames 0 and 1 are kept; the others index the two poses
        # clamped, as XLA's gather clamps them.
        X01, ok01 = tri.triangulate_tracks(
            torch.as_tensor(R_chain[:2], device=dev), torch.as_tensor(t_chain[:2], device=dev),
            ts.cam_idx.clamp(max=1), ts.pt_idx, uv_n0, torch.as_tensor(keep01, device=dev),
            ts.n_tracks)
        pts01 = np.unique(pt_idx_np[keep01])
        pts01 = pts01[ok01.cpu().numpy()[pts01]]
        if len(pts01) < 8:
            raise ValueError(f"only {len(pts01)} bootstrap-pair tracks triangulated — "
                             "cannot establish the turntable scale gauge")
        Xc0 = X01.cpu().numpy()[pts01] @ R_chain[0].T + t_chain[0]
        d_scene = float(np.median(Xc0[:, 2]))

        C0 = -R_chain[0].T @ t_chain[0]
        viewdir = R_chain[0].T @ np.array([0.0, 0.0, 1.0])

        def init_model(sign):
            axis = R_chain[0].T @ np.asarray(axis_hint, np.float64)
            axis = axis / np.linalg.norm(axis)
            u = d_scene * viewdir
            u_perp = u - (u @ axis) * axis
            return TurntableModel(
                axis=torch.as_tensor(axis.astype(np.float32), device=dev),
                center=torch.as_tensor((C0 + u_perp).astype(np.float32), device=dev),
                R0=torch.as_tensor(R_chain[0], device=dev),
                C0=torch.as_tensor(C0.astype(np.float32), device=dev),
                sign=torch.tensor(float(sign), dtype=torch.float32, device=dev))

        # --- annealed pinned LM, both phase directions ---
        anneal = [(64.0, 4000.0), (16.0, 64.0), (4.0, 16.0)]
        best = None
        for sign in (1.0, -1.0):
            model = init_model(sign)
            for hub, pru in anneal:
                model, intr, R, t, X, keep, rms = refine_turntable(
                    model, ts.cam_idx, ts.pt_idx, ts.uv_pix, ts.mask, K,
                    n_frames=n, n_points=ts.n_tracks, iters=12, tri_rounds=2,
                    huber_px=hub, prune_px=pru, estimate_intrinsics=False)
            score = int(keep.sum())
            if best is None or score > best[0]:
                best = (score, model)
        model = best[1]

        # --- final pinned LM with shared-intrinsics estimation ---
        model, intr, R, t, X, keep, rms = refine_turntable(
            model, ts.cam_idx, ts.pt_idx, ts.uv_pix, ts.mask, K,
            n_frames=n, n_points=ts.n_tracks, iters=15, tri_rounds=3,
            huber_px=2.0, prune_px=8.0, estimate_intrinsics=estimate_intrinsics)
        f_est, k1, k2 = (float(v) for v in intr)
    _dbg("pinned LM", R)

    with timing.span("free_ba", timer=timer):
        # --- annealed free BA from the turntable basin ---
        if estimate_intrinsics:
            uv_nd = undistort_pixels(ts.uv_pix, torch.as_tensor(c_xy, device=dev),
                                     f_est, k1, k2)
        else:
            uv_nd = uv_n0
        dump = os.environ.get("SFM_TPU_TT_DUMP")
        if dump:
            np.savez(dump, R=R.cpu().numpy(), t=t.cpu().numpy(),
                     cam_idx=cam_idx_np.astype(np.int32),
                     pt_idx=pt_idx_np.astype(np.int32), uv_nd=uv_nd.cpu().numpy(),
                     mask=ts.mask.cpu().numpy(), n_tracks=ts.n_tracks, f0=f0)
        R, t, X, keep, r_px, ba_obs = _anneal_free_ba(
            R, t, ts.cam_idx, ts.pt_idx, uv_nd, ts.mask, ts.n_tracks, f0,
            FREE_BA_SCHEDULE, ba_iters)
    _dbg("free BA", R, r_px, keep)
    with timing.span("snap", timer=timer):
        # --- snap to the fitted uniform ring and re-polish ---
        phases = (2.0 * math.pi / n) * torch.arange(n, dtype=torch.float32, device=dev)
        for _ in range(snap_rounds):
            R_s, t_s = turntable_poses(fit_turntable(R, t, n_ring=n), phases)
            R, t, X, keep, r_px, ba_obs = _anneal_free_ba(
                R_s, t_s, ts.cam_idx, ts.pt_idx, uv_nd, ts.mask, ts.n_tracks,
                f0, SNAP_SCHEDULE, ba_iters)
            _dbg("snap+BA", R, r_px, keep)
        model = fit_turntable(R, t, n_ring=n)

    steps = _steps_deg_np(R)
    Rn = R.cpu().numpy()
    tr_w = np.clip((np.trace(Rn[0] @ Rn[-1].T) - 1) / 2, -1, 1)
    total = float(steps.sum() + math.degrees(math.acos(tr_w)))
    rms_px = float(np.sqrt((r_px[keep] ** 2).mean())) if keep.any() else 0.0
    return TurntableResult(
        model=model, f=f_est, k1=k1, k2=k2, R=R, t=t, X=X,
        keep=torch.as_tensor(keep, device=dev), tracks=ts, rms_px=rms_px,
        step_deg=torch.as_tensor(steps.astype(np.float32)), total_deg=total,
        matches=ring_matches, ba_obs=ba_obs)


@f32_matmul
def reconstruct_ring(images, K, cfg, *, feats=None, seed: int = 0,
                     chain_ba_iters: int = 30, local_ba_iters: int = 5, minimal_sets=None,
                     device=None, timer=None, **ring) -> TurntableResult:
    """The turntable ring from its frames: SIFT on every frame (unless
    ``feats``, one SiftResult per frame, is given), the incremental
    chain (``run_incremental`` with ``seed``, ``chain_ba_iters`` global
    and ``local_ba_iters`` local BA iterations, and ``minimal_sets``, its
    RANSAC draws or callables that draw them), then ``reconstruct_turntable`` (``ring``: its
    keywords) from the chain's poses.  Returns the TurntableResult with
    ``chain`` the chain's IncrementalResult.

    The whole is the span ``turntable.run``; ``timer`` (a
    ``utils.timing.StageTimer``) records the synchronized stages:
    extract, the chain's (match, bootstrap, register, local_ba,
    global_ba) and the turntable's (tracks, pinned_lm, free_ba, snap).
    """
    with timing.span("turntable.run"):
        dev = incremental._resolve_device(images, feats, device, None)
        with timing.span("extract", timer=timer):
            if feats is None:
                feats = [frontend.extract_sift(
                    torch.as_tensor(im, dtype=torch.float32, device=dev), cfg.sift)
                    for im in images]
        chain = incremental.run_incremental(
            images, K, cfg, seed=seed, ba_iters=chain_ba_iters,
            local_ba_iters=local_ba_iters, feats=feats, device=dev, timer=timer,
            minimal_sets=minimal_sets)
        st = chain.state
        res = reconstruct_turntable(feats, st.R, st.t, K, cfg, pose_valid=st.pose_valid,
                                    timer=timer, **ring)
    return res._replace(chain=chain)
