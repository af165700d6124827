"""Incremental multi-view SfM: two-view bootstrap, PnP registration,
track propagation, triangulation of new points, windowed local BA, loop
closure and global BA (counterpart of ``sfm_tpu/models/incremental.py``).

The map lives in fixed-capacity tensors on one device (points, per-image
point-id tables); the host only sequences the images.  PyTorch runs
eagerly, so the JAX package's jitted steps are plain function calls, and
the path keeps its counts and decisions on the device (``torch.where``,
no ``.item()``) so the card is fed without stalls.

Two rules of the JAX package's scatters are made explicit here:

* an update aimed at the capacity (``mode="drop"`` in JAX) is dropped:
  every such scatter writes into one padding slot that is sliced off;
* where several updates of one scatter name the same slot (the matcher
  is not mutual, so two slots of a previous frame can name one slot of
  the current frame), the last update in order wins, as XLA applies
  them on the CPU (``_set_last``; ``index_put_`` picks an arbitrary
  writer on CUDA).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.config import PipelineConfig
from sfm_tpu_torch.geometry import camera, pnp, pose as pose_mod, ransac, refine
from sfm_tpu_torch.geometry import triangulate as tri
from sfm_tpu_torch.models import bundle_adjust as ba
from sfm_tpu_torch.ops.compact import compaction_order
from sfm_tpu_torch.parallel import dist_ba, dist_match, mesh as meshmod
from sfm_tpu_torch.sift import frontend, match as match_mod
from sfm_tpu_torch.utils import timing
from sfm_tpu_torch.utils.precision import f32_matmul


class MapState(NamedTuple):
    X: torch.Tensor           # [P_cap, 3] world points
    X_valid: torch.Tensor     # [P_cap] bool
    n_points: torch.Tensor    # [] int64
    R: torch.Tensor           # [M, 3, 3] world -> camera
    t: torch.Tensor           # [M, 3]
    pose_valid: torch.Tensor  # [M] bool
    point_id: torch.Tensor    # [M, K] int64 (-1 = no 3D point)


class IncrementalResult(NamedTuple):
    state: MapState
    uv: torch.Tensor          # [M, K, 2] keypoint pixel coords
    kp_valid: torch.Tensor    # [M, K]
    ba_costs: torch.Tensor
    mean_reproj: torch.Tensor


def _empty_state(n_images, kp_capacity, pt_capacity, dtype=torch.float32,
                 device="cpu"):
    return MapState(
        X=torch.zeros((pt_capacity, 3), dtype=dtype, device=device),
        X_valid=torch.zeros((pt_capacity,), dtype=torch.bool, device=device),
        n_points=torch.zeros((), dtype=torch.int64, device=device),
        R=torch.eye(3, dtype=dtype, device=device).repeat(n_images, 1, 1),
        t=torch.zeros((n_images, 3), dtype=dtype, device=device),
        pose_valid=torch.zeros((n_images,), dtype=torch.bool, device=device),
        point_id=torch.full((n_images, kp_capacity), -1, dtype=torch.int64,
                            device=device),
    )


def _set_last(dst, idx, vals, keep):
    """``dst`` [K] with ``dst[idx[n]] = vals[n]`` for every n where
    ``keep[n]``; where several n name one slot, the last n wins."""
    K = dst.shape[0]
    pos = torch.arange(idx.shape[0], device=dst.device)
    last = torch.full((K + 1,), -1, dtype=torch.int64, device=dst.device)
    last.scatter_reduce_(0, torch.where(keep, idx, K), pos, reduce="amax")
    last = last[:K]
    return torch.where(last >= 0, vals[last.clamp(min=0)], dst)


def _set_rows(dst, slot, vals):
    """``dst`` [C, ...] with rows ``slot`` set to ``vals``; rows aimed at
    C (the capacity) are dropped.  Targets other than C must be unique."""
    pad = torch.cat([dst, dst.new_zeros((1, *dst.shape[1:]))])
    pad[slot] = vals
    return pad[:-1]


def _append_points(state: MapState, X_new, new_mask):
    """Append the masked new points; returns (state, ids [K], -1 where
    none or past the capacity)."""
    ranks = torch.cumsum(new_mask.to(torch.int64), 0) - 1
    ids = torch.where(new_mask, state.n_points + ranks, -1)
    cap = state.X.shape[0]
    slot = torch.where(new_mask & (ids < cap), ids, cap)
    X = _set_rows(state.X, slot, torch.where(new_mask[:, None], X_new,
                                             torch.zeros_like(X_new)))
    X_valid = _set_rows(state.X_valid, slot, new_mask)
    n_new = torch.clamp(state.n_points + new_mask.sum(), max=cap)
    ids = torch.where(ids < cap, ids, -1)
    return state._replace(X=X, X_valid=X_valid, n_points=n_new), ids


def _with_rows(state: MapState, **rows):
    """``state`` with row ``i`` of field f set, for f=(i, value) pairs
    (lists of pairs allowed)."""
    out = {}
    for name, pairs in rows.items():
        a = getattr(state, name).clone()
        for i, v in pairs:
            a[i] = v
        out[name] = a
    return state._replace(**out)


@f32_matmul
def _register_image(state: MapState, cur_idx: int, x_cur, prev_idx, x_prev,
                    match_idx, match_ok, cfg: PipelineConfig, *, generator=None,
                    minimal_sets=None):
    """PnP-register image ``cur_idx`` against B previous frames and
    extend the map.

    ``x_cur`` [K, 3] normalized keypoints of the current image;
    ``prev_idx`` B previous frame indices (nearest first); ``x_prev``
    [B, K, 3]; ``match_idx`` / ``match_ok`` [B, K] previous slot ->
    current slot.  PnP RANSAC over the union of 2D-3D correspondences
    of every previous frame, seeded with the nearest frame's pose; track
    ids propagate to the current image (farther frames first, so the
    nearest wins a slot); fresh tracks are triangulated against the
    nearest frame.  ``generator`` or ``minimal_sets`` ([n_hyps, 6])
    feed ``pnp.ransac_pnp``.  Returns (state, number of PnP inliers).
    """
    B, K_slots = match_idx.shape
    p0 = int(prev_idx[0])
    # Row views, not an index tensor: a host-to-device copy would wait
    # for the card.
    pid_prev = torch.stack([state.point_id[p] for p in prev_idx])  # [B, K]
    pid_safe = pid_prev.clamp(min=0)
    X_corr = state.X[pid_safe]                                   # [B, K, 3]
    x_obs = x_cur[match_idx]                                     # [B, K, 3]
    corr_mask = (pid_prev >= 0) & match_ok & state.X_valid[pid_safe]

    rc = cfg.ransac
    R_p0, t_p0 = state.R[p0], state.t[p0]
    res = pnp.ransac_pnp(
        x_obs.reshape(-1, 3), X_corr.reshape(-1, 3), corr_mask.reshape(-1),
        generator=generator, minimal_sets=minimal_sets, n_hyps=rc.n_hyps,
        threshold=rc.threshold * 4, R_init=R_p0, t_init=t_p0)
    R_new, t_new = res.R, res.t
    ok_pose = res.num_inliers >= 12

    # Track ids of existing points; farther frames write first.
    inl = res.inliers.reshape(B, K_slots)
    point_id_cur = torch.full((K_slots,), -1, dtype=torch.int64, device=x_cur.device)
    for b in range(B - 1, -1, -1):
        point_id_cur = _set_last(point_id_cur, match_idx[b], pid_prev[b],
                                 corr_mask[b] & inl[b])

    # Fresh tracks against the nearest previous frame, gated by
    # reprojection in both views and positive depth.
    fresh = match_ok[0] & (pid_prev[0] < 0)
    X_new, _, finite = tri.triangulate(x_prev[0], x_obs[0],
                                       tri.make_projection(R_p0, t_p0),
                                       tri.make_projection(R_new, t_new))
    gate = rc.threshold * 4
    good_new = (
        fresh & finite
        & (tri.depths(X_new, R_p0, t_p0) > 0) & (tri.depths(X_new, R_new, t_new) > 0)
        & (pnp.reprojection_residuals(R_p0, t_p0, x_prev[0], X_new) < gate)
        & (pnp.reprojection_residuals(R_new, t_new, x_obs[0], X_new) < gate)
        & ok_pose
    )
    state, new_ids = _append_points(state, X_new, good_new)
    point_id_prev0 = torch.where(new_ids >= 0, new_ids, state.point_id[p0])
    point_id_cur = _set_last(point_id_cur, match_idx[0], new_ids, new_ids >= 0)

    eye = torch.eye(3, dtype=R_new.dtype, device=R_new.device)
    state = _with_rows(
        state,
        R=[(cur_idx, torch.where(ok_pose, R_new, eye))],
        t=[(cur_idx, torch.where(ok_pose, t_new, torch.zeros_like(t_new)))],
        pose_valid=[(cur_idx, ok_pose)],
        point_id=[(p0, point_id_prev0), (cur_idx, point_id_cur)])
    return state, res.num_inliers


@f32_matmul
def _apply_closure(state: MapState, i: int, j: int, x_i, x_j, match_idx, match_ok,
                   gate):
    """Fold one loop-closure pair (i, j) into the map.

    Each matched slot pair, gated by reprojection against the current
    poses: one side has a 3D point -> the other inherits its id; both
    have different points -> the tracks merge (every table relabels j's
    id to i's, j's point is retired); neither -> a fresh track is
    triangulated from the two poses.  ``gate`` bounds the squared
    reprojection residuals.  Returns (state, number of merges, inherits
    and new points).
    """
    R_i, t_i = state.R[i], state.t[i]
    R_j, t_j = state.R[j], state.t[j]
    pid_i = state.point_id[i]                                    # [K]
    pid_j = state.point_id[j][match_idx]                         # [K] at matched slots
    x_j_m = x_j[match_idx]
    pid_i_s, pid_j_s = pid_i.clamp(min=0), pid_j.clamp(min=0)
    has_i = (pid_i >= 0) & state.X_valid[pid_i_s]
    has_j = (pid_j >= 0) & state.X_valid[pid_j_s]
    err_i_in_j = pnp.reprojection_residuals(R_j, t_j, x_j_m, state.X[pid_i_s])
    err_j_in_i = pnp.reprojection_residuals(R_i, t_i, x_i, state.X[pid_j_s])

    inherit_j = match_ok & has_i & ~has_j & (err_i_in_j < gate)
    inherit_i = match_ok & has_j & ~has_i & (err_j_in_i < gate)
    merge = (match_ok & has_i & has_j & (pid_i != pid_j)
             & (err_i_in_j < gate) & (err_j_in_i < gate))

    # Merges: relabel pid_j -> pid_i everywhere, retire X[pid_j].  Chains
    # resolve by self-composition: k passes cover chains of 2^k.
    cap = state.X.shape[0]
    remap = _set_last(torch.arange(cap + 1, device=pid_i.device), pid_j_s, pid_i,
                      merge)
    for _ in range(max(1, cap.bit_length())):
        remap = remap[remap]
    pid_tbl = torch.where(state.point_id >= 0,
                          remap[state.point_id.clamp(0, cap - 1)], -1)
    retired = _set_rows(torch.zeros((cap,), dtype=torch.bool, device=pid_i.device),
                        torch.where(merge, pid_j, cap), merge)
    state = state._replace(point_id=pid_tbl, X_valid=state.X_valid & ~retired)
    pid_i = state.point_id[i]

    # Inherits: record the closure observation in the bare table.
    tbl_j = _set_last(state.point_id[j], match_idx, pid_i, inherit_j)
    tbl_i = torch.where(inherit_i, remap[pid_j.clamp(0, cap - 1)], pid_i)

    # Fresh tracks from the two closure poses.
    fresh = match_ok & ~has_i & ~has_j & (pid_i < 0) & (pid_j < 0)
    X_new, _, finite = tri.triangulate(x_i, x_j_m, tri.make_projection(R_i, t_i),
                                       tri.make_projection(R_j, t_j))
    good_new = (
        fresh & finite
        & (tri.depths(X_new, R_i, t_i) > 0) & (tri.depths(X_new, R_j, t_j) > 0)
        & (pnp.reprojection_residuals(R_i, t_i, x_i, X_new) < gate)
        & (pnp.reprojection_residuals(R_j, t_j, x_j_m, X_new) < gate)
    )
    state, new_ids = _append_points(state, X_new, good_new)
    tbl_i = torch.where(new_ids >= 0, new_ids, tbl_i)
    tbl_j = _set_last(tbl_j, match_idx, new_ids, new_ids >= 0)
    state = _with_rows(state, point_id=[(i, tbl_i), (j, tbl_j)])
    n_closed = merge.sum() + inherit_i.sum() + inherit_j.sum() + (new_ids >= 0).sum()
    return state, n_closed


def build_ba_problem(state: MapState, uv_all, kp_valid, K_inv):
    """Flatten the point-id tables into a BAProblem (normalized uv)."""
    M, Ks = state.point_id.shape
    dev = state.point_id.device
    cam_idx = torch.arange(M, device=dev).repeat_interleave(Ks)
    pid = state.point_id.reshape(-1)
    x = camera.normalize_points(uv_all.reshape(-1, 2), K_inv)
    mask = ((pid >= 0) & kp_valid.reshape(-1) & state.pose_valid[cam_idx]
            & state.X_valid[pid.clamp(min=0)])
    fixed = ~state.pose_valid | (torch.arange(M, device=dev) == 0)
    return ba.BAProblem(cam_idx=cam_idx, pt_idx=pid.clamp(min=0),
                        uv=x[:, :2] / x[:, 2:3], mask=mask, fixed=fixed)


def _window_problem(problem: ba.BAProblem, X_valid, win_lo: int, win_hi: int,
                    obs_cap: int):
    """Compact a full BAProblem to what a windowed local BA can move:
    the observations of cameras in [win_lo, win_hi] first, then the
    fixed-camera observations of the points those cameras see (a cap
    overflow sheds the latter first).  Points are renumbered densely
    into [0, obs_cap) so run_ba's cost is O(window).

    Returns (problem_w, orig_pt [obs_cap] original point ids,
    slot_valid [obs_cap]).
    """
    P = X_valid.shape[0]
    dev = problem.cam_idx.device
    cam_in = (problem.cam_idx >= win_lo) & (problem.cam_idx <= win_hi)
    seen_w = _set_rows(torch.zeros((P,), dtype=torch.bool, device=dev),
                       torch.where(problem.mask & cam_in, problem.pt_idx, P),
                       torch.ones_like(cam_in))
    keep = problem.mask & (cam_in | seen_w[problem.pt_idx])
    order1 = compaction_order(keep & cam_in)
    order2 = compaction_order(keep & ~cam_in)
    n1 = (keep & cam_in).sum()
    n2 = (keep & ~cam_in).sum()
    sl = torch.arange(order1.shape[0], device=dev)
    order = torch.where(sl < n1, order1, order2[(sl - n1).clamp(min=0)])[:obs_cap]
    cam = problem.cam_idx[order]
    pt = problem.pt_idx[order]
    # Gate by slot position too: order2's tail repeats rows of order1's
    # prefix whenever obs_cap > n1 + n2.
    msk = keep[order] & (sl[:obs_cap] < n1 + n2)
    seen = _set_rows(torch.zeros((P,), dtype=torch.bool, device=dev),
                     torch.where(msk, pt, P), torch.ones_like(msk))
    new_id = torch.cumsum(seen.to(torch.int64), 0) - 1
    pt_new = torch.where(msk, new_id[pt], 0)
    orig_pt = _set_rows(torch.zeros((obs_cap,), dtype=torch.int64, device=dev),
                        torch.where(seen, new_id, obs_cap),
                        torch.arange(P, device=dev))
    slot_valid = torch.arange(obs_cap, device=dev) < seen.sum()
    return (ba.BAProblem(cam_idx=cam, pt_idx=pt_new, uv=problem.uv[order],
                         mask=msk, fixed=problem.fixed),
            orig_pt, slot_valid)


def _make_matcher(cfg: PipelineConfig, mesh=None):
    """The pairwise matcher: local, or with the right set sharded over
    the mesh's ranks (``parallel.dist_match``)."""
    if mesh is None:
        return lambda d1, d2, v1, v2: match_mod.match(d1, d2, v1, v2, cfg.match)
    return lambda d1, d2, v1, v2: dist_match.dist_match(d1, d2, v1, v2, cfg.match,
                                                        mesh=mesh)


def _resolve_device(images, feats, device, mesh=None):
    if device is not None:
        return torch.device(device)
    if mesh is not None:
        return mesh.device
    if feats is not None:
        return feats[0].descriptors.device
    if isinstance(images[0], torch.Tensor):
        return images[0].device
    return torch.device("cuda")


@f32_matmul
def run_incremental(images, K, cfg: PipelineConfig = PipelineConfig(), *,
                    seed: int = 0, pt_capacity: int | None = None,
                    ba_iters: int = 20, local_ba_iters: int = 5,
                    local_ba_window: int = 5, local_ba_obs_cap: int | None = None,
                    n_back: int = 3, closure_pairs=(), closure_gate_mult: float = 64.0,
                    mesh=None, feats=None, device=None, timer=None,
                    minimal_sets=None) -> IncrementalResult:
    """Full incremental reconstruction over a list of [H, W] images.

    Runs on ``device``: by default the mesh's, or that of ``feats`` or
    of tensor images, else ``cuda``.  With ``mesh``
    (``parallel.mesh.Mesh``) every rank runs the pipeline on the same
    images, and the two heavy stages shard their work over the ranks:
    the matcher the right descriptor set (``dist_match``), the global
    BA the points (``dist_ba``).  ``feats`` (one SiftResult per image)
    replaces the extraction.  ``local_ba_obs_cap``: observation capacity
    of the per-frame windowed local BA (None = (local_ba_window + n_back
    + 2) * keypoint capacity; 0 = no compaction).  ``closure_pairs``:
    (i, j) frame pairs matched and reconciled (``_apply_closure``)
    before the global BA.  ``timer`` (a ``utils.timing.StageTimer``)
    records synchronized stage times: extract, match, bootstrap,
    register (PnP registration), local_ba, closure, global_ba.
    ``minimal_sets`` ({0: [n_hyps, 8] bootstrap sets, i: [n_hyps, 6]
    frame i's PnP sets}) replaces those draws of the one generator
    seeded with ``seed`` (parity tests).
    """
    n_images = len(images)
    dev = _resolve_device(images, feats, device, mesh)
    matcher = _make_matcher(cfg, mesh)
    K = torch.as_tensor(K, dtype=torch.float32, device=dev)
    K_inv = camera.inv_intrinsics(K)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sets = minimal_sets or {}

    def draws(i):
        ms = sets.get(i)
        return {"generator": gen} if ms is None else {"minimal_sets": ms}

    with timing.span("extract", timer=timer):
        if feats is None:
            feats = [frontend.extract_sift(
                torch.as_tensor(im, dtype=torch.float32, device=dev), cfg.sift)
                for im in images]
    kp_cap = feats[0].keypoints.x.shape[0]
    if pt_capacity is None:
        pt_capacity = n_images * kp_cap // 4
    uv_all = torch.stack([torch.stack([f.keypoints.x, f.keypoints.y], dim=-1)
                          for f in feats])
    kp_valid = torch.stack([f.keypoints.valid for f in feats])
    x_norm = [camera.normalize_points(uv_all[i], K_inv) for i in range(n_images)]
    state = _empty_state(n_images, kp_cap, pt_capacity, device=dev)

    def match(p, i):
        with timing.span("match", timer=timer):
            m = matcher(feats[p].descriptors, feats[i].descriptors,
                        feats[p].keypoints.valid, feats[i].keypoints.valid)
        return m.index, m.valid & kp_valid[p] & kp_valid[i][m.index]

    # --- bootstrap from images (0, 1): essential, pose, triangulation ---
    idx01, mask01 = match(0, 1)
    with timing.span("bootstrap", timer=timer):
        rc = cfg.ransac
        disp2 = torch.sum((uv_all[0] - uv_all[1][idx01]) ** 2, dim=-1)
        mask01 = mask01 & (disp2 > rc.min_disparity_px ** 2)
        x1b, x2b = x_norm[0], x_norm[1][idx01]
        rr = ransac.ransac_essential(
            x1b, x2b, mask01, n_hyps=rc.n_hyps, threshold=rc.threshold,
            chunk=rc.chunk, refit_iters=rc.refit_iters, **draws(0))
        w_inl = rr.inliers.to(x1b.dtype)
        p = pose_mod.recover_pose(rr.E, x1b, x2b, weights=w_inl)
        ref = refine.refine_relative_pose(p["R"], p["t"], x1b, x2b,
                                          weights=rr.inliers, iters=cfg.refine_iters)
        # Re-vote cheirality on the refined E (as two_view does).
        p2 = pose_mod.recover_pose(ref.E, x1b, x2b, weights=w_inl)
        R1, t1 = p2["R"], p2["t"]
        eye = torch.eye(3, dtype=R1.dtype, device=dev)
        X01, _, finite01 = tri.triangulate(
            x1b, x2b, tri.make_projection(eye, torch.zeros_like(t1)),
            tri.make_projection(R1, t1))
        good01 = (rr.inliers & finite01 & (X01[:, 2] > 0)
                  & (tri.depths(X01, R1, t1) > 0))
        state, ids01 = _append_points(state, X01, good01)
        pid1 = _set_last(torch.full((kp_cap,), -1, dtype=torch.int64, device=dev),
                         idx01, ids01, ids01 >= 0)
        state = _with_rows(state, R=[(1, R1)], t=[(1, t1)],
                           pose_valid=[(0, True), (1, True)],
                           point_id=[(0, ids01), (1, pid1)])

    # --- incremental registration against n_back previous frames ---
    for i in range(2, n_images):
        backs = list(range(i - 1, max(i - 1 - n_back, -1), -1))
        midx, mok = map(list, zip(*(match(p, i) for p in backs)))
        # Pad to a fixed B, as the JAX package does for one program.
        while len(backs) < n_back:
            backs.append(backs[-1])
            midx.append(midx[-1])
            mok.append(torch.zeros_like(mok[-1]))
        with timing.span("register", timer=timer):
            state, _ = _register_image(
                state, i, x_norm[i], backs, torch.stack([x_norm[p] for p in backs]),
                torch.stack(midx), torch.stack(mok), cfg, **draws(i))
        if local_ba_iters:
            with timing.span("local_ba", timer=timer):
                state = _local_ba(state, i, uv_all, kp_valid, K_inv, local_ba_iters,
                                  local_ba_window, local_ba_obs_cap, n_back, kp_cap)

    with timing.span("local_ba", timer=timer):
        if local_ba_iters and local_ba_obs_cap != 0:
            # Points that left every window are refreshed by one
            # point-only pass (every camera pinned) before the closure
            # gates and the global BA.
            problem_p = build_ba_problem(state, uv_all, kp_valid, K_inv)
            st_p, _ = ba.run_ba(state.R, state.t, state.X,
                                problem_p._replace(fixed=torch.ones_like(problem_p.fixed)),
                                iters=3)
            state = state._replace(X=st_p.X)

    # --- loop closure, before the global BA; the gate admits the
    # drift-scale error the closure corrects ---
    closure_gate = cfg.ransac.threshold * 4 * closure_gate_mult
    for ci, cj in closure_pairs:
        idx, ok = match(ci, cj)
        with timing.span("closure", timer=timer):
            state, _ = _apply_closure(state, ci, cj, x_norm[ci], x_norm[cj], idx, ok,
                                      closure_gate)

    with timing.span("global_ba", timer=timer):
        state, costs, mean_reproj = _global_ba(state, uv_all, kp_valid, K_inv,
                                               ba_iters, mesh)
    return IncrementalResult(state=state, uv=uv_all, kp_valid=kp_valid,
                             ba_costs=costs, mean_reproj=mean_reproj)


def _local_ba(state, i, uv_all, kp_valid, K_inv, iters, window, obs_cap, n_back,
              kp_cap):
    """Windowed local BA after registering frame i: the last ``window``
    poses and the map against their observations; cameras outside the
    window (and camera 0) pinned.  Compacted to ``obs_cap`` observation
    slots (None = (window + n_back + 2) * kp_cap) where that is fewer
    than all of them; 0 = no compaction."""
    n_images = state.R.shape[0]
    dev = state.R.device
    problem = build_ba_problem(state, uv_all, kp_valid, K_inv)
    win_lo = i - window + 1
    problem = problem._replace(
        fixed=problem.fixed | (torch.arange(n_images, device=dev) < win_lo))
    cap = obs_cap or (window + n_back + 2) * kp_cap
    if obs_cap != 0 and cap < problem.mask.shape[0]:
        prob_w, orig_pt, slot_ok = _window_problem(problem, state.X_valid, win_lo,
                                                   i, cap)
        st, _ = ba.run_ba(state.R, state.t, state.X[orig_pt], prob_w, iters=iters)
        pcap = state.X.shape[0]
        X = _set_rows(state.X, torch.where(slot_ok, orig_pt, pcap), st.X)
        return state._replace(R=st.R, t=st.t, X=X)
    st, _ = ba.run_ba(state.R, state.t, state.X, problem, iters=iters)
    return state._replace(R=st.R, t=st.t, X=st.X)


def _median(x, mask):
    """The median of x[mask] (the mean of the two middle values for an
    even count, as ``jnp.nanmedian``; ``torch.nanmedian`` takes the
    lower one); NaN where mask is empty."""
    return torch.nanquantile(torch.where(mask, x, torch.full_like(x, float("nan"))),
                             0.5)


def _ba_rounds(problem, X, mesh):
    """``run(R, t, X, mask, iters) -> (R, t, X, costs)``: ``run_ba`` on
    ``problem`` with that mask; with a mesh, ``run_dist_ba`` on the
    problem's point partition.  The partition is laid out once: a later
    round only shrinks the mask, so it reuses the layout through
    ``obs_idx``, as the JAX package does."""
    if mesh is None:
        def run(R, t, X, mask, iters):
            final, costs = ba.run_ba(R, t, X, problem._replace(mask=mask), iters=iters)
            return final.R, final.t, final.X, costs
        return run
    _, layout, obs_idx = dist_ba.partition_problem(problem, X, mesh.size,
                                                   return_layout=True)

    def shard(a):
        return meshmod.put_sharded(mesh, a)

    def run(R, t, X, mask, iters):
        m = (obs_idx >= 0) & mask[obs_idx.clamp(min=0)]
        prob = ba.BAProblem(shard(layout.cam_idx), shard(layout.pt_idx),
                            shard(layout.uv), shard(m), layout.fixed)
        X_sh = shard(dist_ba.partition_points(X, mesh.size))
        R, t, X_sh, costs = dist_ba.run_dist_ba(R, t, X_sh, prob, mesh, iters=iters)
        X = dist_ba.unpartition_points(meshmod.gather_sharded(mesh, X_sh), X.shape[0])
        return R, t, X, costs
    return run


def _global_ba(state, uv_all, kp_valid, K_inv, ba_iters, mesh=None):
    """Global BA, one pruning round (25 x the median squared residual)
    with re-triangulation of the tracks it leaves under two
    observations, and a second global BA; with a mesh, both rounds are
    ``dist_ba``'s.  Returns (state, costs of both rounds, mean squared
    residual of the kept observations)."""
    problem = build_ba_problem(state, uv_all, kp_valid, K_inv)
    run = _ba_rounds(problem, state.X, mesh)
    R_f, t_f, X_f, costs = run(state.R, state.t, state.X, problem.mask, ba_iters)
    r = ba._residuals(R_f, t_f, X_f, problem)
    rn2 = torch.sum(r * r, dim=-1)
    med = _median(rn2, problem.mask)
    gate = 25.0 * torch.nan_to_num(med, nan=1e-6) + 1e-12
    keep = problem.mask & (rn2 < gate)
    # Re-triangulate tracks pruned to < 2 observations with the refined
    # poses: a bad initial triangulation, not bad matches, usually
    # failed them.
    pcap = X_f.shape[0]
    X_rt, ok_rt = tri.triangulate_tracks(R_f, t_f, problem.cam_idx, problem.pt_idx,
                                         problem.uv, problem.mask, pcap)
    rn2_rt = torch.sum(ba._residuals(R_f, t_f, X_rt, problem) ** 2, dim=-1)
    keep_rt = problem.mask & (rn2_rt < gate)
    zeros = torch.zeros((pcap,), dtype=torch.int64, device=X_f.device)
    kept_cnt = zeros.index_add(0, problem.pt_idx, keep.to(torch.int64))
    rt_cnt = zeros.index_add(0, problem.pt_idx, keep_rt.to(torch.int64))
    accept = ok_rt & (kept_cnt < 2) & (rt_cnt >= 2)
    X_f = torch.where(accept[:, None], X_rt, X_f)
    # A rescued point keeps only the observations that pass against X_rt.
    keep = torch.where(accept[problem.pt_idx], keep_rt, keep)
    problem2 = problem._replace(mask=keep)
    R_f, t_f, X_f, costs2 = run(R_f, t_f, X_f, keep, max(ba_iters // 2, 5))
    state = state._replace(R=R_f, t=t_f, X=X_f)
    r = ba._residuals(R_f, t_f, X_f, problem2)
    denom = torch.clamp(problem2.mask.sum(), min=1)
    mean_reproj = torch.sum(torch.where(problem2.mask, torch.sum(r * r, -1),
                                        torch.zeros_like(rn2))) / denom
    return state, torch.cat([costs, costs2]), mean_reproj
