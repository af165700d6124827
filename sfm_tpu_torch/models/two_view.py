"""Two-view Structure-from-Motion pipeline (counterpart of
``sfm_tpu/models/two_view.py``).

SIFT x2 -> fused top-2 matcher -> compaction to ``geometry_cap`` slots
-> RANSAC E -> multi-start probe refinement -> refine rounds ->
translation re-vote rounds -> cheirality vote -> triangulation.
PyTorch runs eagerly, so the JAX package's two jitted programs become
plain function calls.  Selections use ``torch.where`` and counts stay
on the device.  On the card each ``refine.refine_relative_pose`` call
(the probe, each refine and re-vote round) is one K10 launch and each
``pose.recover_pose`` call (each round's vote, the final one) one K12
launch, neither waiting on anything, but the geometry still blocks on
the host about fifteen times a bench pair: each small constant made on
the card from a Python list (``pose.pose_candidates``,
``ops/linalg.project_to_essential``) and each candidate picked by a 0-d
index tensor (the probe start, the bank's best) waits for the card
(``utils/timing``'s ``host_syncs`` counts them).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sfm_tpu_torch.config import PipelineConfig
from sfm_tpu_torch.geometry import (camera, epipolar, pose, ransac, refine,
                                    triangulate as tri)
from sfm_tpu_torch.ops.compact import compaction_order, stable_topk_indices
from sfm_tpu_torch.sift import frontend, match as match_mod
from sfm_tpu_torch.utils import timing
from sfm_tpu_torch.utils.precision import f32_matmul


class TwoViewResult(NamedTuple):
    R: torch.Tensor            # [3,3] second-camera rotation
    t: torch.Tensor            # [3] unit translation
    E: torch.Tensor            # [3,3] refined essential matrix
    points: torch.Tensor       # [N,3] triangulated points (camera-1 frame)
    point_valid: torch.Tensor  # [N] bool (inlier & cheirality & finite)
    uv1: torch.Tensor          # [N,2] pixel coords image 1
    uv2: torch.Tensor          # [N,2] pixel coords image 2
    inliers: torch.Tensor      # [N] RANSAC inlier mask
    num_inliers: torch.Tensor
    num_matches: torch.Tensor
    reproj_err: torch.Tensor   # mean squared reprojection error (normalized)


def gather_correspondences(kp1, kp2, matches):
    """Dense [N, 2] pixel correspondences from a match result; invalid
    rows are masked, not compacted."""
    uv1 = torch.stack([kp1.x, kp1.y], dim=-1)
    uv2 = torch.stack([kp2.x[matches.index], kp2.y[matches.index]], dim=-1)
    mask = matches.valid & kp1.valid & kp2.valid[matches.index]
    return uv1, uv2, mask


def _consider(cand, best):
    """Branchless best-of: the candidate replaces ``best`` only on a
    strictly higher score (first maximum wins)."""
    if best is None:
        return cand
    take = cand[0] > best[0]
    return tuple(torch.where(take, c, b) for c, b in zip(cand, best))


def _normalize_E(E):
    return E * (math.sqrt(2.0)
                / torch.linalg.vector_norm(E, dim=(-2, -1), keepdim=True))


def two_view_geometry(uv1, uv2, mask, K, cfg: PipelineConfig = PipelineConfig(),
                      *, generator=None, minimal_sets=None) -> TwoViewResult:
    """RANSAC + pose + refine + triangulate from pixel correspondences.

    ``generator`` draws the RANSAC minimal sets; ``minimal_sets``
    ([n_hyps, 8] indices) replaces the draw (parity tests).
    """
    with timing.span("two_view.geometry"):
        return _geometry(uv1, uv2, mask, K, cfg, generator, minimal_sets)


@f32_matmul
def _geometry(uv1, uv2, mask, K, cfg, generator, minimal_sets) -> TwoViewResult:
    K_inv = camera.inv_intrinsics(K)
    x1 = camera.normalize_points(uv1, K_inv)
    x2 = camera.normalize_points(uv2, K_inv)
    n = x1.shape[0]
    if n >= 46000:
        raise ValueError("score packing overflows int32 at this N")

    rc = cfg.ransac
    disparity_ok = torch.sum((uv1 - uv2) ** 2, dim=-1) > rc.min_disparity_px ** 2
    res = ransac.ransac_essential(
        x1, x2, mask & disparity_ok, generator=generator,
        minimal_sets=minimal_sets, n_hyps=rc.n_hyps, threshold=rc.threshold,
        chunk=rc.chunk, sweeps=rc.sweeps, refit_iters=rc.refit_iters,
        topk=max(cfg.restart_k, 1))

    # Tight-count score lexicographically above the full valid count.
    score_mult = n + 1

    def score_counts(r, cheir):
        valid = (r < rc.threshold) & mask & cheir
        score = valid.sum(-1)
        if cfg.score_tight_mult > 0:
            tight = ((r < rc.threshold * cfg.score_tight_mult)
                     & mask & cheir).sum(-1)
            score = tight * score_mult + score
        return valid, score

    def score_E(E, R2, t2):
        r = epipolar.epipolar_residuals(_normalize_E(E), x1, x2)
        z1, z2 = tri.midpoint_depths(x1, x2, R2, t2)
        valid_k, score = score_counts(r, (z1 > 0) & (z2 > 0))
        return (r < rc.threshold) & mask, valid_k, score

    best = None
    with timing.span("geometry.multistart"):
        # The first vote only picks a branch; a subset compacted by RANSAC
        # inlier membership decides it identically (cfg.vote_cap).
        if cfg.vote_cap and cfg.vote_cap < n:
            vsel = compaction_order(res.inliers)[: cfg.vote_cap]
            x1v, x2v = x1[vsel], x2[vsel]
            wv = res.inliers[vsel].to(x1.dtype)
        else:
            x1v, x2v = x1, x2
            wv = res.inliers.to(x1.dtype)
        if cfg.restart_k > 0:
            # Multi-start: all 4 branches of the LO-refit E plus the top-K
            # bank draws, scored with the rounds' tight-count metric.
            E_cands = _normalize_E(torch.cat([res.E[None], res.topk_E]))
            Rs, ts = pose.pose_candidates(E_cands)
            C = E_cands.shape[0]
            Rs = Rs.reshape(C * 4, 3, 3)
            ts = ts.reshape(C * 4, 3)
            rb = epipolar.epipolar_residuals(E_cands, x1, x2)
            rb = torch.repeat_interleave(rb, 4, dim=0)
            z1b, z2b = tri.midpoint_depths(x1, x2, Rs, ts)
            validb, scoreb = score_counts(rb, (z1b > 0) & (z2b > 0))
            if cfg.probe_starts <= 1:
                bsel = torch.argmax(scoreb)
                R_cur, t_cur = Rs[bsel], ts[bsel]
                w = validb[bsel]
        else:
            p = pose.recover_pose(res.E, x1v, x2v, weights=wv)
            R_cur, t_cur = p["R"], p["t"]
            w = res.inliers
    if cfg.restart_k > 0 and cfg.probe_starts > 1:
        # Probe refinement: refine the best branch of each of the top-S
        # candidates briefly and start from the post-probe argmax.
        with timing.span("geometry.probe"):
            sb4 = scoreb.reshape(C, 4)
            br = torch.argmax(sb4, dim=1)
            flat = torch.arange(C, device=x1.device) * 4 + br
            S = min(cfg.probe_starts, C)
            esel = stable_topk_indices(sb4.max(dim=1).values, S)
            psel = flat[esel]
            pref = refine.refine_relative_pose(
                Rs[psel], ts[psel], x1, x2, weights=validb[psel].to(x1.dtype),
                iters=cfg.probe_iters)
            E_p = _normalize_E(pref.E)
            rp = epipolar.epipolar_residuals(E_p, x1, x2)
            z1p, z2p = tri.midpoint_depths(x1, x2, pref.R, pref.t)
            validp, scorep = score_counts(rp, (z1p > 0) & (z2p > 0))
            pw = torch.argmax(scorep)
            R_cur, t_cur = pref.R[pw], pref.t[pw]
            w = validp[pw]
            inl_p = (rp[pw] < rc.threshold) & mask
            best = _consider((scorep[pw], E_p[pw], inl_p, R_cur, t_cur), best)

    for _ in range(max(cfg.refine_rounds, 1)):
        with timing.span("geometry.refine"):
            ref = refine.refine_relative_pose(R_cur, t_cur, x1, x2, weights=w,
                                              iters=cfg.refine_iters)
            p2 = pose.recover_pose(ref.E, x1v, x2v, weights=wv)
            inl, valid_k, score = score_E(ref.E, p2["R"], p2["t"])
            best = _consider((score, ref.E, inl, p2["R"], p2["t"]), best)
            R_cur, t_cur = p2["R"], p2["t"]
            w = valid_k

    # Translation re-vote rounds: re-vote t globally for the best round's
    # R (pose.cheirality_t_vote), enter the voted E as a candidate and
    # re-refine from the voted pose; then a vote-only half round against
    # the final best R.  _consider is monotone, so neither can lose.
    maskv = wv > 0

    def vote_candidate():
        Rb = best[3]
        vote = pose.cheirality_t_vote(Rb, x1v, x2v, maskv, rc.threshold,
                                      n_dirs=cfg.tvote_dirs)
        inl_s, valid_s, score_s = score_E(vote["E"], Rb, vote["t"])
        return (score_s, vote["E"], inl_s, Rb, vote["t"]), valid_s

    for _ in range(cfg.tvote_rounds):
        with timing.span("geometry.tvote"):
            cand, valid_s = vote_candidate()
            best = _consider(cand, best)
            ref = refine.refine_relative_pose(cand[3], cand[4], x1, x2,
                                              weights=valid_s, iters=cfg.refine_iters)
            p2 = pose.recover_pose(ref.E, x1v, x2v, weights=wv)
            inl, valid_k, score = score_E(ref.E, p2["R"], p2["t"])
            best = _consider((score, ref.E, inl, p2["R"], p2["t"]), best)
    if cfg.tvote_rounds > 0:
        with timing.span("geometry.tvote"):
            best = _consider(vote_candidate()[0], best)

    with timing.span("geometry.final"):
        _, E_fin, inl, _, _ = best
        pf = pose.recover_pose(E_fin, x1, x2, weights=inl.to(x1.dtype))
        R_fin, t_fin = pf["R"], pf["t"]
        X = pf["points"]
        pt_valid = inl & pf["front"] & pf["finite"]
        errs = tri.reprojection_errors(X, x1, x2, R_fin, t_fin)
        denom = torch.clamp(pt_valid.sum(), min=1)
        mean_err = torch.sum(torch.where(pt_valid, errs, torch.zeros_like(errs))) / denom
        return TwoViewResult(
            R=R_fin, t=t_fin, E=E_fin, points=X, point_valid=pt_valid,
            uv1=uv1, uv2=uv2, inliers=inl, num_inliers=inl.sum(),
            num_matches=mask.sum(), reproj_err=mean_err,
        )


def match_stage(s1, s2, cfg: PipelineConfig):
    """Match two SIFT results and compact the correspondences to
    ``geometry_cap`` slots (valid first; matches beyond the cap are
    dropped, never corrupted)."""
    with timing.span("two_view.match_stage"):
        m = match_mod.match(s1.descriptors, s2.descriptors, s1.keypoints.valid,
                            s2.keypoints.valid, cfg.match)
        with timing.span("match.compact"):
            uv1, uv2, mask = gather_correspondences(s1.keypoints, s2.keypoints, m)
            cap = cfg.geometry_cap
            if cap and cap < mask.shape[0]:
                order = compaction_order(mask)[:cap]
                uv1, uv2, mask = uv1[order], uv2[order], mask[order]
        return uv1, uv2, mask


def frontend_stage(img1, img2, cfg: PipelineConfig = PipelineConfig()):
    """SIFT on both images, then the match stage."""
    with timing.span("two_view.frontend"):
        s1 = frontend.extract_sift(img1, cfg.sift)
        s2 = frontend.extract_sift(img2, cfg.sift)
        return match_stage(s1, s2, cfg)


def two_view_pipeline(img1, img2, K, generator,
                      cfg: PipelineConfig = PipelineConfig()) -> TwoViewResult:
    """Full pipeline from two [H, W] f32 images (0..255) on one device.

    ``generator`` is a ``torch.Generator`` on the images' device.
    """
    uv1, uv2, mask = frontend_stage(img1, img2, cfg)
    return two_view_geometry(uv1, uv2, mask, K, cfg, generator=generator)


def run_two_view(img1, img2, K, cfg: PipelineConfig = PipelineConfig(),
                 seed: int = 0) -> TwoViewResult:
    """Convenience wrapper seeding the RANSAC generator from an int."""
    gen = torch.Generator(device=img1.device)
    gen.manual_seed(seed)
    return two_view_pipeline(img1, img2, K, gen, cfg)
