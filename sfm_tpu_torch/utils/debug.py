"""Intermediate-value dump and pretty printers: the parity surface
(counterpart of ``sfm_tpu/utils/debug.py``).

The reference's debug build printed U/X, the per-hypothesis A and E
candidates, inlier counts, the 4 candidate poses, the chosen P and the
triangulated points; ``two_view_dump`` collects the same surface as a
dict of named numpy arrays, computed by the same building blocks the
two-view pipeline runs.  A ``torch.Generator`` is stateful, so the
RANSAC minimal sets are drawn once and handed to every stage that
needs them: the bank, the RANSAC result and the full pipeline see the
same draws.

Usage:
    from sfm_tpu_torch.utils import debug
    d = debug.two_view_dump(img1, img2, K, generator, cfg)
    debug.print_dump(d)          # reference-style formatted print
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from sfm_tpu_torch.config import PipelineConfig
from sfm_tpu_torch.geometry import camera, epipolar, pose, ransac, triangulate as tri
from sfm_tpu_torch.models import two_view
from sfm_tpu_torch.sift import frontend


def two_view_dump(img1, img2, K, generator, cfg: PipelineConfig = PipelineConfig(),
                  *, max_hyps: int = 16, max_pts: int = 16) -> dict:
    """Run the two-view pipeline and collect every debug-print surface.

    Heads (the first ``max_hyps`` / ``max_pts`` entries) of the large
    arrays are returned under ``*_head`` keys for printing; the full
    arrays stay under their own names.
    """
    s1 = frontend.extract_sift(img1, cfg.sift)
    s2 = frontend.extract_sift(img2, cfg.sift)
    uv1, uv2, mask = two_view.match_stage(s1, s2, cfg)

    K = torch.as_tensor(K, dtype=torch.float32, device=img1.device)
    K_inv = camera.inv_intrinsics(K)
    # U = 3xN homogeneous pixels, X = K^-1 U.
    U1 = camera.to_homogeneous(uv1)
    x1 = camera.normalize_points(uv1, K_inv)
    x2 = camera.normalize_points(uv2, K_inv)

    rc = cfg.ransac
    disparity_ok = torch.sum((uv1 - uv2) ** 2, dim=-1) > rc.min_disparity_px ** 2
    est_mask = mask & disparity_ok
    sets = ransac.sample_minimal_sets(generator, est_mask, rc.n_hyps)
    E_bank, min_idx, T1, T2 = ransac.build_hypothesis_bank(
        x1, x2, est_mask, n_hyps=rc.n_hyps, sweeps=rc.sweeps, minimal_sets=sets)
    A = epipolar.eight_point_matrix((x1 @ T1.T)[min_idx], (x2 @ T2.T)[min_idx])
    res = ransac.ransac_essential(
        x1, x2, est_mask, minimal_sets=sets, n_hyps=rc.n_hyps,
        threshold=rc.threshold, chunk=rc.chunk, sweeps=rc.sweeps,
        refit_iters=rc.refit_iters)
    # The 4 candidate poses and their cheirality votes.
    Rs, ts = pose.pose_candidates(res.E)
    p = pose.recover_pose(res.E, x1, x2, weights=res.inliers.to(x1.dtype))
    full = two_view.two_view_geometry(uv1, uv2, mask, K, cfg, minimal_sets=sets)

    d = {
        "num_kp1": s1.keypoints.valid.sum(),
        "num_kp2": s2.keypoints.valid.sum(),
        "num_matches": full.num_matches,
        "U1": U1, "U2": camera.to_homogeneous(uv2), "X1": x1, "X2": x2,
        "corr_mask": mask,
        "A": A, "minimal_idx": min_idx,
        "hartley_T1": T1, "hartley_T2": T2,
        "E_bank": E_bank,
        "inlier_counts": res.counts,
        "best_index": res.best_index,
        "E_best": res.E,
        "R_candidates": Rs, "t_candidates": ts,
        "cheirality_votes": p["votes"],
        "chosen_candidate": p["index"],
        "P_chosen": tri.make_projection(full.R, full.t),
        "R": full.R, "t": full.t,
        "points": full.points, "point_valid": full.point_valid,
        "num_inliers": full.num_inliers,
        "reproj_err": full.reproj_err,
    }
    d["E_bank_head"] = E_bank[:max_hyps]
    d["inlier_counts_head"] = res.counts[:max_hyps]
    d["A0"] = A[0]
    d["U1_head"] = U1[:max_pts]
    d["X1_head"] = x1[:max_pts]
    d["points_head"] = full.points[:max_pts]
    return {k: v.detach().cpu().numpy() for k, v in d.items()}


def print_matrix(name: str, a, file=None):
    """Reference printMatrix-style output."""
    a = np.asarray(a)
    file = file or sys.stdout
    print(f"{name} [{'x'.join(map(str, a.shape))}]:", file=file)
    with np.printoptions(precision=6, suppress=True, linewidth=120,
                         threshold=64, edgeitems=4):
        print(a, file=file)


def print_dump(d: dict, file=None):
    """Formatted dump in the reference's debug-print order."""
    file = file or sys.stdout
    for k in ("num_kp1", "num_kp2", "num_matches", "best_index",
              "chosen_candidate", "num_inliers", "reproj_err"):
        print(f"{k} = {d[k]}", file=file)
    for k in ("U1_head", "X1_head", "hartley_T1", "A0", "E_bank_head",
              "inlier_counts_head", "E_best", "R_candidates", "t_candidates",
              "cheirality_votes", "P_chosen", "points_head"):
        print_matrix(k, d[k], file=file)
