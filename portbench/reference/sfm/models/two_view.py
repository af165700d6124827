"""The two-view pipeline's correspondence stage (frozen copy of
``sfm_tpu_torch/models/two_view.py``'s ``frontend_stage``): SIFT x2 ->
fused top-2 matcher -> compaction to ``geometry_cap`` slots.  The
geometry that follows is judged by ``portbench/reference/geometry.py``,
written apart from the port.
"""

from __future__ import annotations

import torch

from portbench.reference.sfm.config import PipelineConfig
from portbench.reference.sfm.ops.compact import compaction_order
from portbench.reference.sfm.sift import frontend, match as match_mod


def gather_correspondences(kp1, kp2, matches):
    """Dense [N, 2] pixel correspondences from a match result; invalid
    rows are masked, not compacted."""
    uv1 = torch.stack([kp1.x, kp1.y], dim=-1)
    uv2 = torch.stack([kp2.x[matches.index], kp2.y[matches.index]], dim=-1)
    mask = matches.valid & kp1.valid & kp2.valid[matches.index]
    return uv1, uv2, mask


def match_stage(s1, s2, cfg: PipelineConfig):
    """Match two SIFT results and compact the correspondences to
    ``geometry_cap`` slots (valid first; matches beyond the cap are
    dropped, never corrupted)."""
    m = match_mod.match(s1.descriptors, s2.descriptors, s1.keypoints.valid,
                        s2.keypoints.valid, cfg.match)
    uv1, uv2, mask = gather_correspondences(s1.keypoints, s2.keypoints, m)
    cap = cfg.geometry_cap
    if cap and cap < mask.shape[0]:
        order = compaction_order(mask)[:cap]
        uv1, uv2, mask = uv1[order], uv2[order], mask[order]
    return uv1, uv2, mask


def frontend_stage(img1, img2, cfg: PipelineConfig = PipelineConfig()):
    """SIFT on both images, then the match stage."""
    s1 = frontend.extract_sift(img1, cfg.sift)
    s2 = frontend.extract_sift(img2, cfg.sift)
    return match_stage(s1, s2, cfg)
