"""Per-octave keypoint detection: dense maps (K3), exact top-k
selection and the post-top-k quadratic refinement (counterpart of
``sfm_tpu/sift/detect.py``: ``refine_from_coeffs``, which lives beside
K3 in ``ops/detect.py`` since K3's gated mode evaluates it densely,
``select_from_maps`` and ``detect_fused``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.config import SiftConfig
from sfm_tpu_torch.ops.detect import detect_maps, refine_from_coeffs


class Detections(NamedTuple):
    x: torch.Tensor          # [K] octave-local column (sub-pixel)
    y: torch.Tensor          # [K] octave-local row (sub-pixel)
    scale: torch.Tensor      # [K] blob scale relative to octave base
    sharpness: torch.Tensor  # [K] interpolated DoG response
    edgeness: torch.Tensor   # [K] tr^2/det curvature ratio
    valid: torch.Tensor      # [K] bool


def _check_select(cfg: SiftConfig):
    if cfg.select != "topk":
        raise NotImplementedError(
            f"select={cfg.select!r}: only the exact 'topk' selection is ported")


def select_from_maps(resp_px, aux, cfg: SiftConfig) -> Detections:
    """Exact top-k over the response map and a gather of the maps at
    the K selected pixels: the 11 lean coefficients, refined here on the
    K candidates only, or the gated mode's 6 refined maps (s, pdx, pdy,
    pds, sharpness, edge), taken as they are."""
    _check_select(cfg)
    S = cfg.num_scales
    K = cfg.max_pts_per_octave
    H, W = resp_px.shape
    k_eff = min(K, H * W)
    scores, flat_idx = torch.topk(resp_px.reshape(-1), k_eff)
    if k_eff < K:
        pad = K - k_eff
        scores = torch.cat([scores, scores.new_full((pad,), -1.0)])
        flat_idx = torch.cat([flat_idx, flat_idx.new_zeros(pad)])
    vals = aux.reshape(aux.shape[0], -1)[:, flat_idx]           # [11 or 6, K]
    if vals.shape[0] == 11:
        s_sel = vals[0]
        pdx, pdy, pds, sharp, edge = refine_from_coeffs(*vals[1:])
    else:
        s_sel, pdx, pdy, pds, sharp, edge = vals
    y_idx = torch.div(flat_idx, W, rounding_mode="floor")
    x_idx = flat_idx % W
    return Detections(
        x=x_idx.to(torch.float32) + pdx,
        y=y_idx.to(torch.float32) + pdy,
        scale=torch.exp2((s_sel + pds) / S),
        sharpness=sharp,
        edgeness=edge,
        valid=scores > 0.0,
    )


def detect_fused(base, taps, cfg: SiftConfig, subsampling: float) -> Detections:
    """Detection for one octave: dense maps from K3, then the top-k tail.
    ``taps``: ``pyramid.octave_kernel_bank`` for this octave;
    ``subsampling``: the octave's 2**o, which scales ``lowest_scale``
    into the octave's scale gate."""
    resp, aux = detect_maps(base, taps, float(cfg.thresh), float(cfg.edge_limit),
                            scale_gate=float(cfg.lowest_scale / subsampling),
                            lean=cfg.detect_lean)
    return select_from_maps(resp, aux, cfg)
