"""Per-octave keypoint detection (counterpart of ``sfm_tpu/sift/detect.py``).

Two detectors, as in the JAX package:

- the fused route: dense maps from K3, then the selection and the
  post-top-k quadratic refinement (``select_from_maps``,
  ``detect_fused``; ``refine_from_coeffs`` lives beside K3 in
  ``ops/detect.py`` since K3's gated mode evaluates it densely);
- the dense route (``SiftConfig.fused_detect=False``, :func:`detect`) on
  an octave's DoG volume in plain PyTorch: the strict 26-neighbour
  extremum test with ``|DoG| > thresh``, a 1-pixel border, the dense
  quadratic refinement from zero-filled finite differences, the edge
  gate ``0 < tr^2 / det < edge_limit`` and the scale gate, the strongest
  scale per pixel, then the selection.

Selection (``SiftConfig.select``), in both: "topk" the k strongest
candidates; "approx" the same exact top-k, which meets the recall
contract of the JAX package's ``approx_max_k``; "compact" the first k
candidates in scan order (the reference's atomic append).  The dense
route's top-k breaks ties toward the lowest pixel index
(``ops.compact.stable_topk_indices``), so the card and the CPU select
the same slots.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from portbench.reference.sfm.config import SiftConfig
from portbench.reference.sfm.ops.compact import compaction_order, stable_topk_indices
from portbench.reference.sfm.ops.detect import detect_maps, refine_from_coeffs

_SELECT = ("topk", "approx", "compact")
_NEG, _POS = -3.4e38, 3.4e38   # the extremum test's out-of-image fill


class Detections(NamedTuple):
    x: torch.Tensor          # [K] octave-local column (sub-pixel)
    y: torch.Tensor          # [K] octave-local row (sub-pixel)
    scale: torch.Tensor      # [K] blob scale relative to octave base
    sharpness: torch.Tensor  # [K] interpolated DoG response
    edgeness: torch.Tensor   # [K] tr^2/det curvature ratio
    valid: torch.Tensor      # [K] bool


def check_select(cfg: SiftConfig):
    if cfg.select not in _SELECT:
        raise ValueError(f"detect: unknown select mode {cfg.select!r}")


def _compact(flat_resp, k: int):
    """The first k candidates (response > 0) in scan order, then the
    rest: (scores, flat indices)."""
    idx = compaction_order(flat_resp > 0.0)[:k]
    return flat_resp[idx], idx


def _pad(scores, idx, K: int):
    """Pad a selection of fewer than K pixels with invalid slots."""
    pad = K - scores.shape[0]
    if pad <= 0:
        return scores, idx
    return (torch.cat([scores, scores.new_full((pad,), -1.0)]),
            torch.cat([idx, idx.new_zeros(pad)]))


def select_from_maps(resp_px, aux, cfg: SiftConfig) -> Detections:
    """Selection over the response map and a gather of the maps at the
    K selected pixels: the 11 lean coefficients, refined here on the K
    candidates only, or the gated mode's 6 refined maps (s, pdx, pdy,
    pds, sharpness, edge), taken as they are."""
    check_select(cfg)
    S = cfg.num_scales
    K = cfg.max_pts_per_octave
    H, W = resp_px.shape
    k_eff = min(K, H * W)
    flat = resp_px.reshape(-1)
    if cfg.select == "compact":
        scores, flat_idx = _compact(flat, k_eff)
    else:
        scores, flat_idx = torch.topk(flat, k_eff)
    scores, flat_idx = _pad(scores, flat_idx, K)
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


def _shift(a, dy: int, dx: int, fill: float):
    """[P, H, W] shifted by (dy, dx): out[y, x] = a[y + dy, x + dx],
    ``fill`` outside."""
    H, W = a.shape[-2:]
    p = F.pad(a, (1, 1, 1, 1), value=fill)
    return p[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]


def _neighbor_extrema(dog, n_scales: int):
    """The largest and smallest of the 26 neighbours of each centre
    plane: (center [S, H, W], maxv, minv) for ``dog`` [S+2, H, W]; the
    horizontal 3-max feeds both the adjacent planes' 3 x 3 maxima and
    the in-plane 8-neighbour maxima."""
    S = n_scales
    center = dog[1:S + 1]
    hmax = torch.maximum(torch.maximum(_shift(dog, 0, -1, _NEG), dog),
                         _shift(dog, 0, 1, _NEG))
    hmin = torch.minimum(torch.minimum(_shift(dog, 0, -1, _POS), dog),
                         _shift(dog, 0, 1, _POS))
    full_max = torch.maximum(torch.maximum(_shift(hmax, -1, 0, _NEG), hmax),
                             _shift(hmax, 1, 0, _NEG))
    full_min = torch.minimum(torch.minimum(_shift(hmin, -1, 0, _POS), hmin),
                             _shift(hmin, 1, 0, _POS))
    inp_max = torch.maximum(
        torch.maximum(_shift(hmax, -1, 0, _NEG), _shift(hmax, 1, 0, _NEG)),
        torch.maximum(_shift(dog, 0, -1, _NEG), _shift(dog, 0, 1, _NEG)))
    inp_min = torch.minimum(
        torch.minimum(_shift(hmin, -1, 0, _POS), _shift(hmin, 1, 0, _POS)),
        torch.minimum(_shift(dog, 0, -1, _POS), _shift(dog, 0, 1, _POS)))
    maxv = torch.maximum(torch.maximum(full_max[0:S], full_max[2:S + 2]),
                         inp_max[1:S + 1])
    minv = torch.minimum(torch.minimum(full_min[0:S], full_min[2:S + 2]),
                         inp_min[1:S + 1])
    return center, maxv, minv


def _refine_dense(dog, n_scales: int):
    """The quadratic refinement at every pixel of the S centre planes
    from zero-filled finite differences: [5, S, H, W] stacking (pdx,
    pdy, pds, sharpness, edge)."""
    S = n_scales
    c = dog[1:S + 1]
    xm, xp = _shift(c, 0, -1, 0.0), _shift(c, 0, 1, 0.0)
    ym, yp = _shift(c, -1, 0, 0.0), _shift(c, 1, 0, 0.0)
    sm, sp = dog[0:S], dog[2:S + 2]
    dxx = 2.0 * c - xm - xp
    dyy = 2.0 * c - ym - yp
    dss = 2.0 * c - sm - sp
    dxy = 0.25 * (_shift(c, 1, 1, 0.0) + _shift(c, -1, -1, 0.0)
                  - _shift(c, -1, 1, 0.0) - _shift(c, 1, -1, 0.0))
    dxs = 0.25 * (_shift(sp, 0, 1, 0.0) + _shift(sm, 0, -1, 0.0)
                  - _shift(sm, 0, 1, 0.0) - _shift(sp, 0, -1, 0.0))
    dys = 0.25 * (_shift(sp, 1, 0, 0.0) + _shift(sm, -1, 0, 0.0)
                  - _shift(sp, -1, 0, 0.0) - _shift(sm, 1, 0, 0.0))
    dx = 0.5 * (xp - xm)
    dy = 0.5 * (yp - ym)
    ds = 0.5 * (sm - sp)
    return torch.stack(refine_from_coeffs(c, dx, dy, ds, dxx, dyy, dss, dxy,
                                          dxs, dys))


def detect(dog, cfg: SiftConfig, subsampling: float) -> Detections:
    """Up to ``max_pts_per_octave`` keypoints of one octave's DoG volume
    [S+2, H, W]; ``subsampling`` (the octave's 2**o) scales
    ``lowest_scale`` into the octave's scale gate."""
    check_select(cfg)
    S = cfg.num_scales
    K = cfg.max_pts_per_octave
    _, H, W = dog.shape
    center, maxv, minv = _neighbor_extrema(dog, S)
    thresh = float(cfg.thresh)
    cand = ((center > torch.clamp(maxv, min=thresh))
            | (center < torch.clamp(minv, max=-thresh)))
    border = torch.zeros((H, W), dtype=torch.bool, device=dog.device)
    border[1:-1, 1:-1] = True
    refined = _refine_dense(dog, S)                         # [5, S, H, W]
    pds_d, edge_d = refined[2], refined[4]
    edge_ok = (edge_d > 0.0) & (edge_d < cfg.edge_limit)
    plane = torch.arange(S, dtype=torch.float32, device=dog.device)[:, None, None]
    scale_ok = torch.exp2((plane + pds_d) / S) >= (cfg.lowest_scale / subsampling)
    cand = cand & border & edge_ok & scale_ok
    response = torch.where(cand, center.abs(), torch.full_like(center, -1.0))
    # The strongest scale per pixel (the first on ties), then the
    # selection over [H * W].
    resp_px, s_sel = torch.max(response, dim=0)
    k_eff = min(K, H * W)
    flat = resp_px.reshape(-1)
    if cfg.select == "compact":
        scores, flat_idx = _compact(flat, k_eff)
    else:
        flat_idx = stable_topk_indices(flat, k_eff)
        scores = flat[flat_idx]
    scores, flat_idx = _pad(scores, flat_idx, K)
    s_idx = s_sel.reshape(-1)[flat_idx]
    pdx, pdy, pds, sharp, edge = refined.reshape(5, -1)[:, s_idx * (H * W) + flat_idx]
    return Detections(
        x=(flat_idx % W).to(torch.float32) + pdx,
        y=torch.div(flat_idx, W, rounding_mode="floor").to(torch.float32) + pdy,
        scale=torch.exp2((s_idx.to(torch.float32) + pds) / S),
        sharpness=sharp,
        edgeness=edge,
        valid=scores > 0.0,
    )
