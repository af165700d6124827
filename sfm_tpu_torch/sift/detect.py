"""Per-octave keypoint detection: dense maps (K3), exact top-k
selection and the post-top-k quadratic refinement (counterpart of
``sfm_tpu/sift/detect.py``: ``refine_from_coeffs``, ``select_from_maps``
and ``detect_fused``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.config import SiftConfig
from sfm_tpu_torch.ops.detect import detect_maps


class Detections(NamedTuple):
    x: torch.Tensor          # [K] octave-local column (sub-pixel)
    y: torch.Tensor          # [K] octave-local row (sub-pixel)
    scale: torch.Tensor      # [K] blob scale relative to octave base
    sharpness: torch.Tensor  # [K] interpolated DoG response
    edgeness: torch.Tensor   # [K] tr^2/det curvature ratio
    valid: torch.Tensor      # [K] bool


def _guard(v):
    return torch.where(v.abs() < 1e-20, torch.full_like(v, 1e-20), v)


def refine_from_coeffs(val, dx, dy, ds, dxx, dyy, dss, dxy, dxs, dys):
    """Closed-form 3D quadratic refinement with the per-axis fallback
    when any offset leaves (-0.5, 0.5): (pdx, pdy, pds, sharpness, edge)."""
    tra = dxx + dyy
    det = dxx * dyy - dxy * dxy
    edge = tra * tra / _guard(det)
    idxx = dyy * dss - dys * dys
    idxy = dys * dxs - dxy * dss
    idxs = dxy * dys - dyy * dxs
    idyy = dxx * dss - dxs * dxs
    idys = dxy * dxs - dxx * dys
    idss = dxx * dyy - dxy * dxy
    hdet = idxx * dxx + idxy * dxy + idxs * dxs
    idet = 1.0 / _guard(hdet)
    pdx = idet * (idxx * dx + idxy * dy + idxs * ds)
    pdy = idet * (idxy * dx + idyy * dy + idys * ds)
    pds = idet * (idxs * dx + idys * dy + idss * ds)
    off = torch.maximum(torch.maximum(pdx.abs(), pdy.abs()), pds.abs())
    fallback = off > 0.5
    pdx = torch.where(fallback, dx / _guard(dxx), pdx)
    pdy = torch.where(fallback, dy / _guard(dyy), pdy)
    pds = torch.where(fallback, ds / _guard(dss), pds)
    pdx = torch.clamp(pdx, -1.0, 1.0)
    pdy = torch.clamp(pdy, -1.0, 1.0)
    pds = torch.clamp(pds, -1.0, 1.0)
    dval = 0.5 * (dx * pdx + dy * pdy + ds * pds)
    return pdx, pdy, pds, val + dval, edge


def _check_select(cfg: SiftConfig):
    if cfg.select != "topk":
        raise NotImplementedError(
            f"select={cfg.select!r}: only the exact 'topk' selection is ported")
    if cfg.lowest_scale > 0.0:
        raise NotImplementedError(
            "lowest_scale > 0 needs the non-lean detect kernel (dense scale "
            "gate), which is not ported")


def select_from_maps(resp_px, aux, cfg: SiftConfig) -> Detections:
    """Exact top-k over the response map, gather of the 11 lean
    coefficients, refinement on the K selected candidates only."""
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
    vals = aux.reshape(aux.shape[0], -1)[:, flat_idx]           # [11, K]
    s_sel = vals[0]
    pdx, pdy, pds, sharp, edge = refine_from_coeffs(*vals[1:])
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


def detect_fused(base, taps, cfg: SiftConfig) -> Detections:
    """Detection for one octave: dense maps from K3, then the top-k tail.
    ``taps``: ``pyramid.octave_kernel_bank`` for this octave."""
    resp, aux = detect_maps(base, taps, float(cfg.thresh), float(cfg.edge_limit))
    return select_from_maps(resp, aux, cfg)
