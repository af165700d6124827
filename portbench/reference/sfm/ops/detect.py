"""Frozen copy of the port's plain K3 (``sfm_tpu_torch/ops/detect.py``): the
DoG detection maps of an octave base in plain PyTorch, and the
closed-form refinement.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


_R = 4          # blur tap radius (laplace_radius)


def _taps_array(taps) -> np.ndarray:
    t = np.asarray(taps, np.float32)
    if t.ndim != 2 or t.shape[1] != 2 * _R + 1:
        raise ValueError(f"taps must be [planes, {2 * _R + 1}], got {t.shape}")
    return t


def _guard(v):
    """The reference's 1e-20 guard on a denominator."""
    return torch.where(v.abs() < 1e-20, torch.full_like(v, 1e-20), v)


def refine_from_coeffs(val, dx, dy, ds, dxx, dyy, dss, dxy, dxs, dys):
    """Closed-form 3D quadratic refinement with the per-axis fallback
    when any offset leaves (-0.5, 0.5): (pdx, pdy, pds, sharpness, edge).
    The gated K3 mode evaluates it densely, in this order."""
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


def _resolve_lean(gates, lean: bool | None) -> bool:
    """The JAX package's mode rule (``pallas_detect.py:281-284``): lean
    unless a scale gate is set; the lean mode cannot apply one."""
    gated = any(g > 0.0 for g in gates)
    if lean is None:
        return not gated
    if lean and gated:
        raise ValueError("lean detect kernel cannot apply scale_gate")
    return bool(lean)


def detect_maps_plain(base, taps, thresh: float, edge_limit: float,
                      scale_gate: float = 0.0, lean: bool | None = None):
    """Plain PyTorch detection maps: (resp [H, W], aux [C, H, W]), C = 11
    (lean) or 6 (gated: s, pdx, pdy, pds, sharpness, edge)."""
    lean = _resolve_lean([scale_gate], lean)
    H, W = base.shape
    taps = torch.tensor(_taps_array(taps), device=base.device)
    P = taps.shape[0]
    inv_s = np.float32(1.0 / (P - 3))
    pad = F.pad(base[None, None], (_R, _R, _R, _R), mode="replicate")[0, 0]
    blurs = []
    for p in range(P):
        col = torch.zeros((H, W + 2 * _R), dtype=base.dtype, device=base.device)
        for k in range(2 * _R + 1):
            col = col + taps[p, k] * pad[k:k + H, :]
        row = torch.zeros((H, W), dtype=base.dtype, device=base.device)
        for k in range(2 * _R + 1):
            row = row + taps[p, k] * col[:, k:k + W]
        blurs.append(row)
    dog = [blurs[d + 1] - blurs[d] for d in range(P - 1)]

    def sh(a, dy, dx):
        return a[1 + dy:H - 1 + dy, 1 + dx:W - 1 + dx]

    best = torch.full((max(H - 2, 0), max(W - 2, 0)), -1.0,
                      dtype=base.dtype, device=base.device)
    nq = 11 if lean else 6
    sel = [torch.zeros_like(best) for _ in range(nq)]
    for s in range(1, P - 2):
        lo, c, hi = dog[s - 1], dog[s], dog[s + 1]
        val = sh(c, 0, 0)
        maxv = minv = None
        for plane, center in ((lo, False), (c, True), (hi, False)):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if center and dy == 0 and dx == 0:
                        continue
                    v = sh(plane, dy, dx)
                    maxv = v if maxv is None else torch.maximum(maxv, v)
                    minv = v if minv is None else torch.minimum(minv, v)
        cand = ((val > torch.clamp(maxv, min=thresh))
                | (val < torch.clamp(minv, max=-thresh)))
        xm, xp = sh(c, 0, -1), sh(c, 0, 1)
        ym, yp = sh(c, -1, 0), sh(c, 1, 0)
        sm, sp = sh(lo, 0, 0), sh(hi, 0, 0)
        dxx = 2.0 * val - xm - xp
        dyy = 2.0 * val - ym - yp
        dss = 2.0 * val - sm - sp
        dxy = 0.25 * (sh(c, 1, 1) + sh(c, -1, -1) - sh(c, -1, 1) - sh(c, 1, -1))
        dxs = 0.25 * (sh(hi, 0, 1) + sh(lo, 0, -1) - sh(lo, 0, 1) - sh(hi, 0, -1))
        dys = 0.25 * (sh(hi, 1, 0) + sh(lo, -1, 0) - sh(hi, -1, 0) - sh(lo, 1, 0))
        dx = 0.5 * (xp - xm)
        dy = 0.5 * (yp - ym)
        ds = 0.5 * (sm - sp)
        s_map = torch.full_like(val, float(s - 1))
        if lean:
            tra = dxx + dyy
            det = dxx * dyy - dxy * dxy
            t2 = tra * tra
            cand = cand & (det > 0.0) & (t2 > 0.0) & (t2 < edge_limit * det)
            maps = (s_map, val, dx, dy, ds, dxx, dyy, dss, dxy, dxs, dys)
        else:
            pdx, pdy, pds, sharp, edge = refine_from_coeffs(
                val, dx, dy, ds, dxx, dyy, dss, dxy, dxs, dys)
            scale_d = torch.exp2((float(s - 1) + pds) * inv_s)
            cand = (cand & (edge > 0.0) & (edge < edge_limit)
                    & (scale_d >= scale_gate))
            maps = (s_map, pdx, pdy, pds, sharp, edge)
        resp = torch.where(cand, val.abs(), torch.full_like(val, -1.0))
        take = resp > best
        best = torch.where(take, resp, best)
        for q, v in enumerate(maps):
            sel[q] = torch.where(take, v, sel[q])
    resp_full = torch.full((H, W), -1.0, dtype=base.dtype, device=base.device)
    aux = torch.zeros((nq, H, W), dtype=base.dtype, device=base.device)
    if H > 2 and W > 2:
        resp_full[1:-1, 1:-1] = best
        aux[:, 1:-1, 1:-1] = torch.stack(sel)
    return resp_full, aux


def detect_maps_octaves(bases, taps, thresh: float, edge_limit: float,
                        scale_gate=0.0, lean: bool | None = None):
    """Detection maps of every octave base of an image:
    ``[(resp [H_o, W_o], aux [C, H_o, W_o])]``.  ``taps``: the octaves'
    ``[planes, 9]`` banks, or one ``[octaves, planes, 9]`` f32 array
    (taken as it is: the frontend caches it).  ``scale_gate``: one gate
    for every octave or one per octave; ``lean=None`` is lean unless a
    gate is > 0; the plain version per octave."""
    if len(bases) != len(taps) or not bases:
        raise ValueError(f"{len(bases)} bases for {len(taps)} tap banks")
    n = len(bases)
    gates = ([float(scale_gate)] * n if np.ndim(scale_gate) == 0
             else [float(g) for g in scale_gate])
    if len(gates) != n:
        raise ValueError(f"{len(gates)} scale gates for {n} octaves")
    lean = _resolve_lean(gates, lean)
    return [detect_maps_plain(b, t, thresh, edge_limit, g, lean)
                for b, t, g in zip(bases, taps, gates)]


def detect_maps(base, taps, thresh: float, edge_limit: float,
                scale_gate: float = 0.0, lean: bool | None = None):
    """Detection maps of one octave base: (resp [H, W], aux [C, H, W])."""
    return detect_maps_plain(base, taps, thresh, edge_limit, scale_gate, lean)
