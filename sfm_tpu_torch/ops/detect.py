"""K3: fused dense detection maps for the octave bases of an image.

Replaces the TPU kernel ``sfm_tpu/ops/pallas_detect.py:259 detect_maps``
(the LEAN kernel).  Per pixel of each octave: the 8-plane blur bank of
the octave (``pyramid.octave_kernel_bank`` taps, separable, edge
replicated), the 7 DoG planes, a strict 26-neighbour extremum test
against +/-thresh inside the 1-pixel border, the division-free edge
gate ``det > 0 & tr^2 > 0 & tr^2 < edge_limit * det``, and — at the
strongest passing scale, first maximum winning — the response |DoG|
plus the 11 raw refinement coefficients
(s, val, dx, dy, ds, dxx, dyy, dss, dxy, dxs, dys).  The quadratic
solve runs after top-k (``sift.detect.select_from_maps``).

What bounds it on the card: one read of the base and one write of 12
maps per pixel (52 B/px, ~0.1 ms at the up-scale size's 6.5 M octave
pixels) against ~300 blur operations per pixel; at the bench's 576 x
720 octaves, launch latency and a grid too thin to fill the card.

CUDA kernel (``csrc/detect.cu``): :func:`detect_maps_octaves` computes
every octave of an image in ONE launch over a flat grid, each block
finding its octave and taps in a by-value parameter table (the taps
travel as host floats in the launch arguments: no device copy, no
stall).  A 128-thread block walks a strip of 118 columns down, one
row per step: each thread keeps its column's 9-row window of the base
in registers for all 8 planes, exchanges column sums through one
shared row per plane for the row pass, keeps the 3 latest DoG rows of
its column in registers and reads the x +- 1 neighbours from a 3-row
shared ring: two block barriers per row, and only the maps reach device
memory.  :func:`detect_maps` is the one-octave case of the same kernel.

The blur adds, the DoG differences and every coefficient are rounded
as separate IEEE operations in the order the plain version evaluates
them (``__fmul_rn`` / ``__fadd_rn``, no FMA contraction), so on the
card the kernel and the plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from sfm_tpu_torch.ops import _cuda

_R = 4          # blur tap radius (laplace_radius)
_MIN_PLANES, _MAX_PLANES = 4, 10   # csrc/detect.cu kMinPlanes, kMaxPlanes
_MAX_OCTAVES = 8


def _taps_array(taps) -> np.ndarray:
    t = np.asarray(taps, np.float32)
    if t.ndim != 2 or t.shape[1] != 2 * _R + 1:
        raise ValueError(f"taps must be [planes, {2 * _R + 1}], got {t.shape}")
    return t


def detect_maps_plain(base, taps, thresh: float, edge_limit: float):
    """Plain PyTorch lean detection maps: (resp [H, W], aux [11, H, W])."""
    H, W = base.shape
    taps = torch.tensor(_taps_array(taps), device=base.device)
    P = taps.shape[0]
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
    sel = [torch.zeros_like(best) for _ in range(11)]
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
        tra = dxx + dyy
        det = dxx * dyy - dxy * dxy
        t2 = tra * tra
        cand = cand & (det > 0.0) & (t2 > 0.0) & (t2 < edge_limit * det)
        resp = torch.where(cand, val.abs(), torch.full_like(val, -1.0))
        take = resp > best
        best = torch.where(take, resp, best)
        for q, v in enumerate((torch.full_like(val, float(s - 1)), val, dx, dy,
                               ds, dxx, dyy, dss, dxy, dxs, dys)):
            sel[q] = torch.where(take, v, sel[q])
    resp_full = torch.full((H, W), -1.0, dtype=base.dtype, device=base.device)
    aux = torch.zeros((11, H, W), dtype=base.dtype, device=base.device)
    if H > 2 and W > 2:
        resp_full[1:-1, 1:-1] = best
        aux[:, 1:-1, 1:-1] = torch.stack(sel)
    return resp_full, aux


def detect_maps_octaves(bases, taps, thresh: float, edge_limit: float):
    """Lean detection maps of every octave base of an image:
    ``[(resp [H_o, W_o], aux [11, H_o, W_o])]``.  ``taps``: the octaves'
    ``[planes, 9]`` banks, or one ``[octaves, planes, 9]`` f32 array
    (taken as it is: the frontend caches it).  CUDA tensors: one kernel
    launch for all octaves; CPU tensors: the plain version per octave."""
    if len(bases) != len(taps) or not bases:
        raise ValueError(f"{len(bases)} bases for {len(taps)} tap banks")
    if not bases[0].is_cuda:
        return [detect_maps_plain(b, t, thresh, edge_limit)
                for b, t in zip(bases, taps)]
    dev = bases[0].device
    tp = np.ascontiguousarray(taps, dtype=np.float32)   # [octaves, planes, 9]
    if tp.ndim != 3 or tp.shape[2] != 2 * _R + 1:
        raise ValueError(f"taps must be [octaves, planes, {2 * _R + 1}], "
                         f"got {tp.shape}")
    P = tp.shape[1]
    if not _MIN_PLANES <= P <= _MAX_PLANES:
        raise ValueError(f"detect kernel takes {_MIN_PLANES}..{_MAX_PLANES} planes")
    if len(bases) > _MAX_OCTAVES:
        raise ValueError(f"detect kernel takes at most {_MAX_OCTAVES} octaves")
    for b in bases:
        if b.dim() != 2:
            raise ValueError(f"base: expected [H, W], got {tuple(b.shape)}")
        _cuda.require(b, "base", torch.float32, None, dev)
    # One buffer holds every octave's resp [H, W] and aux [11, H, W].
    hw = [tuple(b.shape) for b in bases]
    buf = torch.empty(12 * sum(h * w for h, w in hw), dtype=torch.float32,
                      device=dev)
    parts = buf.split([n for h, w in hw for n in (h * w, 11 * h * w)])
    outs = [(parts[2 * i].view(h, w), parts[2 * i + 1].view(11, h, w))
            for i, (h, w) in enumerate(hw)]
    n = len(bases)
    resp_ptrs, aux_ptrs, ptr = [], [], buf.data_ptr()
    for h, w in hw:
        resp_ptrs.append(ptr)
        aux_ptrs.append(ptr + 4 * h * w)
        ptr += 48 * h * w
    u64, i32 = ctypes.c_uint64 * n, ctypes.c_int * n
    args = (u64(*[b.data_ptr() for b in bases]), u64(*resp_ptrs), u64(*aux_ptrs),
            i32(*[h for h, _ in hw]), i32(*[w for _, w in hw]))
    code = _cuda.library().lib.sfm_detect_maps(
        n, *map(ctypes.addressof, args), tp.ctypes.data, P, _cuda.sm_count(dev),
        float(thresh), float(edge_limit), _cuda.stream_ptr(dev))
    _cuda.check(code, "detect_maps")
    _cuda.LAUNCHES["detect_maps"] += 1
    return outs


def detect_maps(base, taps, thresh: float, edge_limit: float):
    """Lean detection maps of one octave base: the one-octave case of
    :func:`detect_maps_octaves` (CUDA kernel for CUDA tensors, plain
    PyTorch for CPU tensors).  Returns (resp [H, W], aux [11, H, W])."""
    if not base.is_cuda:
        return detect_maps_plain(base, taps, thresh, edge_limit)
    return detect_maps_octaves([base], [taps], thresh, edge_limit)[0]
