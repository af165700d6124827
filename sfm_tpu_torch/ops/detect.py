"""K3: fused dense detection maps for one octave base.

Replaces the TPU kernel ``sfm_tpu/ops/pallas_detect.py:259 detect_maps``
(the LEAN kernel).  Per pixel: the 8-plane blur bank of the octave
(``pyramid.octave_kernel_bank`` taps, separable, edge replicated), the
7 DoG planes, a strict 26-neighbour extremum test against +/-thresh
inside the 1-pixel border, the division-free edge gate
``det > 0 & tr^2 > 0 & tr^2 < edge_limit * det``, and — at the
strongest passing scale, first maximum winning — the response |DoG|
plus the 11 raw refinement coefficients
(s, val, dx, dy, ds, dxx, dyy, dss, dxy, dxs, dys).  The quadratic
solve runs after top-k (``sift.detect.select_from_maps``).

CUDA kernel (``csrc/detect.cu``): one 512-thread block per 16 x 32
output tile loads the edge-clamped slab (tile + 1-pixel NMS halo +
4-pixel blur radius) into shared memory once, computes each blur plane
as a column then a row pass of f32 multiply-adds, and keeps a rolling
window of 3 DoG planes in shared memory, so no blurred or DoG plane
ever reaches device memory.  Bound on the card: one read of the base
and one write of 12 maps per pixel (48 B/px) against ~300 FLOP/px —
memory bound at large octaves, launch bound at the small ones.

The blur adds, the DoG differences and every coefficient are rounded
as separate IEEE operations in the order the plain version evaluates
them (``__fmul_rn`` / ``__fadd_rn``, no FMA contraction), so on the
card the kernel and the plain version agree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sfm_tpu_torch.ops import _cuda

_R = 4          # blur tap radius (laplace_radius)
_MAX_PLANES = 16


def _taps_tensor(taps, device):
    t = torch.as_tensor(np.asarray(taps, np.float32), device=device)
    if t.dim() != 2 or t.shape[1] != 2 * _R + 1:
        raise ValueError(f"taps must be [planes, {2 * _R + 1}], got {tuple(t.shape)}")
    return t.contiguous()


def detect_maps_plain(base, taps, thresh: float, edge_limit: float):
    """Plain PyTorch lean detection maps: (resp [H, W], aux [11, H, W])."""
    H, W = base.shape
    taps = _taps_tensor(taps, base.device)
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


def detect_maps(base, taps, thresh: float, edge_limit: float):
    """Lean detection maps: CUDA kernel for CUDA tensors, plain PyTorch
    for CPU tensors.  Returns (resp [H, W], aux [11, H, W])."""
    if not base.is_cuda:
        return detect_maps_plain(base, taps, thresh, edge_limit)
    dev = base.device
    H, W = base.shape
    t = _taps_tensor(taps, dev)
    if not 3 <= t.shape[0] <= _MAX_PLANES:
        raise ValueError(f"detect kernel takes 3..{_MAX_PLANES} planes")
    _cuda.require(base, "base", torch.float32, (H, W), dev)
    resp = torch.empty((H, W), dtype=torch.float32, device=dev)
    aux = torch.empty((11, H, W), dtype=torch.float32, device=dev)
    code = _cuda.library().lib.sfm_detect_maps(
        base.data_ptr(), t.data_ptr(), t.shape[0], H, W, float(thresh),
        float(edge_limit), resp.data_ptr(), aux.data_ptr(),
        _cuda.stream_ptr(dev))
    _cuda.check(code, "detect_maps")
    _cuda.LAUNCHES["detect_maps"] += 1
    return resp, aux
