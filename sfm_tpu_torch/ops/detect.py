"""K3: fused dense detection maps for the octave bases of an image.

Replaces the TPU kernel ``sfm_tpu/ops/pallas_detect.py:259 detect_maps``
in both of its modes.  Per pixel of each octave: the blur bank of the
octave (``pyramid.octave_kernel_bank`` taps, separable, edge
replicated), the DoG planes, a strict 26-neighbour extremum test
against +/-thresh inside the 1-pixel border, and then, at the strongest
passing scale (first maximum winning), the response |DoG| and:

- LEAN mode (no scale gate): the division-free edge gate ``det > 0 &
  tr^2 > 0 & tr^2 < edge_limit * det`` and the 11 raw refinement
  coefficients (s, val, dx, dy, ds, dxx, dyy, dss, dxy, dxs, dys); the
  quadratic solve runs after top-k (``sift.detect.select_from_maps``);
- GATED mode (``lean=False``, required for a scale gate > 0): the
  quadratic solve at every candidate (:func:`refine_from_coeffs`), the
  gates ``0 < edge < edge_limit`` and ``exp2((s - 1 + pds) * (1/S)) >=
  scale_gate``, and 6 maps (s, pdx, pdy, pds, sharpness, edge).  The
  gate has to be applied densely: a pixel whose strongest scale fails
  it may have a weaker scale that passes.

What bounds it on the card: one read of the base and one write of the
maps per pixel (52 B/px lean, 32 B/px gated; ~0.1 / ~0.06 ms at the
up-scale size's 6.5 M octave pixels) against ~300 blur operations per
pixel; at the bench's 576 x 720 octaves, launch latency and a grid too
thin to fill the card.

CUDA kernel (``csrc/detect.cu``): :func:`detect_maps_octaves` computes
up to 8 octaves of an image in ONE launch over a flat grid, each block
finding its octave, taps and scale gate in a by-value parameter table
(host floats in the launch arguments: no device copy, no stall); more
octaves take one launch per group of 8 (:func:`octave_groups`).  A
128-thread block walks a strip of 118 columns down, one row per step:
each thread keeps its column's 9-row window of the base in registers
for all planes, exchanges column sums through one shared row per plane
for the row pass, keeps the 3 latest DoG rows of its column in
registers and reads the x +- 1 neighbours from a 3-row shared ring: two
block barriers per row, and only the maps reach device memory.
:func:`detect_maps` is the one-octave case of the same kernel.  Up to
13 planes (``num_scales`` <= 10) the plane count is a template
parameter; past that one route takes the plane count at run time, with
the per-plane rows in dynamic shared memory and the taps in a buffer on
the card (cached per tap bank), up to the planes the card's shared
memory per block holds (:func:`max_planes`: 111 on an H100).

The blur adds, the DoG differences, every coefficient and the gated
mode's solve are rounded as separate IEEE operations in the order the
plain version evaluates them (``__fmul_rn`` / ``__fadd_rn`` /
``__fdiv_rn``, no FMA contraction, ``exp2f`` as ``torch.exp2``), so on
the card the kernel and the plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from sfm_tpu_torch.ops import _cuda

_R = 4          # blur tap radius (laplace_radius)
_MIN_PLANES = 4                    # csrc/detect.cu kMinPlanes
_MAX_BY_VALUE = 13                 # csrc/detect.cu kMaxPlanes: the templated route
_MAX_OCTAVES = 8                   # csrc/detect.cu kMaxOctaves: per launch


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


def octave_groups(n_octaves: int):
    """[start, stop) octave ranges of at most 8 octaves: the kernel's
    parameter table holds 8, so each range is one launch."""
    return [(i, min(i + _MAX_OCTAVES, n_octaves))
            for i in range(0, n_octaves, _MAX_OCTAVES)]


_PLANES_ON_CARD: dict = {}
_DEVICE_TAPS: dict = {}


def max_planes(device) -> int:
    """The most planes the kernel takes on ``device``: what the
    run-time-plane route's shared memory per block allows (cached)."""
    i = torch.device(device).index
    if i not in _PLANES_ON_CARD:
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            _cuda.check(_cuda.library().lib.sfm_detect_max_planes(ctypes.byref(n)),
                        "detect_maps")
        _PLANES_ON_CARD[i] = n.value
    return _PLANES_ON_CARD[i]


def _device_taps(tp: np.ndarray, dev) -> torch.Tensor:
    """The [octaves, planes, 9] taps on the card, copied once per bank."""
    key = (dev.index, tp.shape, tp.tobytes())
    if key not in _DEVICE_TAPS:
        _DEVICE_TAPS[key] = torch.tensor(tp, device=dev)
    return _DEVICE_TAPS[key]


def detect_maps_octaves(bases, taps, thresh: float, edge_limit: float,
                        scale_gate=0.0, lean: bool | None = None):
    """Detection maps of every octave base of an image:
    ``[(resp [H_o, W_o], aux [C, H_o, W_o])]``.  ``taps``: the octaves'
    ``[planes, 9]`` banks, or one ``[octaves, planes, 9]`` f32 array
    (taken as it is: the frontend caches it).  ``scale_gate``: one gate
    for every octave or one per octave; ``lean=None`` is lean unless a
    gate is > 0.  CUDA tensors: one kernel launch per group of 8
    octaves; CPU tensors: the plain version per octave."""
    if len(bases) != len(taps) or not bases:
        raise ValueError(f"{len(bases)} bases for {len(taps)} tap banks")
    n = len(bases)
    gates = ([float(scale_gate)] * n if np.ndim(scale_gate) == 0
             else [float(g) for g in scale_gate])
    if len(gates) != n:
        raise ValueError(f"{len(gates)} scale gates for {n} octaves")
    lean = _resolve_lean(gates, lean)
    if not bases[0].is_cuda:
        return [detect_maps_plain(b, t, thresh, edge_limit, g, lean)
                for b, t, g in zip(bases, taps, gates)]
    dev = bases[0].device
    tp = np.ascontiguousarray(taps, dtype=np.float32)   # [octaves, planes, 9]
    if tp.ndim != 3 or tp.shape[2] != 2 * _R + 1:
        raise ValueError(f"taps must be [octaves, planes, {2 * _R + 1}], "
                         f"got {tp.shape}")
    P = tp.shape[1]
    dev_taps = None   # up to 13 planes the taps ride in the launch arguments
    if not _MIN_PLANES <= P <= _MAX_BY_VALUE:
        cap = max_planes(dev)
        if not _MIN_PLANES <= P <= cap:
            raise ValueError(f"detect kernel takes {_MIN_PLANES} to {cap} planes "
                             f"(num_scales {_MIN_PLANES - 3} to {cap - 3}: the "
                             f"card's shared memory per block), got {P}")
        dev_taps = _device_taps(tp, dev)
    for b in bases:
        if b.dim() != 2:
            raise ValueError(f"base: expected [H, W], got {tuple(b.shape)}")
        _cuda.require(b, "base", torch.float32, None, dev)
    # One buffer holds every octave's resp [H, W] followed by its aux
    # [C, H, W]: the kernel writes both through one pointer per octave.
    C = 11 if lean else 6
    hw = [tuple(b.shape) for b in bases]
    buf = torch.empty((1 + C) * sum(h * w for h, w in hw), dtype=torch.float32,
                      device=dev)
    blocks = [blk.view(1 + C, h, w)
              for blk, (h, w) in zip(buf.split([(1 + C) * h * w for h, w in hw]), hw)]
    outs = [(blk[0], blk[1:]) for blk in blocks]
    for lo, hi in octave_groups(n):
        m = hi - lo
        u64, i32, f32 = ctypes.c_uint64 * m, ctypes.c_int * m, ctypes.c_float * m
        args = (u64(*[b.data_ptr() for b in bases[lo:hi]]),
                u64(*[blk.data_ptr() for blk in blocks[lo:hi]]),
                i32(*[h for h, _ in hw[lo:hi]]), i32(*[w for _, w in hw[lo:hi]]))
        gate = f32(*gates[lo:hi])
        host, card = ((tp[lo:hi].ctypes.data, None) if dev_taps is None else
                      (None, dev_taps[lo:hi].data_ptr()))
        code = _cuda.library().lib.sfm_detect_maps(
            m, *map(ctypes.addressof, args), host, card, ctypes.addressof(gate), P,
            int(lean), _cuda.sm_count(dev), float(thresh), float(edge_limit),
            _cuda.stream_ptr(dev))
        _cuda.check(code, "detect_maps")
        _cuda.launched("detect_maps")
    return outs


def detect_maps(base, taps, thresh: float, edge_limit: float,
                scale_gate: float = 0.0, lean: bool | None = None):
    """Detection maps of one octave base: the one-octave case of
    :func:`detect_maps_octaves` (CUDA kernel for CUDA tensors, plain
    PyTorch for CPU tensors).  Returns (resp [H, W], aux [C, H, W])."""
    if not base.is_cuda:
        return detect_maps_plain(base, taps, thresh, edge_limit, scale_gate, lean)
    return detect_maps_octaves([base], [taps], thresh, edge_limit, scale_gate,
                               lean)[0]
