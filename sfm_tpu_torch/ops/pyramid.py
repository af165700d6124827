"""K1, K2 and K7: the octave base chain's image kernels.

K1 ``blur9`` replaces ``sfm_tpu/ops/pallas_pyramid.py:147 blur9``: a
separable edge-clamped blur of [H, W] with static odd-length taps (the
``init_blur`` prefilter, 9 taps at ``lowpass_radius=4``), a column (H)
pass and then a row (W) pass.  K2 ``scale_down`` replaces
``pallas_pyramid.py:272 scale_down``: a 5-tap Gaussian (variance 0.5)
blur and 2x decimation, [H, W] -> [H//2, W//2], where output (y', x')
reads source rows and columns ``2y' + k - 2`` and ``2x' + k - 2``
clamped to the image; the rows are decimated first, then the columns,
as in the TPU kernel.  K7 ``scale_up`` replaces ``pallas_pyramid.py:241
scale_up``: [H, W] -> [2H, 2W] with the reference's interleave,
``out[2y, 2x] = v``, ``out[2y, 2x+1] = 0.5 (v + vr)``,
``out[2y+1, 2x] = 0.5 (v + vd)``,
``out[2y+1, 2x+1] = 0.25 (v + vr + vd + vdr)`` with the right / lower
neighbours clamped at the edge (the torch form of
``sfm_tpu/ops/image.py:204 scale_up``).

The TPU kernels DMA edge-padded slabs into VMEM and run the decimation
and the upsample's interleave as matmuls on the MXU, because Mosaic has
no stride-2 or interleaving vector slices.  The CUDA kernels
(``csrc/pyramid.cu``) take the direct form: K1 and K2 stage one
clamped slab per output tile in shared memory and run both passes
there, K2 computing only the kept rows and columns (about 4x less work
than blur-then-slice, and the full-resolution blur is never written);
K7 gives each thread one source pixel and its 2 x 2 output quad.
Bound on the card: one f32 read and one f32 write per output pixel
(K7: per source pixel and output quad) — device-memory bound at the
up-scale base (1920 x 2560, ~20 MB each way for K1), launch bound at
the bench's octaves (576 x 720 down to 36 x 45).

Rounding: the plain versions are explicit shifted sums, one IEEE
multiply and one add per tap in tap order (each a separate PyTorch
op), and the kernels evaluate the same operations with the ``_rn``
intrinsics (no FMA contraction), so on the card kernel and plain
version agree bit for bit.  These bases feed K3's DoG threshold.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from sfm_tpu_torch.ops import _cuda

_MAX_TAPS = 17  # csrc/pyramid.cu kMaxTaps


def _taps_list(taps) -> list:
    """Odd-length taps as Python floats holding their exact f32 values."""
    t = np.asarray(taps, np.float32).reshape(-1)
    if t.size % 2 == 0 or not 1 <= t.size <= _MAX_TAPS:
        raise ValueError(f"taps must have an odd length <= {_MAX_TAPS}, got {t.size}")
    return [float(v) for v in t]


def _shifted_sum(taps, slices):
    """taps[0] * s0 + taps[1] * s1 + ..., rounded left to right."""
    acc = taps[0] * slices[0]
    for t, s in zip(taps[1:], slices[1:]):
        acc = acc + t * s
    return acc


def blur9_plain(img, taps):
    """Plain PyTorch K1: edge-clamped separable blur, H pass then W pass."""
    t = _taps_list(taps)
    r = len(t) // 2
    H, W = img.shape
    p = F.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]
    col = _shifted_sum(t, [p[k:k + H, :] for k in range(len(t))])
    return _shifted_sum(t, [col[:, k:k + W] for k in range(len(t))])


def scale_down_plain(img, taps):
    """Plain PyTorch K2: edge-clamped blur + 2x decimation,
    [H, W] -> [H//2, W//2]; rows first, then columns."""
    t = _taps_list(taps)
    r = len(t) // 2
    H, W = img.shape
    Ho, Wo = H // 2, W // 2
    p = F.pad(img[None, None], (r, r, r, r), mode="replicate")[0, 0]
    rows = _shifted_sum(t, [p[k:k + 2 * Ho:2, :] for k in range(len(t))])
    return _shifted_sum(t, [rows[:, k:k + 2 * Wo:2] for k in range(len(t))])


def scale_up_plain(img):
    """Plain PyTorch K7: [H, W] -> [2H, 2W] with the reference's
    interleave (the torch form of ``sfm_tpu/ops/image.py:scale_up``)."""
    vr = torch.cat([img[:, 1:], img[:, -1:]], dim=1)
    vd = torch.cat([img[1:, :], img[-1:, :]], dim=0)
    vdr = torch.cat([vd[:, 1:], vd[:, -1:]], dim=1)
    eo = 0.5 * (img + vr)
    oe = 0.5 * (img + vd)
    oo = 0.25 * (img + vr + vd + vdr)
    H, W = img.shape
    rows = torch.stack([torch.stack([img, eo], -1), torch.stack([oe, oo], -1)], 1)
    return rows.reshape(2 * H, 2 * W)


def _launch_filter(name, c_name, img, taps, out_shape):
    t = _taps_list(taps)
    dev = img.device
    H, W = img.shape
    _cuda.require(img, "img", torch.float32, (H, W), dev)
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    host_taps = (ctypes.c_float * len(t))(*t)
    code = getattr(_cuda.library().lib, c_name)(
        img.data_ptr(), H, W, ctypes.addressof(host_taps), len(t),
        out.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(code, name)
    _cuda.LAUNCHES[name] += 1
    return out


def blur9(img, taps):
    """K1: separable edge-clamped blur of [H, W] (CUDA kernel for CUDA
    tensors, plain PyTorch for CPU tensors)."""
    if not img.is_cuda:
        return blur9_plain(img, taps)
    return _launch_filter("blur9", "sfm_blur", img, taps, tuple(img.shape))


def scale_down(img, taps):
    """K2: blur + 2x decimation, [H, W] -> [H//2, W//2] (CUDA kernel
    for CUDA tensors, plain PyTorch for CPU tensors)."""
    if not img.is_cuda:
        return scale_down_plain(img, taps)
    H, W = img.shape
    if H < 2 or W < 2:
        raise ValueError(f"scale_down: image {H}x{W} has no 2x decimation")
    return _launch_filter("scale_down", "sfm_scale_down", img, taps,
                          (H // 2, W // 2))


def scale_up(img):
    """K7: 2x upsample, [H, W] -> [2H, 2W] (CUDA kernel for CUDA
    tensors, plain PyTorch for CPU tensors)."""
    if not img.is_cuda:
        return scale_up_plain(img)
    dev = img.device
    H, W = img.shape
    _cuda.require(img, "img", torch.float32, (H, W), dev)
    out = torch.empty((2 * H, 2 * W), dtype=torch.float32, device=dev)
    code = _cuda.library().lib.sfm_scale_up(img.data_ptr(), H, W, out.data_ptr(),
                                            _cuda.stream_ptr(dev))
    _cuda.check(code, "scale_up")
    _cuda.LAUNCHES["scale_up"] += 1
    return out
