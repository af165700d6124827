"""K4, K5, K8 and K9: per-keypoint orientation histograms and SIFT
descriptors sampled from the octave atlas.

K4 ``fused_orient_descriptor`` replaces ``sfm_tpu/ops/pallas_sample.py:
788 fused_orient_descriptor`` as the frontend runs it (duplicate split,
phases=4): per keypoint an 11 x 11 Gaussian-weighted (sigma = 1.5 *
scale) 32-bin gradient histogram, circular [1, 4, 6, 4, 1] smoothing,
two parabolic-interpolated peaks (ties to the lowest bin), the
``dup = m2 > 0.8 * m1`` flag, and the raw 128-D descriptor at peak 1.
K5 ``descriptor_sample`` replaces ``pallas_sample.py:414
descriptor_sample`` (wide kernel): raw descriptors for a compacted
list of (x, y, scale, orientation).  K8 ``orientation_histogram_sample``
replaces ``pallas_sample.py:578 orientation_histogram_sample``: the raw
(unsmoothed) [K, 32] histograms alone, on a 16-column patch.  K9
``fused_orient_descriptor_win`` replaces ``pallas_sample.py:998
fused_orient_descriptor_win``: K4's function with each keypoint's
support box staged in shared memory before it is sampled.  All four zero
every slot >= ``count``.

The TPU kernels recast bilinear sampling as tent-matrix matmuls over a
P-column patch because the TPU has no gather unit.  The CUDA kernels
(``csrc/sample.cu``) take the natural GPU form instead:

- K4 and K5: one warp per keypoint, four per block, no block barrier
  (a dead slot's warp zeroes its row and leaves).  A keypoint's ~1,500
  bilinear gathers come straight from the atlas through the read-only
  cache; with < 8 KB touched and ~30k operations per keypoint, neither
  bytes nor operations bound them on the card, but gather latency and
  the instructions a keypoint issues do.  So the lanes share every
  phase: 121 orientation samples, one bin each in sample order, the
  smoothing and the two-peak search on shuffles and ballots, 8 of the
  256 descriptor samples each, then 4 of the 128 outputs each, summed
  over only their cell's nonzero spatial weights (``describe``'s
  compact support table, 36-64 entries in increasing sample order,
  instead of all 256 samples).  Skipping exact zeros in the same order
  keeps every rounding, so the outputs are bit for bit those of the
  first design's one 128-thread block per keypoint.
- K9: K4's warp device code on a window staged in shared memory.  Each
  warp copies with ``cp.async`` only the rows and columns of its
  keypoint's 48 x 40 patch that the samples can reach
  (:func:`support_box`: ~26 x 26 of its cells at scale 1.4, all 40
  columns from scale ~2.4), in 16-byte copies where the atlas allows
  (4-byte copies of clamped addresses at its edge), into a 5 KB buffer
  of its own, and samples from there, so K9 equals K4 bit for bit.  A
  box larger than the buffer is gathered from the atlas as K4 does.
  The grid holds as many warps as the card does at once, each walking
  slots k, k + warps, ...  What bounds it is the warps an SM can hold
  (shared memory: 28, against K4's 40) to hide its latency.
- K8: one warp per keypoint, four per block; each warp stages its
  24 x 16 patch in shared memory (1.5 KB) and takes the 121 gradient
  samples from there, four per lane held in registers.

Every kernel builds its histograms without atomics, so the results are
deterministic: lane b adds the samples of bin b in sample order (K8 and
K9 find each round of 32 samples' bins by five ballots and fetch them
by shuffles; K4 walks all 121 samples in every lane).
Sampling reproduces the TPU kernels' patch geometry
(``ops.image.patch_origin``) with the atlas edge replicated beyond its
last row and column, which equals clamping to the atlas.  The plain
PyTorch versions (the gather forms in ``sift/orient.py`` and
``sift/describe.py``) evaluate the same roundings in the same order
(the kernels use the ``_rn`` intrinsics), except the histogram and
descriptor sums, which they take with einsum.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from sfm_tpu_torch.ops import _cuda
from sfm_tpu_torch.ops.image import DESC_P, ORI_P, padded_dims, patch_origin
from sfm_tpu_torch.sift import describe, orient


def _live(K, count, device):
    """[K] bool: slot index < count (a device scalar; never synced)."""
    if count is None:
        return torch.ones(K, dtype=torch.bool, device=device)
    return torch.arange(K, device=device) < torch.as_tensor(count, device=device)


def fused_orient_descriptor_plain(atlas, x, y, scale, count=None):
    """Plain PyTorch K4 (and K9): (d1 [K, 128] raw, ori1 [K], ori2 [K],
    dup [K])."""
    H, W = atlas.shape
    x0, y0a, fx, fy = patch_origin(x, y, H, W)
    h = orient.patch_histograms(atlas, x0, y0a, fx, fy, scale)
    live = _live(x.shape[0], count, atlas.device)
    ori1, ori2, dup = orient.orientations_from_histograms(h, live)
    d1 = describe.raw_descriptors(atlas, x0, y0a, fx, fy, scale, ori1)
    zero = torch.zeros_like(ori1)
    return (torch.where(live[:, None], d1, torch.zeros_like(d1)),
            torch.where(live, ori1, zero), torch.where(live, ori2, zero), dup)


def descriptor_sample_plain(atlas, x, y, scale, ori, count=None):
    """Plain PyTorch K5: raw [K, 128] descriptors, zero rows >= count."""
    H, W = atlas.shape
    x0, y0a, fx, fy = patch_origin(x, y, H, W)
    d = describe.raw_descriptors(atlas, x0, y0a, fx, fy, scale, ori)
    live = _live(x.shape[0], count, atlas.device)
    return torch.where(live[:, None], d, torch.zeros_like(d))


def orientation_histogram_sample_plain(img, x, y, scale, count=None):
    """Plain PyTorch K8: raw [K, 32] histograms, zero rows >= count."""
    H, W = img.shape
    x0, y0a, fx, fy = patch_origin(x, y, H, W, ORI_P)
    h = orient.patch_histograms(img, x0, y0a, fx, fy, scale, ORI_P)
    live = _live(x.shape[0], count, img.device)
    return torch.where(live[:, None], h, torch.zeros_like(h))


# How far from (fx, fy) K9's bilinear taps can reach before their
# one-step second tap (csrc/sample.cu kOriReach, kDescReach, kReachPad):
# the orientation samples' 5 + 1; the descriptor's 0.75 * scale * 7.5 *
# sqrt(2) (7.95495 per unit scale, rounded up) + 1; 0.01 more for the
# f32 roundings of the positions.
ORI_REACH = 6.01
DESC_REACH = 7.955
REACH_PAD = 1.01


def support_box(fx, fy, scale):
    """K9's staged box for keypoints at patch-relative (fx, fy) [K]
    (``ops.image.patch_origin``): (r0, r1, c0, c1) [K] int64, the rows
    and columns of the 48 x 40 patch (inclusive) that the samples of
    K4's function can read, computed in f32 as the kernel computes it
    (``support_box`` in ``csrc/sample.cu``); the whole patch where the
    scale is not finite or reaches past 64."""
    f32 = torch.float32
    rd = torch.abs(scale.to(f32)) * DESC_REACH + REACH_PAD
    r = torch.where(rd < 64.0, torch.fmax(rd, torch.tensor(ORI_REACH, dtype=f32)),
                    torch.tensor(64.0, dtype=f32))

    def axis(f, n):
        top = torch.tensor(n - 1.0, dtype=f32)
        zero = torch.tensor(0.0, dtype=f32)
        lo = torch.floor(torch.fmin(torch.fmax(f.to(f32) - r, zero), top))
        hi = torch.floor(torch.fmin(torch.fmax(f.to(f32) + r, zero), top)) + 1
        return lo.to(torch.int64), torch.clamp(hi.to(torch.int64), max=n - 1)

    r0, r1 = axis(fy, DESC_P + 8)
    c0, c1 = axis(fx, DESC_P)
    return r0, r1, c0, c1


class _Tables(NamedTuple):
    w2d: torch.Tensor       # [256] f32: the descriptor's Gaussian window
    wsp: torch.Tensor       # [256, 16] f32: spatial cell weights (sup's dense form)
    sup_off: torch.Tensor   # [17] int32: cell c's support entries start here
    sup: torch.Tensor       # [784, 2] int32: (sample, weight's f32 bits)


@functools.lru_cache(maxsize=None)
def _tables_on(device) -> _Tables:
    """The sampling kernels' constant tables on ``device``, copied there
    once per device (``describe``'s window, cell weights and their
    compact support)."""
    sup = np.stack([describe.SUPPORT_S, describe.SUPPORT_W.view(np.int32)], axis=1)
    return _Tables(*(torch.as_tensor(np.ascontiguousarray(a), device=device)
                     for a in (describe.W2D, describe.WSP, describe.SUPPORT_OFFSETS,
                               sup)))


def _prep(atlas, tensors, count):
    dev = atlas.device
    H, W = atlas.shape
    K = tensors[0][1].shape[0]
    _cuda.require(atlas, "atlas", torch.float32, (H, W), dev)
    for name, t in tensors:
        _cuda.require(t, name, torch.float32, (K,), dev)
    if count is None:
        count = torch.full((1,), K, dtype=torch.int32, device=dev)
    count = torch.as_tensor(count, device=dev).to(torch.int32).reshape(1)
    return dev, H, W, K, count


def _fused(name, atlas, x, y, scale, count):
    """Launch K4 (``name`` = "fused_orient_descriptor") or K9
    ("fused_orient_descriptor_win"), which take the same arguments."""
    dev, H, W, K, count = _prep(
        atlas, (("x", x), ("y", y), ("scale", scale)), count)
    Hp, Wp = padded_dims(H, W)
    d1 = torch.empty((K, 128), dtype=torch.float32, device=dev)
    ori1 = torch.empty(K, dtype=torch.float32, device=dev)
    ori2 = torch.empty(K, dtype=torch.float32, device=dev)
    dup = torch.empty(K, dtype=torch.bool, device=dev)
    if K == 0:
        return d1, ori1, ori2, dup
    t = _tables_on(dev)
    code = getattr(_cuda.library().lib, "sfm_" + name)(
        atlas.data_ptr(), H, W, Hp, Wp, x.data_ptr(), y.data_ptr(),
        scale.data_ptr(), count.data_ptr(), K, t.w2d.data_ptr(), t.sup_off.data_ptr(),
        t.sup.data_ptr(), d1.data_ptr(), ori1.data_ptr(), ori2.data_ptr(),
        dup.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(code, name)
    _cuda.launched(name)
    return d1, ori1, ori2, dup


def fused_orient_descriptor(atlas, x, y, scale, count=None):
    """K4: (d1 [K, 128] raw, ori1 [K] deg, ori2 [K] deg, dup [K] bool)
    for keypoints compacted valid-first (``count`` valid rows; a device
    scalar, never read on the host)."""
    if not atlas.is_cuda:
        return fused_orient_descriptor_plain(atlas, x, y, scale, count)
    return _fused("fused_orient_descriptor", atlas, x, y, scale, count)


def fused_orient_descriptor_win(atlas, x, y, scale, count=None):
    """K9: K4's function and outputs, each keypoint's support box
    (:func:`support_box`) staged in shared memory by ``cp.async`` before
    it is sampled."""
    if not atlas.is_cuda:
        return fused_orient_descriptor_plain(atlas, x, y, scale, count)
    return _fused("fused_orient_descriptor_win", atlas, x, y, scale, count)


def descriptor_sample(atlas, x, y, scale, ori, count=None):
    """K5: raw [K, 128] descriptors for compacted keypoints; rows >=
    ``count`` are zero."""
    if not atlas.is_cuda:
        return descriptor_sample_plain(atlas, x, y, scale, ori, count)
    dev, H, W, K, count = _prep(
        atlas, (("x", x), ("y", y), ("scale", scale), ("ori", ori)), count)
    Hp, Wp = padded_dims(H, W)
    t = _tables_on(dev)
    out = torch.empty((K, 128), dtype=torch.float32, device=dev)
    if K == 0:
        return out
    code = _cuda.library().lib.sfm_descriptor_sample(
        atlas.data_ptr(), H, W, Hp, Wp, x.data_ptr(), y.data_ptr(),
        scale.data_ptr(), ori.data_ptr(), count.data_ptr(), K, t.w2d.data_ptr(),
        t.sup_off.data_ptr(), t.sup.data_ptr(), out.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(code, "descriptor_sample")
    _cuda.launched("descriptor_sample")
    return out


def orientation_histogram_sample(img, x, y, scale, count=None):
    """K8: raw (unsmoothed) [K, 32] Gaussian-weighted gradient histograms
    of keypoints compacted valid-first, on the 16-column patch; rows >=
    ``count`` (a device scalar, never read on the host) are zero."""
    if not img.is_cuda:
        return orientation_histogram_sample_plain(img, x, y, scale, count)
    dev, H, W, K, count = _prep(img, (("x", x), ("y", y), ("scale", scale)), count)
    Hp, Wp = padded_dims(H, W, ORI_P)
    out = torch.empty((K, 32), dtype=torch.float32, device=dev)
    if K == 0:
        return out
    code = _cuda.library().lib.sfm_orientation_histogram_sample(
        img.data_ptr(), H, W, Hp, Wp, x.data_ptr(), y.data_ptr(),
        scale.data_ptr(), count.data_ptr(), K, out.data_ptr(),
        _cuda.stream_ptr(dev))
    _cuda.check(code, "orientation_histogram_sample")
    _cuda.launched("orientation_histogram_sample")
    return out
