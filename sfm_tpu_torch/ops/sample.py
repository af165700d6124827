"""K4 and K5: per-keypoint orientation histograms and SIFT descriptors
sampled from the octave atlas.

K4 ``fused_orient_descriptor`` replaces ``sfm_tpu/ops/pallas_sample.py:
788 fused_orient_descriptor`` as the frontend runs it (duplicate split,
phases=4): per keypoint an 11 x 11 Gaussian-weighted (sigma = 1.5 *
scale) 32-bin gradient histogram, circular [1, 4, 6, 4, 1] smoothing,
two parabolic-interpolated peaks (ties to the lowest bin), the
``dup = m2 > 0.8 * m1`` flag, and the raw 128-D descriptor at peak 1.
K5 ``descriptor_sample`` replaces ``pallas_sample.py:414
descriptor_sample`` (wide kernel): raw descriptors for a compacted
list of (x, y, scale, orientation).  Both zero every slot >= ``count``.

The TPU kernels recast bilinear sampling as tent-matrix matmuls over a
40-column patch because the TPU has no gather unit.  The CUDA kernels
(``csrc/sample.cu``) take the natural GPU form instead: one 128-thread
block per keypoint gathers its bilinear samples straight from the atlas
in device memory through the read-only cache, builds the histogram in
shared memory without atomics (each of 32 threads sums its own bin in
sample order, so the result is deterministic), finds the peaks in one
thread, and a device function shared by both kernels computes the
16 x 16-sample, 4 x 4 x 8 trilinear descriptor (one output bin per
thread, summed in sample order).  Bound on the card: ~1,500 scattered
4-byte gathers per keypoint — latency bound on the gathers at the
main path's 2,560 keypoints; the atlas (4.6 MB) stays in L2.

Sampling reproduces the TPU kernels' patch geometry: origin
``x0 = clip(floor(x) - 19, 0, Wp - 40)``, rows from an 8-aligned
``y0a``, coordinates clamped to the 40 x 48 patch, and the atlas edge
replicated beyond its last row and column — which equals clamping to
the atlas.  The plain PyTorch versions (the gather forms in
``sift/orient.py`` and ``sift/describe.py``) evaluate the same
roundings in the same order (the kernel uses the ``_rn`` intrinsics),
except the histogram and descriptor sums, which they take with einsum.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.ops import _cuda
from sfm_tpu_torch.ops.image import padded_dims, patch_origin
from sfm_tpu_torch.sift import describe, orient


def _live(K, count, device):
    """[K] bool: slot index < count (a device scalar; never synced)."""
    if count is None:
        return torch.ones(K, dtype=torch.bool, device=device)
    return torch.arange(K, device=device) < torch.as_tensor(count, device=device)


def fused_orient_descriptor_plain(atlas, x, y, scale, count=None):
    """Plain PyTorch K4: (d1 [K, 128] raw, ori1 [K], ori2 [K], dup [K])."""
    H, W = atlas.shape
    x0, y0a, fx, fy = patch_origin(x, y, H, W)
    h = orient.orientation_histograms(atlas, x0, y0a, fx, fy, scale)
    ori1, ori2, dup = orient.orientations_from_histograms(h)
    d1 = describe.raw_descriptors(atlas, x0, y0a, fx, fy, scale, ori1)
    live = _live(x.shape[0], count, atlas.device)
    zero = torch.zeros_like(ori1)
    return (torch.where(live[:, None], d1, torch.zeros_like(d1)),
            torch.where(live, ori1, zero), torch.where(live, ori2, zero),
            dup & live)


def descriptor_sample_plain(atlas, x, y, scale, ori, count=None):
    """Plain PyTorch K5: raw [K, 128] descriptors, zero rows >= count."""
    H, W = atlas.shape
    x0, y0a, fx, fy = patch_origin(x, y, H, W)
    d = describe.raw_descriptors(atlas, x0, y0a, fx, fy, scale, ori)
    live = _live(x.shape[0], count, atlas.device)
    return torch.where(live[:, None], d, torch.zeros_like(d))


def _tables_on(device):
    return (torch.as_tensor(describe.W2D, device=device),
            torch.as_tensor(describe.WSP, device=device).contiguous())


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


def fused_orient_descriptor(atlas, x, y, scale, count=None):
    """K4: (d1 [K, 128] raw, ori1 [K] deg, ori2 [K] deg, dup [K] bool)
    for keypoints compacted valid-first (``count`` valid rows; a device
    scalar, never read on the host)."""
    if not atlas.is_cuda:
        return fused_orient_descriptor_plain(atlas, x, y, scale, count)
    dev, H, W, K, count = _prep(
        atlas, (("x", x), ("y", y), ("scale", scale)), count)
    Hp, Wp = padded_dims(H, W)
    w2d, wsp = _tables_on(dev)
    d1 = torch.empty((K, 128), dtype=torch.float32, device=dev)
    ori1 = torch.empty(K, dtype=torch.float32, device=dev)
    ori2 = torch.empty(K, dtype=torch.float32, device=dev)
    dup = torch.empty(K, dtype=torch.bool, device=dev)
    if K == 0:
        return d1, ori1, ori2, dup
    code = _cuda.library().lib.sfm_fused_orient_descriptor(
        atlas.data_ptr(), H, W, Hp, Wp, x.data_ptr(), y.data_ptr(),
        scale.data_ptr(), count.data_ptr(), K, w2d.data_ptr(), wsp.data_ptr(),
        d1.data_ptr(), ori1.data_ptr(), ori2.data_ptr(), dup.data_ptr(),
        _cuda.stream_ptr(dev))
    _cuda.check(code, "fused_orient_descriptor")
    _cuda.LAUNCHES["fused_orient_descriptor"] += 1
    return d1, ori1, ori2, dup


def descriptor_sample(atlas, x, y, scale, ori, count=None):
    """K5: raw [K, 128] descriptors for compacted keypoints; rows >=
    ``count`` are zero."""
    if not atlas.is_cuda:
        return descriptor_sample_plain(atlas, x, y, scale, ori, count)
    dev, H, W, K, count = _prep(
        atlas, (("x", x), ("y", y), ("scale", scale), ("ori", ori)), count)
    Hp, Wp = padded_dims(H, W)
    w2d, wsp = _tables_on(dev)
    out = torch.empty((K, 128), dtype=torch.float32, device=dev)
    if K == 0:
        return out
    code = _cuda.library().lib.sfm_descriptor_sample(
        atlas.data_ptr(), H, W, Hp, Wp, x.data_ptr(), y.data_ptr(),
        scale.data_ptr(), ori.data_ptr(), count.data_ptr(), K, w2d.data_ptr(),
        wsp.data_ptr(), out.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(code, "descriptor_sample")
    _cuda.LAUNCHES["descriptor_sample"] += 1
    return out
