"""K1 + K2, the octave base chain, and K7: the pyramid's image kernels.

K1 ``blur9`` replaces ``sfm_tpu/ops/pallas_pyramid.py:147 blur9``: a
separable edge-clamped blur of [H, W] with static odd-length taps (the
``init_blur`` prefilter, 9 taps at ``lowpass_radius=4``), a column (H)
pass and then a row (W) pass.  K2 ``scale_down`` replaces
``pallas_pyramid.py:272 scale_down``: a 5-tap Gaussian (variance 0.5)
blur and 2x decimation, [H, W] -> [H//2, W//2], where output (y', x')
reads source rows and columns ``2y' + k - 2`` and ``2x' + k - 2``
clamped to the image; the rows are decimated first, then the columns,
as in the TPU kernel.  The JAX package composes them as
``sfm_tpu/sift/pyramid.py:165 base_chain_pallas``: K1, then one K2 per
further octave.  K7 ``scale_up`` replaces ``pallas_pyramid.py:241
scale_up``: [H, W] -> [2H, 2W] with the reference's interleave,
``out[2y, 2x] = v``, ``out[2y, 2x+1] = 0.5 (v + vr)``,
``out[2y+1, 2x] = 0.5 (v + vd)``,
``out[2y+1, 2x+1] = 0.25 (v + vr + vd + vdr)`` with the right / lower
neighbours clamped at the edge (the torch form of
``sfm_tpu/ops/image.py:204 scale_up``).

The TPU kernels DMA edge-padded slabs into VMEM and run the decimation
and the upsample's interleave as matmuls on the MXU, because Mosaic has
no stride-2 or interleaving vector slices.  On the card
(``csrc/pyramid.cu``) :func:`base_chain` computes every octave base of
an image in ONE launch on a persistent grid: the work is a list of
tiles in level order, the prefilter's 32 x 32 tiles (K1: the clamped
slab in shared memory, column pass, row pass), then each descent's
16 x 32 tiles (K2: only the kept rows and columns, the full-resolution
blur never written), each level read back from L2 where the level above
was just written.  Blocks claim tiles from an atomic counter, and a
descent tile waits only for the tile rows of the level above that its
slab reads (a counter per tile row), so no grid-wide barrier idles the
card between levels.  The counters live in a small buffer per stream
(:func:`_sync_buffer`) that the kernel's last block zeroes again.  The
levels lie in one buffer, each on a 128-byte line
(:func:`chain_layout`), and come back as contiguous views.
:func:`blur9` and :func:`scale_down` are the one-level cases of the same
kernel.  K7 gives each thread one source pixel and its 2 x 2 output
quad.  What bounds the chain: one f32 read of the source and one f32
write per output pixel of every level — device-memory bound at the
up-scale base (1920 x 2560, ~20 MB each way for level 0), launch bound
at the bench's levels (576 x 720 down to 36 x 45), where one launch
replaces five.

Rounding: the plain versions are explicit shifted sums, one IEEE
multiply and one add per tap in tap order (each a separate PyTorch
op), and the kernel evaluates the same operations with the ``_rn``
intrinsics (no FMA contraction), so on the card kernel and plain
version agree bit for bit.  These bases feed K3's DoG threshold.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from sfm_tpu_torch.ops import _cuda

_MAX_TAPS = 17              # csrc/pyramid.cu kMaxTaps
_LINE = 32                  # floats per 128-byte line: each level starts on one


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


def base_chain_plain(img, lp, sd, levels: int) -> list:
    """Plain PyTorch K1 + K2: the prefilter ``lp``, then ``levels - 1``
    descents by ``sd``."""
    out = [blur9_plain(img, lp)]
    for _ in range(levels - 1):
        out.append(scale_down_plain(out[-1], sd))
    return out


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


def chain_layout(shape, levels: int, first: int = 0):
    """The chain's output buffer for an [H, W] source: (shapes, offsets,
    total floats) of levels ``first`` .. ``levels - 1``.  Level o is
    ``[H >> o, W >> o]`` (the floor at every step, as
    ``frontend.atlas_layout`` assumes) and starts on a 128-byte line
    (a multiple of 32 floats)."""
    H, W = shape
    if levels < 1:
        raise ValueError(f"base chain: {levels} levels")
    if H < 1 or W < 1:
        raise ValueError(f"base chain: empty image {H}x{W}")
    shapes, offsets, total = [], [], 0
    for o in range(first, levels):
        h, w = H >> o, W >> o
        if h < 1 or w < 1:
            raise ValueError(f"scale_down: image {H >> (o - 1)}x{W >> (o - 1)} "
                             f"has no 2x decimation")
        shapes.append((h, w))
        offsets.append(total)
        total += -(-h * w // _LINE) * _LINE
    return shapes, offsets, total


class _Plan(NamedTuple):
    """Everything a launch needs that depends only on the device, the
    shape, the level count and the taps (host arrays kept alive here)."""
    shapes: list
    offsets: list
    total: int
    sync_ints: int      # the kernel's tile counters
    blocks: int
    args: tuple         # pre taps, n_pre, sd taps, n_sd, levels, offsets
    keep: tuple


_PLANS: dict = {}
_BLOCKS_PER_SM: dict = {}
_SYNC: dict = {}


def _blocks_per_sm(dev) -> int:
    """Chain-kernel blocks one SM holds at once (cached per card)."""
    if dev.index not in _BLOCKS_PER_SM:
        n = ctypes.c_int(0)
        with torch.cuda.device(dev):
            _cuda.check(_cuda.library().lib.sfm_base_chain_blocks_per_sm(
                ctypes.byref(n)), "base_chain")
        _BLOCKS_PER_SM[dev.index] = n.value
    return _BLOCKS_PER_SM[dev.index]


def _sync_buffer(dev, stream: int, n: int) -> torch.Tensor:
    """The chain kernel's counters for launches on ``stream``: zero
    between launches (each launch's last block zeroes them), so launches
    on one stream share them and another stream gets its own."""
    buf = _SYNC.get((dev.index, stream))
    if buf is None or buf.numel() < n:
        buf = _SYNC[(dev.index, stream)] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                                       device=dev)
    return buf


def _plan(dev, H, W, levels, pre, sd) -> _Plan:
    shapes, offsets, total = chain_layout((H, W), levels, 0 if pre is not None else 1)
    sync_ints = _cuda.library().lib.sfm_base_chain_sync_ints(H, W, levels,
                                                               int(pre is not None))
    # One wave: the kernel caps it at the tile count.
    blocks = _blocks_per_sm(dev) * _cuda.sm_count(dev)
    taps = [None if t is None else (ctypes.c_float * len(t))(*t) for t in (pre, sd)]
    offs = (ctypes.c_int64 * len(offsets))(*offsets)
    addr = [None if t is None else ctypes.addressof(t) for t in taps]
    args = (addr[0], 0 if pre is None else len(pre), addr[1],
            0 if sd is None else len(sd), levels, ctypes.addressof(offs))
    return _Plan(shapes, offsets, total, sync_ints, blocks, args, (*taps, offs))


def _taps_key(taps):
    return None if taps is None else tuple(_taps_list(taps))


def _launch_chain(img, pre, sd, levels: int) -> list:
    """One launch writing levels (0 if ``pre`` is given, else 1) ..
    ``levels - 1`` of ``img``'s chain; their views."""
    dev = img.device
    _cuda.require(img, "img", torch.float32, None, dev)
    if img.dim() != 2:
        raise ValueError(f"img: expected [H, W], got {tuple(img.shape)}")
    H, W = img.shape
    key = (dev.index, H, W, levels, pre, sd)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = _plan(dev, H, W, levels, _taps_key(pre), _taps_key(sd))
    out = torch.empty(plan.total, dtype=torch.float32, device=dev)
    stream = _cuda.stream_ptr(dev)
    sync = _sync_buffer(dev, stream, plan.sync_ints)
    code = _cuda.library().lib.sfm_base_chain(
        img.data_ptr(), H, W, *plan.args, out.data_ptr(), sync.data_ptr(),
        plan.blocks, stream)
    _cuda.check(code, "base_chain")
    _cuda.launched("base_chain")
    return [out.as_strided((h, w), (w, 1), off)
            for (h, w), off in zip(plan.shapes, plan.offsets)]


def base_chain(img, lp, sd, levels: int) -> list:
    """K1 + K2: the ``levels`` octave bases of [H, W] — the prefilter
    ``lp``, then ``levels - 1`` descents by ``sd`` — as contiguous
    ``[H >> o, W >> o]`` tensors.  CUDA tensors: one kernel launch (the
    levels are views of one buffer); CPU tensors: the plain version.
    ``lp`` and ``sd`` are odd-length taps; tuples of floats are the
    cheapest to key the per-shape launch plan on."""
    if not img.is_cuda:
        chain_layout(tuple(img.shape), levels)   # the same refusals
        return base_chain_plain(img, lp, sd, levels)
    return _launch_chain(img, tuple(lp), tuple(sd), levels)


def blur9(img, taps):
    """K1: separable edge-clamped blur of [H, W] (the chain kernel's
    prefilter alone for CUDA tensors, plain PyTorch for CPU tensors)."""
    if not img.is_cuda:
        return blur9_plain(img, taps)
    return _launch_chain(img, tuple(taps), None, 1)[0]


def scale_down(img, taps):
    """K2: blur + 2x decimation, [H, W] -> [H//2, W//2] (the chain
    kernel's one descent, reading ``img`` in place, for CUDA tensors;
    plain PyTorch for CPU tensors)."""
    if not img.is_cuda:
        chain_layout(tuple(img.shape), 2, 1)
        return scale_down_plain(img, taps)
    return _launch_chain(img, None, tuple(taps), 2)[0]


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
    _cuda.launched("scale_up")
    return out
