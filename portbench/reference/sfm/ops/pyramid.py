"""Frozen copy of the port's plain K1, K2 and K7 (``sfm_tpu_torch/ops/pyramid.py``):
the separable blur, the blur + 2x decimation, the base chain and the 2x
upsample, in plain PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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


# The plain versions stand in for the kernels.
base_chain = base_chain_plain
blur9 = blur9_plain
scale_down = scale_down_plain
scale_up = scale_up_plain
