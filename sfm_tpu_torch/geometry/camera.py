"""Camera intrinsics and point normalization (counterpart of
``sfm_tpu/geometry/camera.py``)."""

from __future__ import annotations

import torch


def inv_intrinsics(K):
    """Closed-form inverse of an upper-triangular K."""
    fx, s, cx = K[0, 0], K[0, 1], K[0, 2]
    fy, cy = K[1, 1], K[1, 2]
    zero = torch.zeros_like(fx)
    one = torch.ones_like(fx)
    return torch.stack([
        torch.stack([1.0 / fx, -s / (fx * fy), (s * cy - cx * fy) / (fx * fy)]),
        torch.stack([zero, 1.0 / fy, -cy / fy]),
        torch.stack([zero, zero, one]),
    ])


def to_homogeneous(uv):
    """[..., 2] pixel coords -> [..., 3] homogeneous."""
    return torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)


def normalize_points(uv, K_inv):
    """x = K^{-1} u for pixel coords ``uv`` [..., 2] -> [..., 3]."""
    return to_homogeneous(uv) @ K_inv.T
