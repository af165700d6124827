"""Camera intrinsics, point normalization and projection (counterpart of
``sfm_tpu/geometry/camera.py``)."""

from __future__ import annotations

import torch


def intrinsics(fx, fy=None, cx=0.0, cy=0.0, skew=0.0, dtype=torch.float32,
               device=None):
    """3x3 intrinsic matrix K = [[fx, skew, cx], [0, fy, cy], [0, 0, 1]]
    (fy = fx unless given)."""
    if fy is None:
        fy = fx
    return torch.tensor([[fx, skew, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                        dtype=dtype, device=device)


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


def project(X, R, t, K=None):
    """Project world points [..., 3] by (R, t) and, if given, K: (pixel
    or normalized-plane coordinates [..., 2], depth [...]); depths
    within 1e-12 of zero divide by 1e-12."""
    Xc = X @ R.T + t
    depth = Xc[..., 2]
    if K is not None:
        Xc = Xc @ K.T
    z = torch.where(depth[..., None].abs() < 1e-12,
                    torch.full_like(Xc[..., 2:3], 1e-12), Xc[..., 2:3])
    return Xc[..., :2] / z, depth
