"""SO(3) helpers for pose refinement (counterpart of
``sfm_tpu/geometry/lie.py``).  All functions take batched ``[..., 3]``
or ``[..., 3, 3]`` tensors and are safe under ``torch.func.jvp``."""

from __future__ import annotations

import torch

from sfm_tpu_torch.ops.linalg import cross_matrix


def so3_exp(w):
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3], Taylor-guarded at 0."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2)
    K = cross_matrix(w)
    K2 = K @ K
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * K2


def tangent_basis(t):
    """Orthonormal basis [..., 3, 2] of the plane perpendicular to t."""
    t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    e0 = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
    e1 = torch.tensor([0.0, 1.0, 0.0], dtype=t.dtype, device=t.device)
    a = torch.where(t[..., 0:1].abs() < 0.9, e0.expand(t.shape),
                    e1.expand(t.shape))
    b1 = torch.linalg.cross(t, a, dim=-1)
    b1 = b1 / torch.linalg.vector_norm(b1, dim=-1, keepdim=True)
    b2 = torch.linalg.cross(t, b1, dim=-1)
    return torch.stack([b1, b2], dim=-1)
