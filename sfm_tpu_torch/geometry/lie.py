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


def so3_log(R):
    """[..., 3, 3] rotation -> [..., 3] axis-angle (theta in [0, pi]):
    ``theta / (2 sin theta)`` times the skew part's vee, its series below
    theta = 1e-4, and past theta = 3.0 the axis from the diagonal with
    the off-diagonals' signs."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    scale = torch.where(theta < 1e-4, 0.5 + theta * theta / 12.0,
                        theta / torch.clamp(2.0 * torch.sin(theta), min=1e-12))
    w = v * scale[..., None]
    d = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    c = cos_t[..., None]
    axis = torch.sqrt(torch.clamp((d - c) / (1.0 - c + 1e-12), min=0.0))
    sign = torch.sign(v)
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return torch.where((theta > 3.0)[..., None], axis * sign * theta[..., None], w)


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
