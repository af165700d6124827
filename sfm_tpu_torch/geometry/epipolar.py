"""Eight-point constraints and estimate, epipolar and Sampson residuals
(counterpart of ``sfm_tpu/geometry/epipolar.py``)."""

from __future__ import annotations

import torch

from sfm_tpu_torch.ops import linalg
from sfm_tpu_torch.utils.precision import f32_matmul


def eight_point_matrix(x1, x2):
    """[..., n, 9] constraint rows kron(x2_i, x1_i) for x2^T E x1 = 0
    (E flattened row-major)."""
    A = x2[..., :, None] * x1[..., None, :]
    return A.reshape(*A.shape[:-2], 9)


@f32_matmul
def estimate_E_8pt(x1, x2, *, sweeps: int = 10):
    """Batched 8-point essential estimates from [..., 8, 3] minimal sets:
    the QR null vector of each 8x9 system, projected onto singular
    values (1, 1, 0).  Returns [..., 3, 3]."""
    e = linalg.qr_nullvec(eight_point_matrix(x1, x2))
    return linalg.project_to_essential(e.reshape(*e.shape[:-1], 3, 3), sweeps=sweeps)


@f32_matmul
def normalizing_transform(x, mask=None):
    """Hartley transform T [3, 3]: x @ T.T has zero centroid and mean
    radius sqrt(2) over the masked points."""
    xy = x[..., :2] / x[..., 2:3]
    if mask is None:
        w = torch.ones(xy.shape[:-1], dtype=x.dtype, device=x.device)
    else:
        w = mask.to(x.dtype)
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    c = torch.sum(xy * w[..., None], dim=-2) / wsum
    d = torch.sqrt(torch.sum((xy - c[..., None, :]) ** 2, dim=-1))
    mean_d = torch.sum(d * w, dim=-1) / wsum[..., 0]
    s = (2.0 ** 0.5) / torch.clamp(mean_d, min=1e-3)
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    return torch.stack(
        [
            torch.stack([s, zero, -s * c[..., 0]], dim=-1),
            torch.stack([zero, s, -s * c[..., 1]], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def denormalize_E(E_hat, T1, T2):
    """E = T2^T Ê T1."""
    return torch.einsum("ji,...jk,kl->...il", T2, E_hat, T1)


@f32_matmul
def epipolar_residuals(E, x1, x2):
    """Symmetric squared epipolar distance ``[..., N]`` of all points
    against every E in ``[..., 3, 3]``."""
    l1 = torch.einsum("...ij,nj->...ni", E, x1)
    l2 = torch.einsum("...ji,nj->...ni", E, x2)
    num = torch.einsum("ni,...ni->...n", x2, l1)
    num = num * num
    d1 = l1[..., 0] ** 2 + l1[..., 1] ** 2
    d2 = l2[..., 0] ** 2 + l2[..., 1] ** 2
    eps = 1e-18
    return num * (1.0 / (d1 + eps) + 1.0 / (d2 + eps))


@f32_matmul
def sampson_residuals(E, x1, x2):
    """First-order (Sampson) squared epipolar error ``[..., N]`` of all
    points against every E in ``[..., 3, 3]``."""
    l1 = torch.einsum("...ij,nj->...ni", E, x1)
    l2 = torch.einsum("...ji,nj->...ni", E, x2)
    num = torch.einsum("ni,...ni->...n", x2, l1)
    num = num * num
    den = l1[..., 0] ** 2 + l1[..., 1] ** 2 + l2[..., 0] ** 2 + l2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-18)
