"""Batched DLT triangulation, multiview track triangulation and cheap
cheirality depths (counterpart of ``sfm_tpu/geometry/triangulate.py``)."""

from __future__ import annotations

import torch

from sfm_tpu_torch.ops import linalg
from sfm_tpu_torch.utils.precision import f32_matmul


def make_projection(R, t):
    """[..., 3, 4] projection P = [R | t]."""
    return torch.cat([R, t[..., :, None]], dim=-1)


def dlt_system(x1, x2, P1, P2):
    """Per-point 4x4 DLT rows x*P[2]-P[0], y*P[2]-P[1] for both views."""
    P1 = P1[..., None, :, :]
    P2 = P2[..., None, :, :]
    r0 = x1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :]
    r1 = x1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :]
    r2 = x2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :]
    r3 = x2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :]
    return torch.stack([r0, r1, r2, r3], dim=-2)


@f32_matmul
def triangulate(x1, x2, P1, P2, *, sweeps: int = 10, w_clamp: float = 5.0,
                solver: str = "jacobi"):
    """Triangulate all correspondences: the unit null vector of each 4x4
    DLT system by ``solver="jacobi"`` (the default, ``sweeps`` Gram
    Jacobi sweeps) or ``"adj"`` (the Gram matrix's adjugate).  Returns
    (X [..., N, 3], w [..., N], finite [..., N])."""
    if solver not in ("adj", "jacobi"):
        raise ValueError(f"triangulate: unknown solver {solver!r}")
    A = dlt_system(x1, x2, P1, P2)
    if solver == "adj":
        X_h = linalg.gram_nullvec4_adj(A)
    else:
        X_h = linalg.gram_nullvec(A, sweeps=sweeps)
    w = X_h[..., 3]
    tiny = torch.where(w < 0, -1e-12, 1e-12).to(w.dtype)
    denom = torch.where(w.abs() < 1e-12, tiny, w)
    X = X_h[..., :3] / denom[..., None]
    finite = (w.abs() * w_clamp
              > torch.linalg.vector_norm(X_h[..., :3], dim=-1) * 1e-6)
    return X, w, finite


def depths(X, R, t):
    """Depth (z of R X + t) of [..., N, 3] points in camera (R, t)."""
    return torch.einsum("...ij,...nj->...ni", R, X)[..., 2] + t[..., None, 2]


@f32_matmul
def midpoint_depths(x1, x2, R, t):
    """Closed-form two-ray depths (z1, z2) ``[..., N]`` for cheirality
    signs; R ``[..., 3, 3]`` and t ``[..., 3]`` may carry a batch."""
    b = torch.einsum("...ji,nj->...ni", R, x2)
    C2 = -torch.einsum("...ji,...j->...i", R, t)
    aa = torch.sum(x1 * x1, -1)
    bb = torch.sum(b * b, -1)
    ab = torch.sum(x1 * b, -1)
    ac = torch.einsum("ni,...i->...n", x1, C2)
    bc = torch.sum(b * C2[..., None, :], -1)
    det = aa * bb - ab * ab
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    z1 = (bb * ac - ab * bc) / det
    z2 = (ab * ac - aa * bc) / det
    return z1, z2


def reprojection_errors(X, x1, x2, R, t):
    """Squared reprojection error in both normalized image planes."""
    z = X[..., 2]
    z1 = torch.clamp(z.abs(), min=1e-12) * torch.sign(
        torch.where(z == 0, torch.ones_like(z), z))
    p1 = X[..., :2] / z1[..., None]
    Xc = torch.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
    zc = Xc[..., 2]
    z2 = torch.where(zc.abs() < 1e-12, torch.full_like(zc, 1e-12), zc)
    p2 = Xc[..., :2] / z2[..., None]
    e1 = torch.sum((p1 - x1[..., :2] / x1[..., 2:3]) ** 2, dim=-1)
    e2 = torch.sum((p2 - x2[..., :2] / x2[..., 2:3]) ** 2, dim=-1)
    return e1 + e2


@f32_matmul
def triangulate_tracks(R, t, cam_idx, pt_idx, uv_n, mask, n_points: int):
    """Multiview linear triangulation over a flat observation list.

    Each observation adds the two cross-product rows of
    x_h x (R X + t) = 0 to its point's 3x3 normal system (segment sums
    by ``index_add_``); one batched solve covers every point.

    Args: R, t ``[M, 3, 3]`` / ``[M, 3]`` world -> camera poses;
    cam_idx, pt_idx ``[O]`` incidence; uv_n ``[O, 2]`` normalized
    coordinates; mask ``[O]``; n_points the point capacity P.

    Returns (X [P, 3], ok [P]); ok needs >= 2 masked observations and a
    finite solve.
    """
    Rj = R[cam_idx]
    tj = t[cam_idx]
    u, v = uv_n[:, 0:1], uv_n[:, 1:2]
    Ar = torch.stack([u * Rj[:, 2] - Rj[:, 0], v * Rj[:, 2] - Rj[:, 1]], dim=1)
    br = torch.stack([u[:, 0] * tj[:, 2] - tj[:, 0],
                      v[:, 0] * tj[:, 2] - tj[:, 1]], dim=1)
    m = mask.to(uv_n.dtype)
    Ar = Ar * m[:, None, None]
    br = br * m[:, None]
    dt, dev = uv_n.dtype, uv_n.device
    AtA = torch.zeros((n_points, 3, 3), dtype=dt, device=dev).index_add_(
        0, pt_idx, torch.einsum("oki,okj->oij", Ar, Ar))
    Atb = torch.zeros((n_points, 3), dtype=dt, device=dev).index_add_(
        0, pt_idx, torch.einsum("oki,ok->oi", Ar, -br))
    nobs = torch.zeros((n_points,), dtype=dt, device=dev).index_add_(0, pt_idx, m)
    X = torch.linalg.solve_ex(AtA + 1e-6 * torch.eye(3, dtype=dt, device=dev),
                              Atb[:, :, None])[0][:, :, 0]
    ok = (nobs >= 2) & torch.isfinite(X).all(dim=1)
    return torch.where(ok[:, None], X, torch.zeros_like(X)), ok
