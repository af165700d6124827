"""Pose recovery from an essential matrix (counterpart of
``sfm_tpu/geometry/pose.py``: ``pose_candidates`` and ``recover_pose``)."""

from __future__ import annotations

import torch

from sfm_tpu_torch.ops import linalg
from sfm_tpu_torch.geometry import triangulate as tri
from sfm_tpu_torch.utils.precision import f32_matmul

# W = Rz(+90 deg), the twist of the E = [t]_x R factorization.
_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


@f32_matmul
def pose_candidates(E, *, sweeps: int = 8):
    """Four candidate (R, t) of E: (Rs [..., 4, 3, 3], ts [..., 4, 3])."""
    U, _, V = linalg.svd3x3(E, sweeps=sweeps)
    flip_u = torch.where(linalg.det3(U) < 0, -1.0, 1.0).to(E.dtype)
    flip_v = torch.where(linalg.det3(V) < 0, -1.0, 1.0).to(E.dtype)
    U = U.clone()
    V = V.clone()
    U[..., :, 2] = U[..., :, 2] * flip_u[..., None]
    V[..., :, 2] = V[..., :, 2] * flip_v[..., None]
    W = torch.tensor(_W, dtype=E.dtype, device=E.device)
    R1 = torch.einsum("...ik,kl,...jl->...ij", U, W, V)
    R2 = torch.einsum("...ik,lk,...jl->...ij", U, W, V)
    u3 = U[..., :, 2]
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)
    ts = torch.stack([u3, -u3, u3, -u3], dim=-2)
    return Rs, ts


@f32_matmul
def recover_pose(E, x1, x2, weights=None, *, sweeps: int = 8):
    """Cheirality-correct (R, t) among the four candidates of E [3, 3].

    Triangulates every correspondence against all four candidates and
    takes the argmax of the (weighted) positive-depth vote.  Returns a
    dict with R, t, index, votes [4], points [N, 3], front [N] and
    finite [N] of the winner.
    """
    Rs, ts = pose_candidates(E, sweeps=sweeps)
    eye = torch.eye(3, dtype=E.dtype, device=E.device).expand(Rs.shape)
    P1 = tri.make_projection(eye, torch.zeros_like(ts))
    P2 = tri.make_projection(Rs, ts)
    X, _, finite = tri.triangulate(x1[None], x2[None], P1, P2, sweeps=sweeps)
    z1 = X[..., 2]
    z2 = tri.depths(X, Rs, ts)
    good = (z1 > 0) & (z2 > 0)
    if weights is None:
        votes = torch.sum(good, dim=-1).to(torch.float32)
    else:
        votes = torch.sum(good * weights[None, :], dim=-1)
    best = torch.argmax(votes)
    return {
        "R": Rs[best],
        "t": ts[best],
        "index": best,
        "votes": votes,
        "points": X[best],
        "front": good[best],
        "finite": finite[best],
    }
