"""Pose recovery from an essential matrix (counterpart of
``sfm_tpu/geometry/pose.py``: ``pose_candidates``, ``align_candidates``,
``recover_pose`` and the translation re-vote ``cheirality_t_vote``).

:func:`recover_pose` sends float32 CUDA inputs to K12
(``csrc/pose.cu``): the Jacobi SVD of E, the four branches, every row's
Jacobi DLT under every branch, the vote and its first maximum in one
launch that never waits on the host.  Everything else (CPU tensors,
float64) takes :func:`recover_pose_plain`, ~4.2k PyTorch launches and 7
host syncs a call on the card; it is also the kernel's yardstick.  The
kernel rounds each operation as the plain route does, so the two differ
only where cuBLAS's small products and PyTorch's reductions sum in
another order than the kernel's (``csrc/linalg.cuh``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from sfm_tpu_torch.ops import _cuda, linalg
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
def align_candidates(E, R_ref, t_ref, *, sweeps: int = 8):
    """The candidate (R, t) of E [3, 3] closest to a reference pose: the
    argmax of trace(R_c R_ref^T) + t_c . t_ref, chosen on the device
    (no host read)."""
    Rs, ts = pose_candidates(E, sweeps=sweeps)
    best = torch.argmax(torch.einsum("cij,ij->c", Rs, R_ref) + ts @ t_ref)[None]
    return Rs.index_select(0, best)[0], ts.index_select(0, best)[0]


def recover_pose(E, x1, x2, weights=None, *, sweeps: int = 8):
    """Cheirality-correct (R, t) among the four candidates of E [3, 3].

    Triangulates every correspondence against all four candidates and
    takes the argmax of the (weighted) positive-depth vote.  Returns a
    dict with R, t, index, votes [4], points [N, 3], front [N] and
    finite [N] of the winner.  K12 for float32 CUDA inputs,
    :func:`recover_pose_plain` for the rest.
    """
    if x1.is_cuda and x1.dtype == torch.float32:
        return _recover_pose_kernel(E, x1, x2, weights, sweeps)
    return recover_pose_plain(E, x1, x2, weights, sweeps=sweeps)


def _recover_pose_kernel(E, x1, x2, weights, sweeps):
    """K12 on the current stream; allocates its outputs, does not wait."""
    dev = x1.device
    n = x1.shape[0]
    E, x1, x2 = (v.contiguous() for v in (E, x1, x2))
    _cuda.require(E, "E", torch.float32, (3, 3), dev)
    _cuda.require(x1, "x1", torch.float32, (n, 3), dev)
    _cuda.require(x2, "x2", torch.float32, (n, 3), dev)
    if weights is not None:
        weights = weights.to(torch.float32).contiguous()
        _cuda.require(weights, "weights", torch.float32, (n,), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    out = {"R": torch.empty((3, 3), **f32), "t": torch.empty(3, **f32),
           "index": torch.empty((), dtype=torch.int64, device=dev),
           "votes": torch.empty(4, **f32), "points": torch.empty((n, 3), **f32),
           "front": torch.empty(n, dtype=torch.bool, device=dev),
           "finite": torch.empty(n, dtype=torch.bool, device=dev)}
    code = _cuda.library().lib.sfm_recover_pose(
        E.data_ptr(), x1.data_ptr(), x2.data_ptr(),
        0 if weights is None else weights.data_ptr(), n, max(sweeps, 0),
        *(v.data_ptr() for v in out.values()), _cuda.stream_ptr(dev))
    _cuda.check(code, "recover_pose")
    _cuda.launched("recover_pose")
    return out


@f32_matmul
def recover_pose_plain(E, x1, x2, weights=None, *, sweeps: int = 8):
    """:func:`recover_pose` in PyTorch, any device and dtype: the Jacobi
    ``svd3x3`` of E, then ``triangulate``'s Jacobi DLT of every row
    against the four candidates as one [4, N] batch."""
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


@functools.lru_cache(maxsize=4)
def _fibonacci_sphere(m: int) -> np.ndarray:
    """[m, 3] float32 near-uniform unit directions (golden-angle spiral)."""
    i = np.arange(m) + 0.5
    phi = np.pi * (1.0 + 5.0 ** 0.5) * i
    z = 1.0 - 2.0 * i / m
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    dirs = np.stack([r * np.cos(phi), r * np.sin(phi), z], -1).astype(np.float32)
    dirs.flags.writeable = False   # cached: shared by every caller
    return dirs


@f32_matmul
def cheirality_t_vote(R, x1, x2, mask, threshold, *, n_dirs: int = 1024):
    """Max-cheirality translation direction for a fixed rotation.

    On rotation-dominant pairs the Sampson objective is nearly flat in
    the translation direction, and local refinement can stop in a valley
    whose pose puts many inliers behind a camera; this searches the
    direction globally instead.  For fixed R the midpoint depths
    (``triangulate.midpoint_depths``) are linear in C2 = -R^T t, so
    cheirality over a Fibonacci bank of ``n_dirs`` directions is two
    [N, 3] x [3, M] products, and the epipolar term batches through
    ``epipolar_residuals``.

    R [3, 3]; x1, x2 [N, 3] normalized homogeneous correspondences (a
    compacted inlier subset is fine); mask [N] bool rows to count;
    threshold the epipolar residual gate.  Returns a dict with t [3]
    (the winning direction: the lowest index among equal scores, as
    ``jnp.argmax`` takes it), E [3, 3] (= [t]_x R, ||E|| = sqrt(2)),
    score (int32 count) and ok [N] bool (the winner's support).
    """
    from sfm_tpu_torch.geometry import epipolar

    ts = torch.tensor(_fibonacci_sphere(n_dirs), device=R.device)      # [M, 3]
    b = torch.einsum("ji,nj->ni", R, x2)
    aa = torch.sum(x1 * x1, -1)
    bb = torch.sum(b * b, -1)
    ab = torch.sum(x1 * b, -1)
    det = aa * bb - ab * ab
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    A = (bb[:, None] * x1 - ab[:, None] * b) / det[:, None]
    B = (ab[:, None] * x1 - aa[:, None] * b) / det[:, None]
    C2s = -(ts @ R)                                        # [M, 3]
    z1 = A @ C2s.T                                         # [N, M]
    z2 = B @ C2s.T
    Es = linalg.cross_matrix(ts) @ R                       # [M, 3, 3]
    Es = Es * (math.sqrt(2.0)
               / torch.linalg.vector_norm(Es, dim=(1, 2), keepdim=True))
    res = epipolar.epipolar_residuals(Es, x1, x2)          # [M, N]
    ok = (res.T < threshold) & mask[:, None] & (z1 > 0) & (z2 > 0)
    score = ok.sum(0)                                      # [M]
    iota = torch.arange(score.shape[0], device=score.device)
    m = torch.where(score == score.max(), iota, score.shape[0]).min()
    return {"t": ts[m], "E": Es[m], "score": score[m].to(torch.int32),
            "ok": ok[:, m]}
