"""Vectorized 4-point homography RANSAC and the all-inlier polish
(counterpart of ``sfm_tpu/geometry/homography.py``).

The hypothesis bank is one batched QR null-space solve of the 8 x 9 DLT
systems of Hartley-normalized minimal sets, scored against every
correspondence by forward transfer error.  The draws come from an
explicit ``torch.Generator``; the JAX and torch random streams differ,
so ``ransac_homography`` also takes the minimal sets ``[R, 4]``
directly (the parity tests inject the JAX package's
``sample_minimal_sets`` draw there).  The JAX ``lax.scan`` loops are
Python loops here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.geometry import epipolar
from sfm_tpu_torch.geometry.ransac import sample_minimal_sets
from sfm_tpu_torch.ops import linalg
from sfm_tpu_torch.utils.precision import f32_matmul

_CHUNK = 512  # hypotheses scored at a time ([chunk, N, 3] intermediates)


class HomographyResult(NamedTuple):
    H: torch.Tensor            # [3, 3], H[2, 2] = 1
    inliers: torch.Tensor      # [N] bool
    num_inliers: torch.Tensor


def homography_system(uv1, uv2):
    """[..., N, 2, 9] DLT rows for uv2 ~ H uv1 (inhomogeneous pairs)."""
    x, y = uv1[..., 0], uv1[..., 1]
    u, v = uv2[..., 0], uv2[..., 1]
    one = torch.ones_like(x)
    zero = torch.zeros_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -u * x, -u * y, -u], dim=-1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -v * x, -v * y, -v], dim=-1)
    return torch.stack([r1, r2], dim=-2)


@f32_matmul
def transfer_errors(H, uv1, uv2):
    """[..., N] squared forward transfer error of uv1 -> uv2 under each
    H in ``[..., 3, 3]``."""
    x = torch.cat([uv1, torch.ones_like(uv1[..., :1])], dim=-1)
    p = torch.einsum("...ij,nj->...ni", H, x)
    w = torch.where(p[..., 2].abs() < 1e-12, torch.full_like(p[..., 2], 1e-12),
                    p[..., 2])
    pred = p[..., :2] / w[..., None]
    return torch.sum((pred - uv2) ** 2, dim=-1)


def _normalized(uv1, uv2, mask):
    """Hartley transforms and the normalized inhomogeneous points."""
    ones = torch.ones_like(uv1[:, :1])
    h1 = torch.cat([uv1, ones], dim=-1)
    h2 = torch.cat([uv2, ones], dim=-1)
    T1 = epipolar.normalizing_transform(h1, mask)
    T2 = epipolar.normalizing_transform(h2, mask)
    return T1, T2, (h1 @ T1.T)[:, :2], (h2 @ T2.T)[:, :2]


def _lsq_refit(A_all, gate, T1, T2inv):
    """Weighted DLT refit over the gated rows, denormalized."""
    w = torch.repeat_interleave(gate.to(A_all.dtype), 2)
    G = (A_all * w[:, None]).T @ A_all
    hv = linalg.smallest_eigvec_power(G)
    return T2inv @ hv.reshape(3, 3) @ T1


def _unit_h22(H):
    h = H[2, 2]
    return H / torch.where(h.abs() < 1e-12, torch.full_like(h, 1e-12), h)


@f32_matmul
def ransac_homography(uv1, uv2, mask=None, *, generator=None,
                      minimal_sets=None, n_hyps: int = 1024,
                      threshold: float = 9.0,
                      refit_iters: int = 2) -> HomographyResult:
    """Robust homography from [N, 2] pixel correspondences.

    Exactly one of ``generator`` (a ``torch.Generator`` on the data's
    device) and ``minimal_sets`` ([n_hyps, 4] indices) must be given.
    ``threshold`` is in px^2.
    """
    if (generator is None) == (minimal_sets is None):
        raise ValueError("ransac_homography needs exactly one of generator "
                         "and minimal_sets")
    n = uv1.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=uv1.device)
    T1, T2, n1, n2 = _normalized(uv1, uv2, mask)
    if minimal_sets is None:
        idx = sample_minimal_sets(generator, mask, n_hyps, k=4)
    else:
        idx = minimal_sets.to(device=uv1.device, dtype=torch.int64)
    n_hyps = idx.shape[0]

    A = homography_system(n1[idx], n2[idx]).reshape(n_hyps, 8, 9)
    Hn = linalg.qr_nullvec(A).reshape(n_hyps, 3, 3)
    T2inv = torch.linalg.inv(T2)
    H_bank = torch.einsum("ij,njk,kl->nil", T2inv, Hn, T1)

    counts = torch.cat([
        torch.sum((transfer_errors(H_bank[c:c + _CHUNK], uv1, uv2) < threshold)
                  & mask[None, :], dim=-1)
        for c in range(0, n_hyps, _CHUNK)
    ])
    H = H_bank[torch.argmax(counts)]

    A_all = homography_system(n1, n2).reshape(-1, 9)   # [2N, 9]
    for _ in range(refit_iters):
        gate = (transfer_errors(H, uv1, uv2) < threshold) & mask
        H_new = _lsq_refit(A_all, gate, T1, T2inv)
        c_new = ((transfer_errors(H_new, uv1, uv2) < threshold) & mask).sum()
        H = torch.where(c_new >= gate.sum(), H_new, H)

    inl = (transfer_errors(H, uv1, uv2) < threshold) & mask
    return HomographyResult(H=_unit_h22(H), inliers=inl, num_inliers=inl.sum())


@f32_matmul
def improve_homography(H, uv1, uv2, mask, *, loops: int = 5,
                       threshold: float = 9.0):
    """The reference's ImproveHomography: ``loops`` rounds of a
    hard-gated (err < threshold px^2) weighted DLT refit over the
    ``mask`` candidates, each applied unconditionally, except that a
    round which gates fewer than 4 points (no refit to take) keeps the
    previous H, where the reference's refit degenerates (NaN in the JAX
    package).  Returns H with H[2, 2] = 1."""
    T1, T2, n1, n2 = _normalized(uv1, uv2, mask)
    T2inv = torch.linalg.inv(T2)
    A_all = homography_system(n1, n2).reshape(-1, 9)
    for _ in range(loops):
        gate = (transfer_errors(H, uv1, uv2) < threshold) & mask
        H = torch.where(gate.sum() >= 4, _lsq_refit(A_all, gate, T1, T2inv), H)
    return _unit_h22(H)
