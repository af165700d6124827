"""Vectorized 8-point RANSAC over a hypothesis bank (counterpart of
``sfm_tpu/geometry/ransac.py``).

The draws come from an explicit ``torch.Generator`` instead of a JAX
key; the two streams differ, so ``ransac_essential`` also accepts the
minimal sets ``[R, 8]`` directly — the parity tests inject the JAX
package's ``sample_minimal_sets`` output there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.ops import linalg
from sfm_tpu_torch.ops.compact import compaction_order, stable_topk_indices
from sfm_tpu_torch.geometry import epipolar
from sfm_tpu_torch.utils import timing
from sfm_tpu_torch.utils.precision import f32_matmul


class RansacResult(NamedTuple):
    E: torch.Tensor           # [3, 3] best essential matrix
    inliers: torch.Tensor     # [N] bool
    num_inliers: torch.Tensor
    best_index: torch.Tensor  # index into the bank
    counts: torch.Tensor      # [R] per-hypothesis inlier counts
    topk_E: torch.Tensor      # [K, 3, 3] top-K bank draws by count


def sample_minimal_sets(generator, mask, n_hyps: int, k: int = 8):
    """[n_hyps, k] DISTINCT indices of valid correspondences.

    Valid indices are compacted to the front (stable) and k distinct
    positions among the first n_valid are drawn per hypothesis with
    Floyd's algorithm (k fixed iterations, vectorized over the bank).
    """
    dev = mask.device
    order = compaction_order(mask)
    n_valid = torch.clamp(mask.sum(), min=k)
    sel = torch.zeros((n_hyps, k), dtype=torch.int64, device=dev)
    for m in range(k):
        j = n_valid - k + m                       # draw t uniform in [0, j]
        u = torch.rand(n_hyps, generator=generator, device=dev,
                       dtype=torch.float64)
        t = torch.minimum(torch.floor(u * (j + 1)).to(torch.int64), j)
        if m:
            dup = torch.any(sel[:, :m] == t[:, None], dim=1)
            t = torch.where(dup, j, t)
        sel[:, m] = t
    return order[sel]


@f32_matmul
def build_hypothesis_bank(x1, x2, mask, *, n_hyps: int, sweeps: int = 10,
                          generator=None, minimal_sets=None):
    """Draw (or take) the minimal sets and solve the whole 8-point bank.

    Returns (E_bank [R, 3, 3], idx [R, 8], T1, T2).
    """
    T1 = epipolar.normalizing_transform(x1, mask)
    T2 = epipolar.normalizing_transform(x2, mask)
    x1n = x1 @ T1.T
    x2n = x2 @ T2.T
    if minimal_sets is None:
        idx = sample_minimal_sets(generator, mask, n_hyps)
    else:
        idx = minimal_sets.to(device=x1.device, dtype=torch.int64)
    A = epipolar.eight_point_matrix(x1n[idx], x2n[idx])
    e = linalg.qr_nullvec(A)
    E_bank = linalg.project_to_essential(
        epipolar.denormalize_E(e.reshape(-1, 3, 3), T1, T2), sweeps=sweeps)
    return E_bank, idx, T1, T2


@f32_matmul
def ransac_essential(x1, x2, mask=None, *, generator=None, minimal_sets=None,
                     n_hyps: int = 2048, threshold: float = 1e-6,
                     chunk: int = 256, sweeps: int = 10, refit_iters: int = 2,
                     topk: int = 16) -> RansacResult:
    """Estimate E from [N, 3] normalized correspondences.

    Exactly one of ``generator`` (a ``torch.Generator`` on the data's
    device) and ``minimal_sets`` ([n_hyps, 8] indices) must be given.
    """
    if (generator is None) == (minimal_sets is None):
        raise ValueError("ransac_essential needs exactly one of generator "
                         "and minimal_sets")
    n = x1.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=x1.device)
    with timing.span("geometry.bank"):
        E_bank, _, T1, T2 = build_hypothesis_bank(
            x1, x2, mask, n_hyps=n_hyps, sweeps=sweeps, generator=generator,
            minimal_sets=minimal_sets)
    with timing.span("geometry.score"):
        counts = torch.cat([
            torch.sum((epipolar.epipolar_residuals(E_bank[c:c + chunk], x1, x2)
                       < threshold) & mask[None, :], dim=-1)
            for c in range(0, n_hyps, chunk)
        ])
        best = torch.argmax(counts)
        E = E_bank[best]

    with timing.span("geometry.refit"):
        x1n = x1 @ T1.T
        x2n = x2 @ T2.T
        A_all = epipolar.eight_point_matrix(x1n, x2n)            # [N, 9]
        r = epipolar.epipolar_residuals(E, x1, x2)
        for _ in range(refit_iters):
            w = ((r < threshold) & mask).to(x1.dtype)
            G = (A_all * w[:, None]).T @ A_all
            e = linalg.smallest_eigvec_power(G)
            E_new = linalg.project_to_essential(
                epipolar.denormalize_E(e.reshape(3, 3), T1, T2), sweeps=sweeps)
            c_old = w.sum()
            r_new = epipolar.epipolar_residuals(E_new, x1, x2)
            c_new = ((r_new < threshold) & mask).sum()
            take = c_new >= c_old
            E = torch.where(take, E_new, E)
            r = torch.where(take, r_new, r)

        inl = (r < threshold) & mask
        top_idx = stable_topk_indices(counts, max(min(topk, n_hyps), 1))
    return RansacResult(E=E, inliers=inl, num_inliers=inl.sum(),
                        best_index=best, counts=counts, topk_E=E_bank[top_idx])
