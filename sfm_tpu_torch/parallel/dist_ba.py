"""Distributed bundle adjustment: point-partitioned Schur reduction
(counterpart of ``sfm_tpu/parallel/dist_ba.py``).

The map's points, each with all of its observations, are split into
contiguous blocks, one per rank; the cameras are replicated.  Each rank
assembles its part of the normal equations and the camera-side sums
cross the ranks (``Mesh.all_reduce``):

* solver="cg" (default): matrix-free Schur CG, one [M, 6] reduction per
  matvec, so the traffic per LM iteration is O(M * 6 * cg_iters),
  independent of the point count and of M^2;
* solver="dense": the exact [6M, 6M] solve, replicated, after one
  [M, 6, M, 6] reduction per LM iteration (small rigs, parity tests).

The point updates stay on their rank.  The LM loop is
``models.bundle_adjust.run_ba``'s with its ``all_reduce`` hook: the cost
is summed over the ranks before the accept test, so every rank takes the
same decision on the same value, on the device (``torch.where``).
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.models import bundle_adjust as ba
from sfm_tpu_torch.models.bundle_adjust import BAProblem
from sfm_tpu_torch.parallel.mesh import Mesh


def partition_problem(problem: BAProblem, X, n_shards: int,
                      return_layout: bool = False):
    """Partition the points (and their observations) into ``n_shards``
    contiguous blocks of ceil(P / D) rows, both padded to equal sizes:
    the JAX package's layout, array for array.

    Returns (X_sh [D * Ps, 3], prob_sh: a BAProblem of [D * Os]
    observation slots with LOCAL point indices, the masked observations
    of each block first in their original order).  With
    ``return_layout`` also obs_idx [D * Os], the original observation of
    each slot (-1: padding), so that a caller who only shrinks the mask
    (outlier pruning between global-BA rounds) rebuilds prob_sh's mask
    as ``mask[obs_idx]`` instead of partitioning again.  The blocks'
    observation counts, which set Os, are read back to the host.
    """
    cam_idx, pt_idx, uv, mask = problem.cam_idx, problem.pt_idx, problem.uv, problem.mask
    dev = pt_idx.device
    n_pts = X.shape[0]
    ps = -(-n_pts // n_shards)                  # points per shard (padded)
    inside = mask & (pt_idx >= 0) & (pt_idx < n_pts)
    shard = torch.where(inside, pt_idx // ps, n_shards)   # n_shards: no block
    counts = torch.bincount(shard, minlength=n_shards + 1)[:n_shards]
    counts_host = counts.cpu()
    os_max = max(1, int(counts_host.max()))
    order = torch.argsort(shard, stable=True)[:int(counts_host.sum())]
    s = shard[order]
    pos = torch.arange(order.shape[0], device=dev) - (torch.cumsum(counts, 0) - counts)[s]
    dest = s * os_max + pos
    slots = n_shards * os_max
    cam_s = torch.zeros(slots, dtype=cam_idx.dtype, device=dev)
    pt_s = torch.zeros(slots, dtype=pt_idx.dtype, device=dev)
    uv_s = torch.zeros((slots, 2), dtype=uv.dtype, device=dev)
    m_s = torch.zeros(slots, dtype=torch.bool, device=dev)
    oi_s = torch.full((slots,), -1, dtype=torch.int64, device=dev)
    cam_s[dest] = cam_idx[order]
    pt_s[dest] = pt_idx[order] - s * ps          # local point index
    uv_s[dest] = uv[order]
    m_s[dest] = True
    oi_s[dest] = order
    prob_sh = BAProblem(cam_idx=cam_s, pt_idx=pt_s, uv=uv_s, mask=m_s,
                        fixed=problem.fixed)
    X_sh = partition_points(X, n_shards)
    return (X_sh, prob_sh, oi_s) if return_layout else (X_sh, prob_sh)


def partition_points(X, n_shards: int):
    """Points in :func:`partition_problem`'s layout (contiguous blocks of
    ceil(P / D) rows, padded at the tail)."""
    n_pts = X.shape[0]
    pad = n_shards * -(-n_pts // n_shards) - n_pts
    return torch.cat([X, X.new_zeros((pad, *X.shape[1:]))]) if pad else X


def unpartition_points(X_sh, n_pts: int):
    """Undo :func:`partition_points`: the layout is X padded at the tail."""
    return X_sh[:n_pts]


def run_dist_ba(R, t, X_sh, prob_sh: BAProblem, mesh: Mesh, *, iters: int = 15,
                huber_delta: float = 3e-3, init_lam: float = 1e-3,
                solver: str = "cg", cg_iters: int = 32):
    """LM bundle adjustment over the mesh.

    R, t: [M, 3, 3], [M, 3], replicated.  X_sh: the rank's block [Ps, 3]
    of the partitioned points; prob_sh: the rank's [Os] observation
    slots (``put_sharded`` of :func:`partition_problem`'s arrays) with
    local point indices and the replicated ``fixed``.  solver: "cg"
    (scalable, default) or "dense" (exact, small M).

    Returns (R, t, the rank's X block, costs [iters + 1]), the costs
    summed over the ranks.
    """
    if solver not in ("cg", "dense"):
        raise ValueError(f"run_dist_ba: unknown solver {solver!r}")
    final, costs = ba.run_ba(R, t, X_sh, prob_sh, iters=iters, huber_delta=huber_delta,
                             init_lam=init_lam, solver=solver, cg_iters=cg_iters,
                             all_reduce=mesh.all_reduce)
    return final.R, final.t, final.X, costs
