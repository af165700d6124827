"""Stable mask compaction (counterpart of ``sfm_tpu/ops/compact.py``)."""

from __future__ import annotations

import torch


def compaction_order(valid: torch.Tensor) -> torch.Tensor:
    """Stable permutation putting True entries first.

    ``order[j]`` is the index of the element that lands at position j.
    Both groups keep their input order (two cumsums and a scatter, no
    sort), so the result equals ``argsort(~valid, stable=True)`` on
    every device.
    """
    k = valid.shape[0]
    v = valid.to(torch.int64)
    pos_valid = torch.cumsum(v, 0) - 1
    pos_invalid = v.sum() + torch.cumsum(1 - v, 0) - 1
    pos = torch.where(valid, pos_valid, pos_invalid)
    order = torch.empty(k, dtype=torch.int64, device=valid.device)
    order[pos] = torch.arange(k, device=valid.device)
    return order


def stable_topk_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries, ties to the lowest index.

    ``jax.lax.top_k`` breaks ties toward the lower index while
    ``torch.topk`` promises no order on CUDA; inlier counts tie often,
    so every selection whose result feeds later stages sorts on
    (-score, index) instead.
    """
    return torch.sort(scores, descending=True, stable=True).indices[:k]
