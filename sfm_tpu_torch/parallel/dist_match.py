"""Pairwise descriptor matching with the right set sharded over the mesh
(counterpart of ``sfm_tpu/parallel/dist_match.py``).

Every rank holds the left set and its own contiguous block of the right
set's rows, and runs the running top-2 on that block: K6
(``ops/match.match_top2``) for CUDA tensors, its plain version for CPU
tensors.  The ranks exchange their [N1] candidates in one
``all_gather`` and merge them as the JAX package does, without a sort:
the global best, the lowest rank on ties (which is the lowest global
index, the blocks being contiguous), and as second the larger of the
winner's own second and every other rank's best.  O(D * N1) values
cross the ranks against O(N1 * N2 / D) products on each.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.config import MatchConfig
from sfm_tpu_torch.ops.match import match_top2
from sfm_tpu_torch.parallel.mesh import Mesh, put_sharded
from sfm_tpu_torch.sift.match import Matches, ratio_test

_NEG = -2.0  # the running values' start (ops/match.py)


def dist_match_top2(desc1, desc2_sh, valid2_sh, mesh: Mesh, *,
                    use_pallas: bool | None = None, bf16: bool = True):
    """Top-2 matching of ``desc1`` [N1, 128] (replicated) against the
    rank's block ``desc2_sh`` [N2 / D, 128] of the right set, with its
    validity ``valid2_sh``.  Returns (best, second, index int32) over
    the whole right set, with global indices, on every rank.
    ``use_pallas=False`` runs the f32 top-2 on each block whatever
    ``bf16`` says, as the JAX package does."""
    n2_loc = desc2_sh.shape[0]
    best, second, idx = match_top2(desc1, desc2_sh, valid2_sh,
                                   bf16=bf16 and use_pallas is not False)
    # One gather of [N1, 3] float64, which holds the f32 scores and the
    # indices (< 2^53) exactly.
    gidx = idx.to(torch.int64) + mesh.rank * n2_loc
    cands = mesh.all_gather(torch.stack([best.double(), second.double(),
                                         gidx.double()], dim=-1))   # [D, N1, 3]
    b, s, ix = cands[..., 0], cands[..., 1], cands[..., 2]
    d = b.shape[0]
    diota = torch.arange(d, device=b.device)[:, None]
    g_best = b.max(dim=0).values
    garg = torch.where(b == g_best[None], diota, d).min(dim=0).values
    at = diota == garg[None]
    neg = torch.full_like(b, _NEG)
    # Exact: each rank's (best, second) is its block's true top-2.
    runner = torch.where(at, neg, b).max(dim=0).values
    sec_at = torch.where(at, s, neg).max(dim=0).values
    g_second = torch.maximum(runner, sec_at)
    g_idx = torch.where(at, ix, -1.0).max(dim=0).values
    return g_best.float(), g_second.float(), g_idx.to(torch.int32)


def dist_match(desc1, desc2, valid1=None, valid2=None,
               cfg: MatchConfig = MatchConfig(), *, mesh: Mesh) -> Matches:
    """``sift.match.match`` with the right set sharded over the mesh: the
    same ``Matches`` (ratio test, score threshold) from the full
    ``desc2`` that every rank holds.  N2 must divide by the mesh size,
    as the frontend's keypoint capacities do.  ``cfg.mutual`` is not
    offered (the JAX package's ``dist_match`` has no cross-check)."""
    if cfg.mutual:
        raise NotImplementedError("dist_match: mutual=True (no cross-check on a mesh)")
    dev = desc1.device
    if valid1 is None:
        valid1 = torch.ones(desc1.shape[0], dtype=torch.bool, device=dev)
    if valid2 is None:
        valid2 = torch.ones(desc2.shape[0], dtype=torch.bool, device=dev)
    top2 = dist_match_top2(desc1, put_sharded(mesh, desc2), put_sharded(mesh, valid2),
                           mesh, use_pallas=cfg.use_pallas, bf16=cfg.bf16)
    return ratio_test(*top2, valid1, cfg)
