"""Brute-force descriptor matching with top-2 ratio test (counterpart of
``sfm_tpu/sift/match.py``).  The top-2 search is K6
(``sfm_tpu_torch/ops/match.py``); ``MatchConfig.use_pallas`` is a TPU
dispatch knob and is resolved here from the tensors' device."""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.config import MatchConfig
from sfm_tpu_torch.ops.match import match_top2


class Matches(NamedTuple):
    index: torch.Tensor      # [N1] best match in set 2
    score: torch.Tensor      # [N1] best correlation
    ambiguity: torch.Tensor  # [N1] second_best / best
    valid: torch.Tensor      # [N1] passes masks + thresholds


def match(desc1, desc2, valid1=None, valid2=None,
          cfg: MatchConfig = MatchConfig()) -> Matches:
    """Match [N1, 128] against [N2, 128]: argmax correlation, ratio
    ``second / (best + 1e-6) < max_ambiguity`` and optional cross-check."""
    n1 = desc1.shape[0]
    if valid1 is None:
        valid1 = torch.ones(n1, dtype=torch.bool, device=desc1.device)
    best, second, idx = match_top2(desc1, desc2, valid2, bf16=cfg.bf16)
    idx = idx.to(torch.int64)
    ambiguity = second / (best + 1e-6)
    ok = valid1 & (best > cfg.min_score) & (ambiguity < cfg.max_ambiguity)
    if cfg.mutual:
        _, _, ridx = match_top2(desc2, desc1, valid1, bf16=cfg.bf16)
        ok = ok & (ridx.to(torch.int64)[idx]
                   == torch.arange(n1, device=desc1.device))
    return Matches(index=idx, score=best, ambiguity=ambiguity, valid=ok)
