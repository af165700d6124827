"""Brute-force descriptor matching with top-2 ratio test (counterpart of
``sfm_tpu/sift/match.py``).  The top-2 search is K6
(``sfm_tpu_torch/ops/match.py``) on the card and its plain version on
the CPU.  ``MatchConfig.use_pallas=False`` selects the JAX package's
XLA route, the f32 top-2 (:func:`match_descriptors_top2`, K6 in its
f32 mode), whatever ``bf16`` says; ``None`` and ``True`` run K6 at
``bf16``."""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.config import MatchConfig
from sfm_tpu_torch.ops.match import match_top2
from sfm_tpu_torch.utils import timing


class Matches(NamedTuple):
    index: torch.Tensor      # [N1] best match in set 2
    score: torch.Tensor      # [N1] best correlation
    ambiguity: torch.Tensor  # [N1] second_best / best
    valid: torch.Tensor      # [N1] passes masks + thresholds


def match_descriptors_top2(desc1, desc2, valid2=None, *, chunk: int = 2048):
    """Running top-2 correlation of [N1, 128] against [N2, 128] in f32:
    (best, second, index int32), lowest index on ties, invalid columns
    of ``valid2`` never chosen.  K6 with ``bf16=False`` for CUDA tensors
    (three TF32 passes over an error-compensated split, x = hi + lo:
    ~2^-21 of each product, within 1e-5 of exact f32), its plain version
    (exact f32) for CPU tensors.
    ``chunk``, the JAX package's column block, does not change the
    result; the kernel and its plain version tile on their own."""
    del chunk
    return match_top2(desc1, desc2, valid2, bf16=False)


def match(desc1, desc2, valid1=None, valid2=None,
          cfg: MatchConfig = MatchConfig()) -> Matches:
    """Match [N1, 128] against [N2, 128]: argmax correlation, ratio
    ``second / (best + 1e-6) < max_ambiguity`` and optional cross-check."""
    with timing.span("match.match"):
        n1 = desc1.shape[0]
        if valid1 is None:
            valid1 = torch.ones(n1, dtype=torch.bool, device=desc1.device)
        bf16 = cfg.bf16 and cfg.use_pallas is not False   # False: the f32 top-2
        with timing.span("match.top2"):
            top2 = match_top2(desc1, desc2, valid2, bf16=bf16)
        with timing.span("match.ratio"):
            m = ratio_test(*top2, valid1, cfg)
        if cfg.mutual:
            with timing.span("match.top2"):
                _, _, ridx = match_top2(desc2, desc1, valid1, bf16=bf16)
            with timing.span("match.ratio"):
                m = m._replace(valid=m.valid & (ridx.to(torch.int64)[m.index]
                                                == torch.arange(n1, device=desc1.device)))
        return m


def ratio_test(best, second, index, valid1, cfg: MatchConfig) -> Matches:
    """The matches of a top-2 search: valid where row 1 is valid, the
    best score passes ``min_score`` and ``second / (best + 1e-6)`` is
    under ``max_ambiguity``."""
    ambiguity = second / (best + 1e-6)
    ok = valid1 & (best > cfg.min_score) & (ambiguity < cfg.max_ambiguity)
    return Matches(index=index.to(torch.int64), score=best, ambiguity=ambiguity,
                   valid=ok)
