"""Frozen copy of the port's plain K6 (``sfm_tpu_torch/ops/match.py``): the
running top-2 correlation in plain PyTorch, bf16 products with f32
accumulation or f32.  Under ``precision.control()`` the bf16 products
round their operands to fp8 (e4m3) instead: the benchmark's control.
"""

from __future__ import annotations

import torch

from portbench.reference.sfm.utils.precision import lower_precision

_NEG = -2.0  # correlations of unit vectors live in [-1, 1]


def match_top2_plain(desc1, desc2, valid2=None, *, bf16: bool = True,
                     chunk: int = 1024):
    """Plain PyTorch running top-2: (best [N1], second [N1], index [N1]).

    With ``bf16`` the descriptors are rounded to bf16 first (fp8 under
    the control) and the products accumulate in f32, as in the kernel.
    """
    n2 = desc2.shape[0]
    if valid2 is None:
        valid2 = torch.ones(n2, dtype=torch.bool, device=desc2.device)
    if bf16:
        low = torch.float8_e4m3fn if lower_precision() else torch.bfloat16
        desc1 = desc1.to(low)
        desc2 = desc2.to(low)
    d1 = desc1.to(torch.float32)
    d2 = desc2.to(torch.float32)
    penalty = (valid2.to(torch.float32) - 1.0) * 1e3
    bests, seconds, idxs = [], [], []
    for r in range(0, d1.shape[0], chunk):
        s = d1[r:r + chunk] @ d2.T + penalty[None, :]
        s = torch.clamp(s, min=_NEG)  # the running values start at -2
        best, idx = torch.max(s, dim=1)
        masked = s.scatter(1, idx[:, None], _NEG)
        bests.append(best)
        seconds.append(masked.max(dim=1).values)
        idxs.append(idx.to(torch.int32))
    if not bests:
        z = torch.zeros(0, device=d1.device)
        return z, z.clone(), z.to(torch.int32)
    return torch.cat(bests), torch.cat(seconds), torch.cat(idxs)


match_top2 = match_top2_plain
