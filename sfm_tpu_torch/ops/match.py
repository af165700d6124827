"""K6: fused brute-force descriptor matcher with running top-2.

Replaces the TPU kernel ``sfm_tpu/ops/pallas_match.py:247
match_top2_pallas`` (``lanes_pair`` variant).  Contract: for each row of
``desc1`` [N1, 128], the best correlation against ``desc2`` [N2, 128],
the second best over every OTHER column, and the argmax column (lowest
index on ties).  Invalid columns score ``s + (v - 1) * 1e3`` and the
running values start at -2, so an invalid column can never win; the
score matrix is never written to device memory.

CUDA kernel (``csrc/match.cu``): each block keeps a 32-row tile of
desc1 in shared memory and streams desc2 in 64-column tiles (128
dimensions in four 32-wide slices); every thread holds a 2x4 block of
dot products in registers, computed with f32 FMAs from bf16 (or f32)
loads, then folds them into per-row running (best, second, index)
registers.  The 16 partial top-2s of a row are merged in shared memory
inside the same block, so no reduction crosses blocks.  Bound on the
card: the 5120 x 5120 x 128 main-path problem is 6.7 GFLOP against
2.6 MB of operands — compute bound; f32 FMAs from shared memory leave
the tensor cores idle (``mma.sync``/``wgmma`` is later work).

Plain version: the same contract in PyTorch over row chunks (the full
score block per chunk, then max / masked max), used for CPU tensors.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.ops import _cuda

_NEG = -2.0  # correlations of unit vectors live in [-1, 1]


def match_top2_plain(desc1, desc2, valid2=None, *, bf16: bool = True,
                     chunk: int = 1024):
    """Plain PyTorch running top-2: (best [N1], second [N1], index [N1]).

    With ``bf16`` the descriptors are rounded to bf16 first and the
    products accumulate in f32, as in the kernel.
    """
    n2 = desc2.shape[0]
    if valid2 is None:
        valid2 = torch.ones(n2, dtype=torch.bool, device=desc2.device)
    if bf16:
        desc1 = desc1.to(torch.bfloat16)
        desc2 = desc2.to(torch.bfloat16)
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


def match_top2(desc1, desc2, valid2=None, *, bf16: bool = True):
    """Running top-2 correlation: CUDA kernel for CUDA tensors, plain
    PyTorch for CPU tensors.  Returns (best, second, index int32)."""
    if not desc1.is_cuda:
        return match_top2_plain(desc1, desc2, valid2, bf16=bf16)
    dev = desc1.device
    n1, d = desc1.shape
    n2 = desc2.shape[0]
    if d != 128 or desc2.shape[1] != 128:
        raise ValueError("match_top2 kernel takes 128-D descriptors")
    if valid2 is None:
        valid2 = torch.ones(n2, dtype=torch.bool, device=dev)
    dt = torch.bfloat16 if bf16 else torch.float32
    d1 = desc1.to(dt).contiguous()
    d2 = desc2.to(dt).contiguous()
    v2 = valid2.to(torch.float32).contiguous()
    _cuda.require(d1, "desc1", dt, (n1, 128), dev)
    _cuda.require(d2, "desc2", dt, (n2, 128), dev)
    _cuda.require(v2, "valid2", torch.float32, (n2,), dev)
    best = torch.empty(n1, dtype=torch.float32, device=dev)
    second = torch.empty(n1, dtype=torch.float32, device=dev)
    index = torch.empty(n1, dtype=torch.int32, device=dev)
    if n1 == 0:
        return best, second, index
    lib = _cuda.library().lib
    fn = lib.sfm_match_top2_bf16 if bf16 else lib.sfm_match_top2_f32
    code = fn(d1.data_ptr(), d2.data_ptr(), v2.data_ptr(), n1, n2,
              best.data_ptr(), second.data_ptr(), index.data_ptr(),
              _cuda.stream_ptr(dev))
    _cuda.check(code, "match_top2")
    _cuda.LAUNCHES["match_top2"] += 1
    return best, second, index
