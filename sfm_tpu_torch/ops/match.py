"""K6: fused brute-force descriptor matcher with running top-2.

Replaces the TPU kernel ``sfm_tpu/ops/pallas_match.py:247
match_top2_pallas`` (``lanes_pair`` variant).  Contract: for each row of
``desc1`` [N1, 128], the best correlation against ``desc2`` [N2, 128],
the second best over every OTHER column, and the argmax column (lowest
index on ties).  Invalid columns score ``s + (v - 1) * 1e3`` and the
running values start at -2, so an invalid column can never win; the
score matrix is never written to device memory.

What bounds it on the card: 2 * N1 * N2 * 128 operations (6.7 GFLOP
at the bench's 5,120^2, 142 GFLOP at the up-scale's 23,552^2) against
2.6-12 MB of operands, so the tensor cores' rate: in bf16 6.8 us and
0.144 ms at 989 TFLOP/s; f32-accurate, three TF32 passes at 495
TFLOP/s, 0.041 and 0.861 ms (one exact f32 pass on the CUDA cores, at
67 TFLOP/s, would take 0.100 and 2.12).  With K = 128, only 8 bf16
k-steps per output tile, the per-score epilogue (penalty, compare,
running top-2) costs as much as the bf16 products.

CUDA kernel (``csrc/match.cu``), bf16 (the default): the products run
on the tensor cores with ``wgmma`` (m64n64k16, both operands from
shared memory).  A block of two warpgroups keeps a 128-row desc1 tile
resident and streams its column range of desc2 through a 4-stage
``cp.async`` ring of 64-column tiles; each warpgroup folds its 64 x 64
f32 scores per tile into per-row running (best, second, index)
registers in increasing column order, merges the 4 lanes of each row
with shuffles and writes one partial per row.  The grid splits the
columns into ranges (:func:`column_split`: from N1, N2 and the SM
count, so the bench shape fills the card), and a merge pass folds the
partials in range order with the lowest-index tie rule.  The tensor
cores sum the 128 products in another order than the plain version, so
kernel and plain version differ by f32 rounding (~1e-7).

``bf16=False`` keeps f32 accuracy on the tensor cores with an
error-compensated three-pass TF32 product: each element splits as x =
hi + lo, hi = x rounded to TF32 (10 mantissa bits) and lo = x - hi
(exact), itself rounded to TF32, and a score is lo1.hi2 + hi1.lo2 +
hi1.hi2 (``wgmma`` m64n64k8 TF32, the small terms first, f32
accumulation).  The dropped lo1.lo2 and lo's rounding leave ~2^-21 of
each product, under 1e-6 of a unit-descriptor score; the kernel is held
to 1e-5 of the exact f32 plain version.  A first pass splits desc2 once
into scratch laid out as 64-column tiles of hi, lo and penalties, ready
for shared memory; each tile then lands with one bulk (TMA) copy on an
mbarrier, 3 tiles ahead.  A block's 128 desc1 rows live in registers
as hi and lo A fragments.  One block fits an SM, so
:func:`column_split_waves` sizes the split by waves of blocks.  Same
epilogue, merge and tie rule as bf16.

Plain version: the same contract in PyTorch over row chunks (the full
score block per chunk, then max / masked max), used for CPU tensors.
"""

from __future__ import annotations

import functools

import torch

from sfm_tpu_torch.ops import _cuda

_NEG = -2.0  # correlations of unit vectors live in [-1, 1]
_ROWS, _COLS = 128, 64   # csrc/match.cu kTM = kXM, kTN = kXN
_F32_TILE_BYTES = _COLS * (2 * 128 + 1) * 4   # kXTileBytes: hi, lo, penalties
_BLOCKS_PER_SM = 8   # bf16: 2 resident blocks x ~4 waves: small blocks, little tail
# f32 (one resident block per SM): a block's start, its desc1 rows and
# first tile, in tiles' time.
_STARTUP_TILES = 1.5


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


def column_split(n1: int, n2: int, rows_per_block: int, sm_count: int):
    """(split, columns per range) of the kernel's grid: enough column
    ranges that row tiles x ranges reach ~8 blocks per SM, each range a
    whole number of 64-column tiles and none empty."""
    row_tiles = -(-n1 // rows_per_block)
    col_tiles = max(1, -(-n2 // _COLS))
    want = max(1, -(-_BLOCKS_PER_SM * sm_count // row_tiles))
    tiles = -(-col_tiles // min(col_tiles, want))
    return -(-col_tiles // tiles), tiles * _COLS


@functools.lru_cache(maxsize=64)
def column_split_waves(n1: int, n2: int, rows_per_block: int, sm_count: int):
    """(split, columns per range) for one resident block per SM: the
    split whose waves of blocks x (tiles per range + a block's start)
    is least, each range a whole number of 64-column tiles and none
    empty."""
    row_tiles = -(-n1 // rows_per_block)
    col_tiles = max(1, -(-n2 // _COLS))
    best = None
    for want in range(1, col_tiles + 1):
        tiles = -(-col_tiles // want)
        split = -(-col_tiles // tiles)
        cost = -(-row_tiles * split // sm_count) * (tiles + _STARTUP_TILES)
        if best is None or cost < best[0]:
            best = (cost, split, tiles * _COLS)
    return best[1:]


def grid_split(n1: int, n2: int, bf16: bool, sm_count: int):
    """(split, columns per range) of the kernel's grid in either mode."""
    if bf16:
        return column_split(n1, n2, _ROWS, sm_count)
    return column_split_waves(n1, n2, _ROWS, sm_count)


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
    split, cols = grid_split(n1, n2, bf16, _cuda.sm_count(dev))
    ptrs = (0, 0, 0)
    if split > 1:   # per-range partials, folded by the merge pass
        scratch = torch.empty((3, split, n1), dtype=torch.float32, device=dev)
        ptrs = (scratch[0].data_ptr(), scratch[1].data_ptr(),
                scratch[2].view(torch.int32).data_ptr())
    # f32: desc2's hi, lo and penalties, split once for every row tile
    split2 = None if bf16 else torch.empty(
        -(-n2 // _COLS) * _F32_TILE_BYTES, dtype=torch.uint8, device=dev)
    code = _cuda.library().lib.sfm_match_top2(
        d1.data_ptr(), d2.data_ptr(), v2.data_ptr(), n1, n2, int(bf16), split,
        cols, 0 if split2 is None else split2.data_ptr(), *ptrs, best.data_ptr(),
        second.data_ptr(), index.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(code, "match_top2")
    _cuda.launched("match_top2")
    return best, second, index
