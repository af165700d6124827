"""Parity: the port's matcher (K6's plain version and sift.match)
against the JAX package.

K6's plain version runs on CPU tensors; the JAX side runs the Pallas
kernel in interpret mode.  Tolerances: with ``bf16`` both sides round
the descriptors to bf16 and accumulate the products in f32, so scores
differ only by f32 summation order (1e-5); argmax agreement is held to
the >= 99.9% bar of ``MatchConfig`` (near-ties may swap).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.config import MatchConfig
from sfm_tpu.ops.pallas_match import match_top2_pallas
from sfm_tpu.sift import match as jmatch
from sfm_tpu_torch import interop
from sfm_tpu_torch.ops.match import grid_split, match_top2, match_top2_plain
from sfm_tpu_torch.sift import match
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = torch.as_tensor


def _descs(rng, n):
    d = np.abs(rng.normal(size=(n, 128))).astype(np.float32) ** 2
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("bf16", [False, True])
def test_top2_plain_matches_pallas_interpret(rng, bf16):
    d1 = _descs(rng, 64)
    d2 = np.concatenate([d1[::2] + 0.05 * _descs(rng, 32), _descs(rng, 480)])
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(np.float32)
    v2 = rng.random(512) > 0.1
    bj, sj, ij = map(np.array, match_top2_pallas(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v2), bm=8, bn=256,
        bf16=bf16, interpret=True))
    bt, st, it = (a.numpy() for a in match_top2_plain(T(d1), T(d2), T(v2),
                                                      bf16=bf16))
    assert (it == ij).mean() >= 0.999
    np.testing.assert_allclose(bt, bj, atol=1e-5)
    np.testing.assert_allclose(st, sj, atol=1e-5)
    assert v2[it].all()


def test_top2_ties_invalid_columns_and_dispatch():
    d1 = np.zeros((3, 128), np.float32)
    d1[:, 0] = 1.0
    d2 = np.zeros((6, 128), np.float32)
    d2[[1, 3, 4], 0] = 1.0   # three equal best columns
    v2 = np.array([1, 0, 1, 1, 1, 1], bool)   # the first tie is invalid
    best, second, idx = match_top2(T(d1), T(d2), T(v2))
    assert idx.tolist() == [3, 3, 3]          # lowest VALID index wins
    assert best.tolist() == [1.0] * 3
    assert second.tolist() == [1.0] * 3       # only the argmax column is excluded
    # Every column invalid: running values stay at -2, index 0.
    best, second, idx = match_top2(T(d1), T(d2), T(np.zeros(6, bool)))
    assert best.tolist() == [-2.0] * 3 and second.tolist() == [-2.0] * 3
    assert idx.tolist() == [0, 0, 0]


def test_match_ratio_test_matches_jax(rng):
    d1 = _descs(rng, 200)
    d2 = np.concatenate([d1[:150] + 0.02 * _descs(rng, 150), _descs(rng, 100)])
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(np.float32)
    v1 = rng.random(200) > 0.05
    v2 = rng.random(250) > 0.05
    cfg = MatchConfig(bf16=False)
    mj = jmatch.match(*map(jnp.asarray, (d1, d2, v1, v2)), cfg)
    mt = match.match(*map(T, (d1, d2, v1, v2)), interop.config_to_torch(cfg))
    assert (mt.index.numpy() == np.array(mj.index)).mean() >= 0.999
    assert (mt.valid.numpy() == np.array(mj.valid)).mean() >= 0.999
    np.testing.assert_allclose(mt.ambiguity.numpy(), np.array(mj.ambiguity),
                               atol=1e-5)
    mm = match.match(*map(T, (d1, d2, v1, v2)),
                     interop.config_to_torch(MatchConfig(mutual=True)))
    assert int(mm.valid.sum()) <= int(mt.valid.sum())


def _tf32(x):
    """x rounded to TF32 as K6's f32 mode rounds it (csrc/match.cu
    tf32_round): to nearest with ties away from zero, 10 mantissa bits."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("signed", [True, False])
def test_tf32x3_split_keeps_f32_accuracy(rng, signed):
    """The arithmetic of K6's f32 mode, emulated on the CPU: x = hi + lo
    exactly; three TF32 passes (lo1.hi2 + hi1.lo2 + hi1.hi2, products
    exact in f32, f32 sums) stay within 2e-6 of float64, while one pass
    of hi alone misses 1e-5, so the kernel's 1e-5 bar would catch a
    kernel that dropped the compensation."""
    d1, d2 = (rng.normal(size=(n, 128)) for n in (256, 1024))
    if not signed:
        d1, d2 = np.abs(d1), np.abs(d2)
    d1, d2 = ((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
              for d in (d1, d2))
    hi1, hi2 = _tf32(d1), _tf32(d2)
    lo1, lo2 = d1 - hi1, d2 - hi2
    for x, hi, lo in ((d1, hi1, lo1), (d2, hi2, lo2)):
        assert np.array_equal(hi + lo, x)
        assert not (hi.view(np.uint32) & np.uint32(0x1FFF)).any()
        assert (np.abs(lo) <= np.abs(x) * 2.0 ** -11).all()
    assert (d1.view(np.uint32) & np.uint32(0x1FFF)).astype(bool).mean() > 0.99
    exact = d1.astype(np.float64) @ d2.astype(np.float64).T
    three = T(_tf32(lo1)) @ T(hi2).T
    three = three + T(hi1) @ T(_tf32(lo2)).T
    three = three + T(hi1) @ T(hi2).T
    assert np.abs(three.numpy() - exact).max() <= 2e-6
    one = (T(hi1) @ T(hi2).T).numpy()
    assert np.abs(one - exact).max() > 1e-5


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("n1, n2", [(1, 1), (256, 5121), (1500, 2048), (5120, 5120),
                                    (23552, 23552)])
def test_grid_split_covers_every_column_once(n1, n2, bf16):
    """K6's grid in either mode: column ranges of whole 64-column tiles
    that cover desc2, none empty (the f32 mode sizes them by waves of
    one resident block per SM)."""
    split, cols = grid_split(n1, n2, bf16, 132)
    assert split >= 1 and cols % 64 == 0
    assert (split - 1) * cols < n2 <= split * cols
