"""Parity: the port's track building (``models/tracks.py``) against the
JAX package's.

Held exactly: the pair lists, and the TrackSet (``cam_idx``,
``pt_idx``, ``uv_pix``, ``n_tracks``): both packages visit pairs,
matches, nodes and groups in one order, so from the same matches "first
link wins" and the track numbering agree.  The matchers themselves agree
where no ratio sits within ~1e-3 of the 0.95 cutoff (K6's plain version
rounds to bf16 and sums in f32, the JAX package's CPU route in another
order: ``tests/test_torch_match.py``); the decoy-laden ring below hands
the JAX package's matches to both builders, so that near-cutoff ratios
cannot hide a union-find difference.  Normalized coordinates are the
same float32 numpy expression on both sides (exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.config import PipelineConfig
from sfm_tpu.models import tracks as jtr
from sfm_tpu.sift import match as jmatch
from sfm_tpu_torch import interop
from sfm_tpu_torch.models import tracks as tr
from sfm_tpu_torch.sift import match as match_mod
from test_torch_turntable import _feats
from test_turntable import K_SYN
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = PipelineConfig()
TCFG = interop.config_to_torch(CFG)


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _assert_tracks_equal(ts, tj):
    assert ts.n_tracks == tj.n_tracks
    np.testing.assert_array_equal(ts.cam_idx.numpy(), np.asarray(tj.cam_idx))
    np.testing.assert_array_equal(ts.pt_idx.numpy(), np.asarray(tj.pt_idx))
    np.testing.assert_array_equal(ts.uv_pix.numpy(), np.asarray(tj.uv_pix))
    np.testing.assert_array_equal(ts.mask.numpy(), np.asarray(tj.mask))
    assert ts.cam_idx.dtype == ts.pt_idx.dtype == torch.int64


@pytest.mark.parametrize("n,gaps,wrap", [(6, (1, 2), True), (6, (1,), False),
                                         (36, (1, 2), True), (5, (1, 2, 3), False)])
def test_ring_pairs_match_jax(n, gaps, wrap):
    assert tr.ring_pairs(n, gaps=gaps, wrap=wrap) == jtr.ring_pairs(n, gaps=gaps, wrap=wrap)
    assert len(tr.ring_pairs(36, gaps=(1, 2))) == 72


def test_build_tracks_conflict_rule_matches_jax(rng):
    """3 frames x 8 slots, slot k carrying track k's descriptor, except
    frame 0's slot 1: a decoy 0.93-correlated with track 0.  The matcher
    links the decoy to frame 1's track-0 slot (a second frame-0
    observation for that track: the union is refused), and frame 2's
    track-0 slot back to the decoy in the wrap pair (2, 0) (refused
    again): first link wins, in both packages alike."""
    D = _unit(rng.normal(size=(8, 128)))
    decoy = _unit(D[0] + 0.4 * _unit(rng.normal(size=128)))
    frames = []
    for i in range(3):
        d = D.copy()
        if i == 0:
            d[1] = decoy
        if i == 2:
            d[0] = decoy
        frames.append({"x": np.arange(8, dtype=np.float32) * 10 + i * 3,
                       "y": np.full(8, 5.0, np.float32) + i,
                       "valid": np.ones(8, bool), "descriptors": d})
    pairs = tr.ring_pairs(3, gaps=(1,), wrap=True)
    ts = tr.build_tracks(_feats(frames, torch.as_tensor), pairs, TCFG, min_disparity_px=0.0)
    tj = jtr.build_tracks(_feats(frames, jnp.asarray), pairs, CFG, min_disparity_px=0.0)
    _assert_tracks_equal(ts, tj)
    # The refused unions were proposed: frame 0's decoy matched frame 1's
    # track-0 slot, which already holds frame 0's slot 0.
    m = match_mod.match(*(torch.as_tensor(frames[i]["descriptors"]) for i in (0, 1)))
    assert bool(m.valid[0]) and bool(m.valid[1]) and int(m.index[0]) == int(m.index[1]) == 0
    cam, pt = ts.cam_idx.numpy(), ts.pt_idx.numpy()
    for p in range(ts.n_tracks):
        assert len(set(cam[pt == p])) == int((pt == p).sum())   # one obs per frame


def test_build_tracks_matches_jax_on_a_ring(rng, monkeypatch):
    """8 frames x 96 slots (72 live) of 60 tracks with noisy descriptors,
    each frame seeing a random 80% of them in shuffled slots, plus decoys
    near other tracks (conflicting unions galore); gaps (1, 2) with the
    wrap edges, the disparity gate on; both builders get the JAX
    package's matches."""
    n, cap, P = 8, 96, 60
    D = _unit(rng.normal(size=(P, 128)))
    X = rng.uniform(50, 600, size=(P, 2)).astype(np.float32)
    frames = []
    for i in range(n):
        seen = rng.permutation(P)[:48]
        slots = rng.permutation(cap)[:72]
        d = np.zeros((cap, 128), np.float32)
        x = np.zeros((cap, 2), np.float32)
        d[slots[:48]] = _unit(D[seen] + rng.normal(scale=0.05, size=(48, 128)))
        x[slots[:48]] = X[seen] + i * 4.0 + rng.normal(scale=0.5, size=(48, 2))
        near = rng.integers(0, P, 24)
        d[slots[48:]] = _unit(D[near] + rng.normal(scale=0.35, size=(24, 128)))
        x[slots[48:]] = rng.uniform(50, 600, size=(24, 2))
        valid = np.zeros(cap, bool)
        valid[slots] = True
        frames.append({"x": x[:, 0].copy(), "y": x[:, 1].copy(), "valid": valid,
                       "descriptors": d})
    pairs = tr.ring_pairs(n, gaps=(1, 2), wrap=True)
    tj = jtr.build_tracks(_feats(frames, jnp.asarray), pairs, CFG)

    def jax_match(d1, d2, v1, v2, cfg):
        m = jmatch.match(*(jnp.asarray(a.numpy()) for a in (d1, d2, v1, v2)), CFG.match)
        return match_mod.Matches(*(torch.as_tensor(np.array(a)) for a in m))

    monkeypatch.setattr(match_mod, "match", jax_match)
    ts = tr.build_tracks(_feats(frames, torch.as_tensor), pairs, TCFG)
    _assert_tracks_equal(ts, tj)
    assert ts.n_tracks >= 40
    Kj = K_SYN
    np.testing.assert_array_equal(tr.normalize_trackset(ts, torch.as_tensor(Kj)).numpy(),
                                  np.asarray(jtr.normalize_trackset(tj, Kj)))


def test_build_tracks_with_no_match_is_empty():
    frames = [{"x": np.zeros(4, np.float32), "y": np.zeros(4, np.float32),
               "valid": np.zeros(4, bool),
               "descriptors": np.eye(4, 128, dtype=np.float32)} for _ in range(3)]
    pairs = tr.ring_pairs(3)
    ts = tr.build_tracks(_feats(frames, torch.as_tensor), pairs, TCFG)
    tj = jtr.build_tracks(_feats(frames, jnp.asarray), pairs, CFG)
    assert ts.n_tracks == tj.n_tracks == 0
    assert ts.cam_idx.shape == (0,) and ts.uv_pix.shape == (0, 2)
