"""The frontend's slot order for the sampling kernels against the JAX
package's: over more than 16,384 detection slots, ``sample_cap`` takes
a rank-major interleave of the octaves and a valid-first compaction
(``sfm_tpu/sift/frontend.py:315-330``) instead of a global top-k.

With equal per-octave slot counts the order must equal the JAX
package's exactly.  With unequal ``octave_caps`` the port follows the
true segment bounds, where the JAX formula is not a permutation (a
recorded divergence, ROADMAP §3): there the order must be one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.config import SiftConfig
from sfm_tpu.sift import detect as jdetect
from sfm_tpu.sift import frontend as jfrontend
from sfm_tpu_torch import interop
from sfm_tpu_torch.sift import detect, frontend
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_SIDE = 24   # every octave's side in the test atlas


def _detections(seg, n_valid, offsets, seed):
    """Per-octave detections as ``select_from_maps`` leaves them:
    strongest first, the valid ones a prefix.  Returns numpy fields."""
    rng = np.random.default_rng(seed)
    out = []
    for n, nv, off in zip(seg, n_valid, offsets):
        sharp = np.sort(rng.uniform(1.0, 60.0, n))[::-1] * rng.choice([-1, 1], n)
        out.append({
            "x": rng.uniform(1, _SIDE - 2, n), "y": rng.uniform(1, _SIDE - 2, n) + off,
            "scale": rng.uniform(1.0, 2.0, n), "sharpness": sharp,
            "edgeness": rng.uniform(1.0, 9.0, n), "valid": np.arange(n) < nv})
    return [{k: v.astype(np.float32) if k != "valid" else v for k, v in d.items()}
            for d in out]


def test_sample_stage_interleave_equals_jax():
    """5 octaves of 4,096 slots (20,480 > 16,384) capped to 2,560 with
    3,000 valid: the kept keypoints (x, y, octave, valid) in the JAX
    package's order, exactly."""
    seg, n_valid = (4096,) * 5, (1200, 800, 500, 300, 200)
    cfg = SiftConfig(num_octaves=5, max_pts_per_octave=4096, sample_cap=2560,
                     orientation_duplicates=False)
    offsets = tuple(48 + o * (_SIDE + 96) for o in range(5))
    subs = tuple(float(2 ** o) for o in range(5))
    rng = np.random.default_rng(0)
    atlas = (rng.random((offsets[-1] + _SIDE + 48, _SIDE)) * 255).astype(np.float32)
    dets = _detections(seg, n_valid, offsets, seed=1)
    jres = jfrontend._sample_stage(
        jnp.asarray(atlas), offsets, subs,
        [jdetect.Detections(**{k: jnp.asarray(v) for k, v in d.items()}) for d in dets],
        cfg, False)
    tres = frontend.sample_stage(
        torch.as_tensor(atlas), offsets, subs,
        [detect.Detections(**{k: torch.as_tensor(v) for k, v in d.items()})
         for d in dets], interop.config_to_torch(cfg))
    jk, tk = jres.keypoints, tres.keypoints
    assert tk.x.shape[0] == 2 * 2560 and int(tk.valid.sum()) == 2560
    for f in ("x", "y", "octave", "valid"):
        np.testing.assert_array_equal(getattr(tk, f).numpy(), np.array(getattr(jk, f)))
    # The cap bound: each octave kept its strongest prefix, every octave
    # some (a global top-k would have kept octave 0's 1,200 first).
    kept = np.bincount(tk.octave.numpy()[:2560], minlength=5)
    assert (kept > 0).all() and kept.sum() == 2560


def test_rank_major_order_with_unequal_octave_caps_is_a_permutation():
    seg = (8192, 8192, 4096, 2048, 1024)            # 23,552 slots
    K = sum(seg)
    perm = frontend.rank_major_order(seg).numpy()
    np.testing.assert_array_equal(np.sort(perm), np.arange(K))
    # Rank-major: ranks never fall along the order, octaves ascend
    # within a rank.
    starts = np.cumsum((0,) + seg[:-1])
    octave = np.searchsorted(starts, perm, side="right") - 1
    rank = perm - starts[octave]
    key = rank * len(seg) + octave
    assert (np.diff(key) > 0).all()
    # The JAX formula on the same slots repeats some and drops others.
    j = np.arange(K)
    assert len(np.unique((j % 5) * (K // 5) + j // 5)) < K
    # The capped order: no slot twice, valid slots first, and with fewer
    # valid slots than the cap every one of them kept.
    n_valid = (3000, 2000, 900, 400, 100)
    valid = torch.as_tensor(np.concatenate(
        [np.arange(n) < nv for n, nv in zip(seg, n_valid)]))
    sharp = torch.ones(K)
    for cap in (4096, 8192):
        order = frontend._sample_order(valid, sharp, cap, seg).numpy()
        assert len(order) == cap and len(np.unique(order)) == cap
        v = valid.numpy()[order]
        n = min(cap, sum(n_valid))
        assert v[:n].all() and not v[n:].any()
    assert set(order[:sum(n_valid)]) == set(np.flatnonzero(valid.numpy()))
    with pytest.raises(ValueError):
        frontend._sample_order(valid, sharp, 4096)   # no segment counts
