"""Parity: the port's sampling kernels' plain versions (K4 fused
orientation + descriptor, K5 descriptor) against the JAX package's
Pallas kernels in interpret mode.

Tolerances: the TPU kernels sample through tent-matrix matmuls and a
polynomial atan2 (|err| < 1e-6 rad), the port through gathers and
atan2f, so a gradient sample near a bin edge may fall into the
neighbouring bin.  Orientations are therefore compared within 0.1
degree on >= 95% of keypoints (and matched to the nearest of the two
peaks, which may swap on near-ties, as bench.py's probe does), and
descriptors by their normalized dot product: > 0.999 on >= 99% of
keypoints.  Slots >= count must be exactly zero.
"""

import jax.numpy as jnp
import numpy as np
import torch

from synthetic_pair import synthetic_pair
from sfm_tpu.ops import pallas_sample
from sfm_tpu.sift import describe as jdescribe
from sfm_tpu_torch.ops.sample import descriptor_sample, fused_orient_descriptor
from sfm_tpu_torch.sift import describe
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = torch.as_tensor


def _setup(rng, K=64, H=144, W=176):
    img = synthetic_pair(H, W, seed=3)["img1"]
    x = rng.uniform(0.5, W - 1.5, K).astype(np.float32)
    y = rng.uniform(0.5, H - 1.5, K).astype(np.float32)
    x[:4] = [0.3, W - 1.2, 5.0, 30.0]          # border keypoints
    y[:4] = [2.0, 0.7, H - 1.1, 20.0]
    sc = rng.uniform(0.8, 2.0, K).astype(np.float32)
    return img, x, y, sc


def _norm(d):
    return np.array(jdescribe.normalize_descriptors(jnp.asarray(d)))


def _ang_diff(a, b):
    return np.abs((a - b + 180.0) % 360.0 - 180.0)


def test_fused_orient_descriptor_plain_matches_pallas(rng):
    img, x, y, sc = _setup(rng)
    count = 60
    d1j, d2j, o1j, o2j, dupj = map(np.array, pallas_sample.fused_orient_descriptor(
        *map(jnp.asarray, (img, x, y, sc)), count=count, interpret=True,
        phases=4))
    d1t, o1t, o2t, dupt = (a.numpy() for a in fused_orient_descriptor(
        *map(T, (img, x, y, sc)), count=torch.tensor(count)))
    assert not d2j.any()                       # phases=4: no second peak
    live = np.arange(len(x)) < count
    assert not d1t[~live].any() and not o1t[~live].any()
    assert not o2t[~live].any() and not dupt[~live].any()
    # Nearest of the two JAX peaks to the port's first peak.
    err = np.minimum(_ang_diff(o1t, o1j), np.where(dupj, _ang_diff(o1t, o2j), 360))
    assert (err[live] < 0.1).mean() >= 0.95
    assert (dupt[live] == dupj[live]).mean() >= 0.95
    same = live & (_ang_diff(o1t, o1j) < 0.1)
    dots = np.sum(_norm(d1t[same]) * _norm(d1j[same]), axis=1)
    assert (dots > 0.999).mean() >= 0.99


def test_descriptor_sample_plain_matches_pallas(rng):
    img, x, y, sc = _setup(rng)
    ori = rng.uniform(0, 360, len(x)).astype(np.float32)
    count = 50
    dj = np.array(pallas_sample.descriptor_sample(
        *map(jnp.asarray, (img, x, y, sc, ori)), count=count, interpret=True,
        wide=True))
    dt = descriptor_sample(*map(T, (img, x, y, sc, ori)),
                           count=torch.tensor(count)).numpy()
    assert not dt[count:].any() and not dj[count:].any()
    dots = np.sum(_norm(dt[:count]) * _norm(dj[:count]), axis=1)
    assert (dots > 0.999).mean() >= 0.99
    assert np.isfinite(dt).all()
    # The port's normalization equals the JAX package's.
    np.testing.assert_allclose(describe.normalize_descriptors(T(dt)).numpy(),
                               _norm(dt), atol=1e-6)
