"""Parity: the port's K8 (orientation histograms), its module API
(``assign_orientations``, ``extract_descriptors``) and K9's route
against the JAX package's Pallas kernels in interpret mode, on the same
seeded inputs.

Tolerances: the TPU kernels sample through tent-matrix matmuls and a
polynomial atan2 (|err| < 1e-6 rad), the port through gathers and
atan2f.  K8's raw histograms are held as the JAX package holds its own
kernel against its gather path (tests/test_pallas_sample.py): relative
error |h - h_ref| / (|h_ref| + 1e-3) below 1e-3.  Orientations and
descriptors as in test_torch_sample: within 0.1 degree on >= 95% of
keypoints (matched to the nearest of the two peaks, which may swap on
near-ties), the duplicate flag equal on >= 95%, and descriptor dot
products > 0.999 on >= 99% of the keypoints whose orientation agrees.
Slots >= count (and invalid slots) must be exactly zero.  Within the
port, K9's route must equal K4's exactly.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_pair import synthetic_pair
from sfm_tpu.ops import pallas_sample
from sfm_tpu.sift import describe as jdescribe
from sfm_tpu.sift import orient as jorient
from sfm_tpu_torch.config import SiftConfig
from sfm_tpu_torch.ops import sample
from sfm_tpu_torch.sift import describe, frontend, orient
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = torch.as_tensor


def _setup(rng, K=64, H=144, W=176):
    img = synthetic_pair(H, W, seed=3)["img1"]
    x = rng.uniform(0.5, W - 1.5, K).astype(np.float32)
    y = rng.uniform(0.5, H - 1.5, K).astype(np.float32)
    # Border keypoints: every edge and corner of the image.
    x[:6] = [0.3, W - 1.2, 5.0, 30.0, W - 0.6, 2.2]
    y[:6] = [2.0, 0.7, H - 1.1, 20.0, H - 0.8, H - 3.5]
    sc = rng.uniform(0.8, 2.0, K).astype(np.float32)
    return img, x, y, sc


def _ang_diff(a, b):
    return np.abs((a - b + 180.0) % 360.0 - 180.0)


def _norm(d):
    return np.array(jdescribe.normalize_descriptors(jnp.asarray(d)))


def _interpret(monkeypatch, name):
    """Run the JAX package's Pallas kernel ``name`` in interpret mode
    (the only mode on the CPU) where its module API calls it."""
    monkeypatch.setattr(pallas_sample, name,
                        functools.partial(getattr(pallas_sample, name), interpret=True))


def test_orientation_histogram_plain_matches_pallas(rng):
    img, x, y, sc = _setup(rng)
    count = 57
    hj = np.array(pallas_sample.orientation_histogram_sample(
        *map(jnp.asarray, (img, x, y, sc)), count=count, interpret=True))
    ht = sample.orientation_histogram_sample(*map(T, (img, x, y, sc)),
                                             count=torch.tensor(count)).numpy()
    assert ht.shape == (64, 32)
    assert not ht[count:].any() and not hj[count:].any()
    rel = np.abs(ht[:count] - hj[:count]) / (np.abs(hj[:count]) + 1e-3)
    assert rel.max() < 1e-3, rel.max()
    assert (ht[:count].sum(1) > 0).all()


def test_orientation_patch_matches_the_descriptor_patch(rng):
    # The 16-column patch reaches every orientation sample, so K8's raw
    # histogram is the one K4 builds on its 40-column patch, up to the
    # f32 rounding of sample positions near the left and top edges
    # (there the 40-column origin clips at 0, and x - x0 + offset
    # crosses into a coarser binade).
    img, x, y, sc = _setup(rng)
    img, x, y, sc = map(T, (img, x, y, sc))
    H, W = img.shape
    from sfm_tpu_torch.ops.image import patch_origin

    h40 = orient.patch_histograms(img, *patch_origin(x, y, H, W), sc)
    torch.testing.assert_close(sample.orientation_histogram_sample(img, x, y, sc),
                               h40, rtol=1e-6, atol=1e-5)


def test_assign_orientations_matches_jax(rng, monkeypatch):
    _interpret(monkeypatch, "orientation_histogram_sample")
    img, x, y, sc = _setup(rng)
    valid = rng.random(64) > 0.3
    valid[:6] = True
    o1j, o2j, v2j = map(np.array, jorient.assign_orientations(
        *map(jnp.asarray, (img, x, y, sc, valid)), use_pallas=True))
    o1t, o2t, v2t = (a.numpy() for a in orient.assign_orientations(
        *map(T, (img, x, y, sc, valid)), use_pallas=True))
    assert not o1t[~valid].any() and not v2t[~valid].any()
    err = np.minimum(_ang_diff(o1t, o1j), np.where(v2j, _ang_diff(o1t, o2j), 360))
    assert (err[valid] < 0.1).mean() >= 0.95
    assert (v2t[valid] == v2j[valid]).mean() >= 0.95
    both = valid & v2t & v2j & (_ang_diff(o2t, o2j) < 0.1)
    assert both.sum() >= 0.9 * (valid & v2j).sum()
    # Without duplicates no second slot is valid.
    _, _, v2n = orient.assign_orientations(*map(T, (img, x, y, sc, valid)),
                                           duplicates=False)
    assert not v2n.any()


def test_extract_descriptors_matches_jax(rng, monkeypatch):
    _interpret(monkeypatch, "descriptor_sample")
    img, x, y, sc = _setup(rng)
    ori = rng.uniform(0, 360, 64).astype(np.float32)
    valid = rng.random(64) > 0.3
    dj = np.array(jdescribe.extract_descriptors(
        *map(jnp.asarray, (img, x, y, sc, ori)), valid=jnp.asarray(valid),
        use_pallas=True))
    dt = describe.extract_descriptors(*map(T, (img, x, y, sc, ori)),
                                      valid=T(valid), use_pallas=True).numpy()
    assert not dt[~valid].any() and not dj[~valid].any()
    dots = np.sum(dt[valid] * dj[valid], axis=1)
    assert (dots > 0.999).mean() >= 0.99
    # Without a mask every row is sampled, and the valid rows are the same.
    da = describe.extract_descriptors(*map(T, (img, x, y, sc, ori))).numpy()
    np.testing.assert_allclose(da[valid], dt[valid], atol=1e-6)


@pytest.mark.parametrize("src_vmem", [False, True])
def test_window_route_matches_pallas_win(rng, src_vmem):
    img, x, y, sc = _setup(rng, K=32)
    count = 29
    d1j, d2j, o1j, o2j, dupj = map(np.array, pallas_sample.fused_orient_descriptor_win(
        *map(jnp.asarray, (img, x, y, sc)), count=count, interpret=True,
        block_k=8, src_vmem=src_vmem))
    args = [T(a) for a in (img, x, y, sc)]
    d1t, o1t, o2t, dupt = sample.fused_orient_descriptor_win(
        *args, count=torch.tensor(count))
    for a, b in zip((d1t, o1t, o2t, dupt),
                    sample.fused_orient_descriptor(*args, count=torch.tensor(count))):
        assert torch.equal(a, b)                 # K9's route is K4's function
    # The frontend's duplicate split: d2 from K5 on the duplicate rows.
    d2t = sample.descriptor_sample(*args, o2t).numpy()
    d1t, o1t, o2t, dupt = (a.numpy() for a in (d1t, o1t, o2t, dupt))
    live = np.arange(32) < count
    assert not d1t[~live].any() and not dupt[~live].any()
    err = np.minimum(_ang_diff(o1t, o1j), np.where(dupj, _ang_diff(o1t, o2j), 360))
    assert (err[live] < 0.1).mean() >= 0.95
    assert (dupt[live] == dupj[live]).mean() >= 0.95
    same = live & (_ang_diff(o1t, o1j) < 0.1)
    dots = np.sum(_norm(d1t[same]) * _norm(d1j[same]), axis=1)
    assert (dots > 0.999).mean() >= 0.99
    dup2 = live & dupt & dupj & (_ang_diff(o2t, o2j) < 0.1)
    assert dup2.any()
    dots2 = np.sum(_norm(d2t[dup2]) * _norm(d2j[dup2]), axis=1)
    assert (dots2 > 0.999).mean() >= 0.99


@pytest.mark.parametrize("window", [True, "hbm", "vmem"])
def test_extract_sift_sample_window_equals_k4(window):
    img = T(synthetic_pair(96, 128, seed=1)["img1"])
    cfg = SiftConfig(num_octaves=3, max_pts_per_octave=128)
    ref = frontend.extract_sift(img, cfg)
    win = frontend.extract_sift(img, dataclasses.replace(cfg, sample_window=window))
    assert int(ref.keypoints.valid.sum()) > 50
    for a, b in zip(ref.keypoints, win.keypoints):
        assert torch.equal(a, b)
    assert torch.equal(ref.descriptors, win.descriptors)


def test_unknown_sample_window_raises():
    with pytest.raises(ValueError):
        frontend.extract_sift(torch.zeros((64, 64)),
                              SiftConfig(sample_window="dma"))
