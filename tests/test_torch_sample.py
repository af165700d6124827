"""Parity: the port's sampling kernels' plain versions (K4 fused
orientation + descriptor, K5 descriptor) against the JAX package's
Pallas kernels in interpret mode; and the compact cell-support table
that the CUDA K4 and K5 walk in place of the full spatial weights.

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
import pytest
import torch

from synthetic_pair import synthetic_pair
from sfm_tpu.ops import pallas_sample
from sfm_tpu.sift import describe as jdescribe
from sfm_tpu_torch.ops.image import patch_origin
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


def test_support_table_lists_the_nonzero_cell_weights():
    """Per cell, exactly WSP's nonzero weights, in increasing sample
    order: the entries the full 256-sample scan does not skip."""
    off, s, w = describe.SUPPORT_OFFSETS, describe.SUPPORT_S, describe.SUPPORT_W
    assert off.shape == (17,) and off[0] == 0
    assert off[-1] == len(s) == len(w) == np.count_nonzero(describe.WSP) == 784
    for c in range(16):
        sc = s[off[c]:off[c + 1]]
        np.testing.assert_array_equal(sc, np.flatnonzero(describe.WSP[:, c]))
        assert 36 <= len(sc) <= 64 and (np.diff(sc) > 0).all()
        np.testing.assert_array_equal(w[off[c]:off[c + 1]], describe.WSP[sc, c])


def _sums_in_kernel_order(grad, angi, angf):
    """[K, 128] descriptor sums as the CUDA K4 and K5 take them: output
    (cell c, bin a) adds (grad * (1 - angf)) * w where angi = a, else
    (grad * angf) * w where angi + 1 (mod 8) = a, over cell c's support
    entries (s, w) in table order, each step rounded to float32."""
    one = np.float32(1.0)
    t0, t1 = grad * (one - angf), grad * angf
    ai = angi.astype(np.int64)
    ai2 = np.where(ai + 1 > 7, 0, ai + 1)
    bins = np.arange(8)
    off = describe.SUPPORT_OFFSETS
    out = np.zeros((grad.shape[0], 16, 8), np.float32)
    for c in range(16):
        for e in range(off[c], off[c + 1]):
            s, w = describe.SUPPORT_S[e], describe.SUPPORT_W[e]
            add0 = ai[:, s, None] == bins
            add1 = ~add0 & (ai2[:, s, None] == bins)
            acc = out[:, c]
            acc = np.where(add0, acc + (t0[:, s] * w)[:, None], acc)
            out[:, c] = np.where(add1, acc + (t1[:, s] * w)[:, None], acc)
    return out.reshape(-1, 128)


def test_support_table_sums_reproduce_the_plain_descriptors(rng):
    """The kernels' per-cell loop over the support table gives
    ``raw_descriptors``' einsum (another summation order) within 1e-6
    of each row's largest entry."""
    img, x, y, sc = _setup(rng)
    ori = rng.uniform(0, 360, len(x)).astype(np.float32)
    img_t = T(img)
    x0, y0a, fx, fy = patch_origin(T(x), T(y), *img.shape)
    args = (img_t, x0, y0a, fx, fy, T(sc), T(ori))
    grad, angi, angf = (a.numpy() for a in describe.descriptor_samples(*args))
    raw = describe.raw_descriptors(*args).numpy()
    loop = _sums_in_kernel_order(grad, angi, angf)
    assert np.isfinite(loop).all() and (raw.max(axis=1) > 0).all()
    err = np.abs(loop - raw).max(axis=1)
    assert (err <= 1e-6 * np.abs(raw).max(axis=1)).all(), err.max()


def test_kernel_tables_are_cached_per_device_and_packed():
    """The tables the sampling kernels read are built once per device;
    the support table travels as int32 pairs (sample, weight's float32
    bits) that the kernels read as one 8-byte load."""
    from sfm_tpu_torch.ops import sample

    cpu = torch.device("cpu")
    t = sample._tables_on(cpu)
    assert sample._tables_on(cpu) is t
    sup = t.sup.numpy()
    assert sup.dtype == np.int32 and sup.shape == (784, 2) and t.sup.is_contiguous()
    np.testing.assert_array_equal(sup[:, 0], describe.SUPPORT_S)
    np.testing.assert_array_equal(sup[:, 1].view(np.float32), describe.SUPPORT_W)
    np.testing.assert_array_equal(t.sup_off.numpy(), describe.SUPPORT_OFFSETS)
    np.testing.assert_array_equal(t.wsp.numpy(), describe.WSP)
    np.testing.assert_array_equal(t.w2d.numpy(), describe.W2D)


@pytest.mark.parametrize("case", ["interior", "patch_edges", "small_scales",
                                  "large_scales"])
def test_support_box_holds_every_tap_of_the_plain_version(rng, monkeypatch, case):
    """K9 copies only ``support_box``'s rows and columns of each
    keypoint's 48 x 40 patch: every bilinear tap that K4's function (its
    plain version, the gather form K9 must equal) reads lies inside the
    box, also where the patch is clamped at the image's edges and where
    the scale reaches past the patch or so little that the orientation
    window sets the box.  At the frontend's scales the box is well under
    the patch."""
    from sfm_tpu_torch.ops import image, sample
    from sfm_tpu_torch.sift import orient

    H, W, K = 150, 182, 96
    img = synthetic_pair(H, W, seed=4)["img1"]
    x = rng.uniform(0.5, W - 1.5, K)
    y = rng.uniform(0.5, H - 1.5, K)
    sc = rng.uniform(0.8, 2.0, K)
    if case == "patch_edges":
        x[::2] = rng.choice([0.1, 0.9, 3.5, 17.99, W - 4.2, W - 1.01, W - 0.2], K // 2)
        y[1::2] = rng.choice([0.05, 1.5, 7.99, 19.0, H - 6.5, H - 1.2, H - 0.3], K // 2)
    elif case == "small_scales":
        sc = rng.uniform(0.2, 0.8, K)
    elif case == "large_scales":
        sc = rng.uniform(2.0, 9.0, K)
    x, y, sc = (T(a.astype(np.float32)) for a in (x, y, sc))
    taps = []
    real = image.patch_sample

    def recording(img_, x0, y0a, px, py, P=image.DESC_P):
        ix = torch.floor(torch.clamp(px, 0.0, P - 1.0)).to(torch.int64)
        iy = torch.floor(torch.clamp(py, 0.0, P + 7.0)).to(torch.int64)
        taps.append((iy.amin(1), torch.clamp(iy + 1, max=P + 7).amax(1),
                     ix.amin(1), torch.clamp(ix + 1, max=P - 1).amax(1)))
        return real(img_, x0, y0a, px, py, P)

    monkeypatch.setattr(orient, "patch_sample", recording)
    monkeypatch.setattr(describe, "patch_sample", recording)
    d1, _, _, _ = sample.fused_orient_descriptor_plain(T(img), x, y, sc)
    assert len(taps) == 8 and bool(d1.abs().sum(1).gt(0).all())
    lo_r, hi_r, lo_c, hi_c = (torch.stack(t) for t in zip(*taps))
    _, _, fx, fy = patch_origin(x, y, H, W)
    r0, r1, c0, c1 = sample.support_box(fx, fy, sc)
    assert bool((r0 <= lo_r.amin(0)).all() and (hi_r.amax(0) <= r1).all())
    assert bool((c0 <= lo_c.amin(0)).all() and (hi_c.amax(0) <= c1).all())
    assert bool((r0 >= 0).all() and (r1 <= 47).all() and (c0 >= 0).all()
                and (c1 <= 39).all())
    area = ((r1 - r0 + 1) * (c1 - c0 + 1)).to(torch.float32)
    if case == "large_scales":
        assert bool(((c0 == 0) & (c1 == 39)).any())
    else:
        assert float(area.mean()) < 0.5 * 48 * 40
