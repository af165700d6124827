"""The JAX package's XLA routes in the port, against the JAX package's own
CPU route on the same inputs: the dense DoG detector
(``fused_detect=False``), two-stage sampling (``use_pallas=False``), the
f32 matcher (``MatchConfig.use_pallas=False``, also on a one-rank gloo
mesh) and ``select="compact"`` / ``"approx"`` in both detectors.

Inputs are 96 x 128 to 144 x 176 images from a numpy seed (the
synthetic textured pair), 3 octaves and 256 points per octave.  The
JAX side runs its XLA route (its CPU default); where a fused-route
combination needs the JAX package's Pallas kernels they run in
interpret mode, as its own tests run them.

Tolerances: the image filters and the pyramid's bases to 1e-6 of the
0..255 range (the same multiply-adds in another summation order: a few
ulps, ~5e-5); the DoG to 1e-4; detection on one DoG fed to both
sides: equal valid masks and x, y, scale to 1e-4; the orientation
histograms 1e-3 of the largest bin and two-stage descriptors corr >
0.9999 (the JAX package's gather-path bars,
``tests/test_pallas_sample.py:21-40``); ``extract_sift`` in all four
route combinations: equal counts, keypoints within 0.2 px, descriptors
corr > 0.999, and with ``use_pallas=False`` the JAX slot layout exactly
(on K3's maps, 99% of the slots: two near-equal responses can swap);
the f32 top-2: indices exact, scores to 1e-5; the two-view pipeline on
the XLA route with injected minimal sets: ``tests/test_torch_pipeline.py``'s
tolerances (the match count within max(3, 2%), R and t to 1e-4 on the
same correspondences).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_pair import synthetic_pair
from sfm_tpu.config import MatchConfig, PipelineConfig, RansacConfig, SiftConfig
from sfm_tpu.geometry import ransac as jransac
from sfm_tpu.ops import image as jimage
from sfm_tpu.sift import describe as jdescribe
from sfm_tpu.sift import detect as jdetect
from sfm_tpu.sift import frontend as jfrontend
from sfm_tpu.sift import match as jmatch
from sfm_tpu.sift import orient as jorient
from sfm_tpu.sift import pyramid as jpyramid
from sfm_tpu.models import two_view as jtv
from sfm_tpu_torch import interop
from sfm_tpu_torch.models import two_view
from sfm_tpu_torch.ops import image, sample
from sfm_tpu_torch.parallel import dist_match, mesh as meshmod
from sfm_tpu_torch.sift import describe, detect, frontend, match, orient, pyramid
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = torch.as_tensor
RANGE = 255.0
# The XLA route in both frontend knobs (the dense detector, two-stage
# sampling) and the f32 matcher; the JAX package's CPU default.
SIFT = SiftConfig(num_octaves=3, max_pts_per_octave=256, fused_detect=False,
                  use_pallas=False, sample_block_k=8)
ROUTES = [(False, False), (False, True), (True, False), (True, True)]


def _image(shape, seed=0):
    return (np.random.default_rng(seed).random(shape) * RANGE).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return synthetic_pair(144, 176, seed=0)


def _corr(a, b):
    """Row-wise dot products of unit (or zero) descriptor rows."""
    return np.sum(np.asarray(a) * np.asarray(b), axis=-1)


# ---- ops/image ------------------------------------------------------------

@pytest.mark.parametrize("shape", [(97, 131), (31, 45)])
def test_image_filters_match_jax(shape):
    img = _image(shape)
    taps = jimage.gaussian_kernel(4, 1.7)
    bank = jpyramid.octave_kernel_bank(SiftConfig(), 1)
    pairs = [
        (image.blur(T(img), taps), jimage.blur(jnp.asarray(img), taps)),
        (image.blur_bank(T(img), bank), jimage.blur_bank(jnp.asarray(img), bank)),
        (image.scale_down(T(img)), jimage.scale_down(jnp.asarray(img))),
        (image.scale_down(T(img), 0.8), jimage.scale_down(jnp.asarray(img), 0.8)),
        (image.scale_up(T(img)), jimage.scale_up(jnp.asarray(img))),
    ]
    for out, ref in pairs:
        ref = np.asarray(ref)
        assert tuple(out.shape) == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6 * RANGE)
    # scale_down keeps the first of every two rows and columns (ceil).
    assert tuple(pairs[2][0].shape) == (-(-shape[0] // 2), -(-shape[1] // 2))


# ---- sift/pyramid ---------------------------------------------------------

@pytest.mark.parametrize("up_scale", [False, True], ids=["base", "up_scale"])
def test_build_pyramid_matches_jax(pair, up_scale):
    img = pair["img1"][:96, :128] if up_scale else pair["img1"]
    cfg = dataclasses.replace(SIFT, up_scale=up_scale)
    jo = jpyramid.build_pyramid(jnp.asarray(img), cfg)
    to = pyramid.build_pyramid(T(img), interop.config_to_torch(cfg))
    assert len(to) == len(jo) == cfg.num_octaves
    for o, (t, j) in enumerate(zip(to, jo)):
        assert t.subsampling == j.subsampling == 2.0 ** o
        assert tuple(t.dog.shape) == np.asarray(j.dog).shape == (
            cfg.num_scales + 2, *t.base.shape)
        np.testing.assert_allclose(t.base.numpy(), np.asarray(j.base), rtol=0,
                                   atol=1e-6 * RANGE)
        np.testing.assert_allclose(t.dog.numpy(), np.asarray(j.dog), rtol=0, atol=1e-4)


# ---- sift/detect ----------------------------------------------------------

@pytest.fixture(scope="module")
def dog(pair):
    """Octave 0's DoG of the pair's first image, the JAX package's."""
    return np.asarray(jpyramid.build_pyramid(jnp.asarray(pair["img1"]), SIFT)[0].dog)


def _assert_same_detections(t, j, tol=1e-4):
    jv = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), jv)
    for f in ("x", "y", "scale"):
        np.testing.assert_allclose(getattr(t, f).numpy()[jv], np.asarray(getattr(j, f))[jv],
                                   rtol=0, atol=tol, err_msg=f)


@pytest.mark.parametrize("lowest_scale", [0.0, 1.0])
@pytest.mark.parametrize("select", ["topk", "approx", "compact"])
def test_detect_on_one_dog_matches_jax(dog, select, lowest_scale):
    # 128 slots: fewer than the candidates, so the selection decides.
    cfg = dataclasses.replace(SIFT, select=select, lowest_scale=lowest_scale,
                              max_pts_per_octave=128)
    j = jdetect.detect(jnp.asarray(dog), cfg, 2.0)
    t = detect.detect(T(dog), interop.config_to_torch(cfg), 2.0)
    n_cand = int(np.asarray(jdetect.detect(jnp.asarray(dog),
                                           dataclasses.replace(cfg, max_pts_per_octave=4096),
                                           2.0).valid).sum())
    assert n_cand > 128 and int(t.valid.sum()) == 128
    _assert_same_detections(t, j)
    if select != "compact":
        # Strongest first, and no ties among the selected responses
        # (the lowest-index rule and XLA's tie order would differ).
        s = np.abs(np.asarray(j.sharpness))
        assert len(np.unique(s)) == len(s)


@pytest.mark.parametrize("select", ["approx", "compact"])
def test_select_from_maps_modes_match_jax(select):
    rng = np.random.default_rng(3)
    H, W = 40, 56
    resp = np.where(rng.random((H, W)) < 0.2, rng.random((H, W)) * 50 + 1.0,
                    -1.0).astype(np.float32)
    aux = rng.normal(size=(6, H, W)).astype(np.float32) * 0.3
    aux[0] = rng.integers(1, 6, (H, W))
    cfg = dataclasses.replace(SIFT, select=select, max_pts_per_octave=64)
    j = jdetect.select_from_maps(jnp.asarray(resp), jnp.asarray(aux), cfg)
    t = detect.select_from_maps(T(resp), T(aux), interop.config_to_torch(cfg))
    assert int(t.valid.sum()) == 64
    _assert_same_detections(t, j, tol=1e-5)


def test_unknown_select_mode_raises():
    cfg = dataclasses.replace(SIFT, select="sorted")
    with pytest.raises(ValueError, match="unknown select"):
        detect.detect(torch.zeros((7, 16, 16)), cfg, 1.0)
    with pytest.raises(ValueError, match="unknown select"):
        frontend.extract_sift(torch.zeros((64, 64)), cfg)


# ---- sift/orient and two-stage descriptors --------------------------------

@pytest.fixture(scope="module")
def keypoints(pair):
    """The JAX XLA route's detections of the first image on its atlas,
    compacted valid-first."""
    img = jnp.asarray(pair["img1"])
    atlas, dets = jfrontend._detect_stage(img, SIFT)
    x, y, s, v = (np.concatenate([np.asarray(getattr(d, f)) for d in dets])
                  for f in ("x", "y", "scale", "valid"))
    order = np.argsort(~v, kind="stable")
    return np.asarray(atlas), x[order], y[order], s[order], v[order]


def test_orientation_histograms_match_jax(keypoints):
    atlas, x, y, s, v = keypoints
    hj = np.asarray(jorient.orientation_histograms(*map(jnp.asarray, (atlas, x, y, s))))
    ht = orient.orientation_histograms(T(atlas), T(x), T(y), T(s)).numpy()
    assert ht.shape == hj.shape == (x.shape[0], 32)
    assert v.sum() > 200
    assert np.abs(ht - hj)[v].max() <= 1e-3 * np.abs(hj[v]).max()


def test_two_stage_descriptors_match_jax(keypoints):
    atlas, x, y, s, v = keypoints
    ori = np.random.default_rng(1).uniform(0, 360, x.shape[0]).astype(np.float32)
    dj = np.asarray(jdescribe.extract_descriptors(*map(jnp.asarray, (atlas, x, y, s, ori))))
    count = torch.tensor(int(v.sum()), dtype=torch.int32)
    raw = sample.descriptor_sample(T(atlas), T(x), T(y), T(s), T(ori), count)
    dt = describe.normalize_descriptors(raw).numpy()
    assert _corr(dt, dj)[v].min() > 0.9999
    assert not dt[~v].any()


# ---- sift/frontend: the four route combinations ---------------------------

@pytest.fixture(scope="module")
def jax_extracts(pair):
    out = {}
    for fused_detect, use_pallas in ROUTES:
        cfg = dataclasses.replace(SIFT, fused_detect=fused_detect, use_pallas=use_pallas)
        out[fused_detect, use_pallas] = jax.tree_util.tree_map(
            np.asarray, jfrontend.extract_sift(jnp.asarray(pair["img1"]), cfg))
    return out


@pytest.mark.parametrize("fused_detect,use_pallas", ROUTES,
                         ids=[f"fused_detect={a},use_pallas={b}" for a, b in ROUTES])
def test_extract_sift_routes_match_jax(pair, jax_extracts, fused_detect, use_pallas):
    cfg = dataclasses.replace(SIFT, fused_detect=fused_detect, use_pallas=use_pallas)
    j = jax_extracts[fused_detect, use_pallas]
    t = interop.to_numpy(frontend.extract_sift(T(pair["img1"]),
                                               interop.config_to_torch(cfg)))
    jk, tk = j.keypoints, t.keypoints
    assert tk.x.shape == jk.x.shape
    nj, nt = int(jk.valid.sum()), int(tk.valid.sum())
    assert nj > 300 and nt == nj
    if use_pallas is False:
        # Two-stage: primaries and duplicates compacted together, the
        # JAX package's slot layout.  The dense detector computes JAX's
        # responses to the last bits, so every slot holds JAX's
        # keypoint; K3's responses differ from the JAX kernel's in the
        # last bits, so two near-equal ones may swap their slots.
        np.testing.assert_array_equal(tk.valid, jk.valid)
        v = jk.valid
        here = (np.hypot(tk.x - jk.x, tk.y - jk.y) <= 0.2) & (
            _corr(t.descriptors, j.descriptors) > 0.999)
        if fused_detect is False:
            assert here[v].all()
            np.testing.assert_array_equal(tk.octave[v], jk.octave[v])
        else:
            assert here[v].mean() >= 0.99
    hits = 0
    kj = {(round(float(a), 1), round(float(b), 1), round(float(o))): i
          for i, (a, b, o, ok) in enumerate(zip(jk.x, jk.y, jk.orientation, jk.valid))
          if ok}
    for i in np.flatnonzero(tk.valid):
        jj = kj.get((round(float(tk.x[i]), 1), round(float(tk.y[i]), 1),
                     round(float(tk.orientation[i]))))
        if jj is not None:
            hits += 1
            assert _corr(t.descriptors[i], j.descriptors[jj]) > 0.999
    assert hits >= 0.95 * nj
    assert not t.descriptors[~tk.valid].any()


def test_pipeline_config_knobs_select_the_same_route(pair, jax_extracts):
    """A JAX PipelineConfig with the three knobs False carries them and
    ``select`` into the port, which then runs the XLA route: its
    two-stage slot layout, where the fused route would put duplicates at
    slot i + K."""
    jcfg = PipelineConfig(sift=dataclasses.replace(SIFT, select="compact"),
                          match=MatchConfig(use_pallas=False))
    tcfg = interop.config_to_torch(jcfg)
    assert (tcfg.sift.fused_detect, tcfg.sift.use_pallas, tcfg.match.use_pallas,
            tcfg.sift.select) == (False, False, False, "compact")
    t = frontend.extract_sift(T(pair["img1"]), tcfg.sift)
    j = jfrontend.extract_sift(jnp.asarray(pair["img1"]), jcfg.sift)
    np.testing.assert_array_equal(t.keypoints.valid.numpy(), np.asarray(j.keypoints.valid))
    n = int(t.keypoints.valid.sum())
    assert bool(t.keypoints.valid[:n].all())   # compacted: no slot i + K layout


# ---- sift/match and parallel/dist_match -----------------------------------

@pytest.fixture(scope="module")
def descriptors(jax_extracts, pair):
    s1 = jax_extracts[False, False]
    s2 = jax_extracts[False, False]._replace(
        descriptors=np.roll(jax_extracts[False, False].descriptors, 7, axis=0))
    return s1.descriptors, s2.descriptors, s2.keypoints.valid


def test_match_descriptors_top2_is_jax_f32(descriptors):
    d1, d2, v2 = descriptors
    bj, sj, ij = map(np.asarray, jmatch.match_descriptors_top2(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v2), chunk=256))
    bt, st, it = match.match_descriptors_top2(T(d1), T(d2), T(v2), chunk=256)
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_allclose(bt.numpy(), bj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.numpy(), sj, rtol=0, atol=1e-5)


def test_match_with_use_pallas_false_is_the_f32_top2(descriptors, jax_extracts):
    """The fault: MatchConfig(use_pallas=False) with bf16=True (the
    default) must give the JAX package's f32 top-2, not bf16 scores."""
    d1, d2, v2 = descriptors
    v1 = jax_extracts[False, False].keypoints.valid
    cfg = MatchConfig(use_pallas=False, bf16=True)
    mj = jax.tree_util.tree_map(np.asarray, jmatch.match(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v1), jnp.asarray(v2), cfg))
    mt = interop.to_numpy(match.match(T(d1), T(d2), T(v1), T(v2),
                                      interop.config_to_torch(cfg)))
    np.testing.assert_array_equal(mt.index, mj.index)
    np.testing.assert_allclose(mt.score, mj.score, rtol=0, atol=1e-5)
    np.testing.assert_allclose(mt.ambiguity[v1], mj.ambiguity[v1], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(mt.valid, mj.valid)


@pytest.fixture(scope="module")
def mesh1():
    with meshmod.make_mesh(1, device="cpu") as mesh:
        yield mesh


def test_dist_match_use_pallas_false_is_the_f32_top2(descriptors, mesh1):
    d1, d2, v2 = descriptors
    bj, sj, ij = map(np.asarray, jmatch.match_descriptors_top2(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(v2)))
    bt, st, it = dist_match.dist_match_top2(T(d1), T(d2), T(v2), mesh1,
                                            use_pallas=False, bf16=True)
    np.testing.assert_array_equal(it.numpy(), ij)
    np.testing.assert_allclose(bt.numpy(), bj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(st.numpy(), sj, rtol=0, atol=1e-5)
    m = dist_match.dist_match(T(d1), T(d2), None, T(v2),
                              MatchConfig(use_pallas=False), mesh=mesh1)
    np.testing.assert_array_equal(m.index.numpy(), ij)


# ---- models/two_view on the XLA route -------------------------------------

def test_two_view_pipeline_on_the_xla_route_matches_jax(pair):
    cfg = PipelineConfig(sift=SIFT, match=MatchConfig(use_pallas=False),
                         ransac=RansacConfig(n_hyps=256, threshold=3e-6, chunk=256),
                         tvote_rounds=0)
    tcfg = interop.config_to_torch(cfg)
    imgs = [jnp.asarray(pair[k]) for k in ("img1", "img2")]
    uv1, uv2, mask = map(np.asarray, jtv.frontend_stage(*imgs, cfg))
    _, _, maskt = two_view.frontend_stage(T(pair["img1"]), T(pair["img2"]), tcfg)
    mj, mt = int(mask.sum()), int(maskt.sum())
    assert mj > 150
    assert abs(mt - mj) <= max(3, 0.02 * mj)
    key = jax.random.PRNGKey(0)
    disp_ok = np.sum((uv1 - uv2) ** 2, -1) > cfg.ransac.min_disparity_px ** 2
    idx = np.asarray(jax.jit(jransac.sample_minimal_sets, static_argnums=(2,))(
        key, jnp.asarray(mask & disp_ok), cfg.ransac.n_hyps))
    rj = jtv.two_view_pipeline(*imgs, jnp.asarray(pair["K"]), key, cfg)
    rt = two_view.two_view_geometry(*interop.to_torch((uv1, uv2, mask)), T(pair["K"]),
                                    tcfg, minimal_sets=interop.to_torch(idx))
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-4)
    assert (rt.inliers.numpy() == np.asarray(rj.inliers)).mean() >= 0.995
