"""Parity: the port's image ops, base chain and detection (K3's plain
version in both modes + top-k selection) against the JAX package.

The JAX side runs ``pallas_detect.detect_maps`` in interpret mode.
Tolerances: blurs agree to f32 rounding of 0..255 intensities (1e-3
absolute); detection decisions compare DoG values against thresholds,
so a candidate can flip where a value sits within rounding of a gate —
counts are held within max(2, 1%) and positions to >= 95% overlap,
the bar of the JAX package's own interpret-mode parity tests.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_pair import synthetic_pair
from sfm_tpu.config import SiftConfig
from sfm_tpu.ops import image as jimage
from sfm_tpu.ops.pallas_detect import detect_maps as jdetect_maps
from sfm_tpu.sift import detect as jdetect
from sfm_tpu.sift import frontend as jfrontend
from sfm_tpu.sift import pyramid as jpyramid
from sfm_tpu_torch import interop
from sfm_tpu_torch.ops import image
from sfm_tpu_torch.ops.detect import (detect_maps, detect_maps_octaves,
                                      detect_maps_plain, octave_groups)
from sfm_tpu_torch.sift import detect, frontend, pyramid
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = torch.as_tensor
CFG = SiftConfig(num_octaves=3, max_pts_per_octave=256)
TCFG = interop.config_to_torch(CFG)   # the port's class


@pytest.fixture(scope="module")
def img():
    return synthetic_pair(96, 160, seed=2)["img1"]


def test_kernels_and_base_chain_match_jax(img):
    for o in range(CFG.num_octaves):
        np.testing.assert_array_equal(pyramid.octave_kernel_bank(TCFG, o),
                                      jpyramid.octave_kernel_bank(CFG, o))
    bj = [np.array(b) for b in jpyramid.base_chain(jnp.asarray(img), CFG)]
    bt = [b.numpy() for b in pyramid.base_chain(T(img), TCFG)]
    assert [b.shape for b in bt] == [b.shape for b in bj]
    for a, b in zip(bt, bj):
        np.testing.assert_allclose(a, b, atol=1e-3)


def test_bilinear_sample_matches_jax(rng, img):
    x = rng.uniform(-3, 165, 300).astype(np.float32)
    y = rng.uniform(-3, 100, 300).astype(np.float32)
    vj = np.array(jimage.bilinear_sample(*map(jnp.asarray, (img, x, y))))
    vt = image.bilinear_sample(*map(T, (img, x, y))).numpy()
    np.testing.assert_allclose(vt, vj, atol=1e-3)


def test_refine_from_coeffs_matches_jax(rng):
    c = rng.normal(size=(10, 500)).astype(np.float32)
    c[4:7] += 2.0 * np.sign(c[4:7])   # mostly well-conditioned Hessians
    oj = jdetect.refine_from_coeffs(*map(jnp.asarray, c))
    ot = detect.refine_from_coeffs(*map(T, c))
    for a, b in zip(ot, oj):
        np.testing.assert_allclose(a.numpy(), np.array(b), rtol=1e-4, atol=1e-5)


def _positions(d):
    v = d.valid.numpy() if isinstance(d.valid, torch.Tensor) else np.array(d.valid)
    return {(round(float(x), 2), round(float(y), 2))
            for x, y, ok in zip(np.asarray(d.x), np.asarray(d.y), v) if ok}


def test_detect_maps_plain_matches_pallas_interpret(img):
    base = pyramid.base_chain(T(img), TCFG)[0].numpy()
    taps = pyramid.octave_kernel_bank(CFG, 0)
    rj, aj = jdetect_maps(
        jnp.asarray(base), taps=tuple(tuple(float(v) for v in r) for r in taps),
        n_scales=CFG.num_scales, thresh=float(CFG.thresh),
        edge_limit=float(CFG.edge_limit), scale_gate=0.0, interpret=True)
    rt, at = detect_maps_plain(T(base), taps, CFG.thresh, CFG.edge_limit)
    rj, aj = np.array(rj), np.array(aj)
    rt, at = rt.numpy(), at.numpy()
    cand_j, cand_t = rj > 0, rt > 0
    n = max(cand_j.sum(), 1)
    assert cand_j.sum() > 50
    assert (cand_j != cand_t).sum() <= max(2, 0.01 * n)
    both = cand_j & cand_t & (aj[0] == at[0])
    # DoG values are differences of near-equal blurs: f32 rounding of
    # the 0..255 blur sums leaves ~1e-4 relative error on them.
    np.testing.assert_allclose(rt[both], rj[both], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(at[:, both], aj[:, both], rtol=1e-3, atol=1e-4)
    # The dispatching wrapper takes the plain version for CPU tensors.
    r2, a2 = detect_maps(T(base), taps, CFG.thresh, CFG.edge_limit)
    np.testing.assert_array_equal(r2.numpy(), rt)

    dj = jdetect.select_from_maps(jnp.asarray(rj), jnp.asarray(aj), CFG)
    dt = detect.select_from_maps(T(rt), T(at), TCFG)
    nj, nt = int(np.array(dj.valid).sum()), int(dt.valid.sum())
    assert abs(nt - nj) <= max(2, 0.01 * nj)
    pj, pt = _positions(dj), _positions(dt)
    assert len(pj & pt) >= 0.95 * len(pj)


@pytest.mark.parametrize("num_scales", [11, 16])
def test_detect_maps_plain_matches_pallas_interpret_past_13_planes(img, num_scales):
    """K3's plain version at 14 and 19 planes (``num_scales`` 11 and 16,
    which the CUDA kernel takes through its run-time-plane route)
    against the JAX kernel in interpret mode, with the bars of
    test_detect_maps_plain_matches_pallas_interpret (rtol 1e-3, atol
    1e-4, flips within max(2, 1%)).  With more, finer planes the DoG
    differences shrink while their f32 rounding does not, so a kept
    pixel whose coefficients miss the bar (one of 22 at 19 planes, by
    1.2e-4) counts against the flip budget, as the gated test counts
    its offsets."""
    cfg = dataclasses.replace(CFG, num_scales=num_scales)
    base = pyramid.base_chain(T(img), interop.config_to_torch(cfg))[0].numpy()
    taps = pyramid.octave_kernel_bank(cfg, 0)
    assert taps.shape == (num_scales + 3, 9)
    rj, aj = jdetect_maps(
        jnp.asarray(base), taps=tuple(tuple(float(v) for v in r) for r in taps),
        n_scales=num_scales, thresh=float(cfg.thresh),
        edge_limit=float(cfg.edge_limit), scale_gate=0.0, interpret=True)
    rt, at = detect_maps_plain(T(base), taps, cfg.thresh, cfg.edge_limit)
    rj, aj, rt, at = np.array(rj), np.array(aj), rt.numpy(), at.numpy()
    cand_j, cand_t = rj > 0, rt > 0
    n = max(cand_j.sum(), 1)
    assert cand_j.sum() > 10
    both = cand_j & cand_t & (aj[0] == at[0])
    ok = (np.isclose(rt, rj, rtol=1e-3, atol=1e-4)
          & np.isclose(at, aj, rtol=1e-3, atol=1e-4).all(0))
    assert (cand_j != cand_t).sum() + (both & ~ok).sum() <= max(2, 0.01 * n)


def test_unsupported_detect_knobs_raise(img):
    base = T(img)
    taps = pyramid.octave_kernel_bank(CFG, 0)
    # "approx" and "compact" are ported (tests/test_torch_xla_route.py);
    # a mode the JAX package does not know raises as it does there.
    with pytest.raises(ValueError, match="unknown select"):
        detect.detect_fused(base, taps, dataclasses.replace(TCFG, select="sorted"), 1.0)
    # The lean mode cannot apply a scale gate (pallas_detect.py:283-284).
    with pytest.raises(ValueError, match="scale_gate"):
        detect.detect_fused(base, taps, dataclasses.replace(
            TCFG, lowest_scale=1.0, detect_lean=True), 1.0)


def _gated_maps(base, taps, gate):
    """The JAX package's non-lean K3 (interpret) and the port's plain
    gated version on the same base."""
    rj, aj = jdetect_maps(
        jnp.asarray(base), taps=tuple(tuple(float(v) for v in r) for r in taps),
        n_scales=CFG.num_scales, thresh=float(CFG.thresh),
        edge_limit=float(CFG.edge_limit), scale_gate=gate, interpret=True,
        lean=False)
    rt, at = detect_maps_plain(T(base), taps, CFG.thresh, CFG.edge_limit,
                               scale_gate=gate, lean=False)
    return np.array(rj), np.array(aj), rt.numpy(), at.numpy()


@pytest.mark.parametrize("gate", [0.0, 1.0, 1.2])
def test_detect_maps_gated_plain_matches_pallas_interpret(img, gate):
    """K3's gated (non-lean) mode: resp and the 6 refined maps (s, pdx,
    pdy, pds, sharpness, edge), the scale gate applied densely (1.0 is
    the frontend's octave-0 gate at lowest_scale=1.0; 1.2 bites here).

    Tolerances: resp, s, sharpness and edge as the lean maps (rtol 1e-3,
    atol 1e-4).  The offsets solve the 3x3 Hessian system, which scales
    the DoG values' ~2e-5 rounding (0..255 blur sums in another order)
    by 1/|Hessian| ~ 10: they are held at rtol 1e-3, atol 1e-3, and a
    pixel where the two sides take the other branch of the ``off > 0.5``
    fallback (a decision within rounding of its threshold, like a
    candidate flip) counts against the same flip budget max(2, 1%)."""
    base = pyramid.base_chain(T(img), TCFG)[0].numpy()
    taps = pyramid.octave_kernel_bank(CFG, 0)
    rj, aj, rt, at = _gated_maps(base, taps, gate)
    assert aj.shape == at.shape == (6, *base.shape)
    cand_j, cand_t = rj > 0, rt > 0
    n = max(cand_j.sum(), 1)
    assert cand_j.sum() > 50
    both = cand_j & cand_t & (aj[0] == at[0])
    for q in (0, 4, 5):   # s, sharpness, edge
        np.testing.assert_allclose(at[q][both], aj[q][both], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(rt[both], rj[both], rtol=1e-3, atol=1e-4)
    off_ok = np.isclose(at[1:4], aj[1:4], rtol=1e-3, atol=1e-3).all(0)
    assert (cand_j != cand_t).sum() + (both & ~off_ok).sum() <= max(2, 0.01 * n)
    # Every kept pixel passes the gate: exp2((s + pds) / S) >= gate.
    scale = np.exp2((at[0] + at[3]) / CFG.num_scales)
    assert (scale[cand_t] >= gate * (1 - 1e-6)).all()
    # The gated maps are the lean coefficients' refinement, bit for bit,
    # wherever both modes keep the same scale.
    rl, al = detect_maps_plain(T(base), taps, CFG.thresh, CFG.edge_limit, lean=True)
    same = cand_t & (rl.numpy() > 0) & (al[0].numpy() == at[0])
    assert same.sum() > 0.9 * cand_t.sum()
    for a, b in zip(at[1:], detect.refine_from_coeffs(*al[1:])):
        np.testing.assert_array_equal(a[same], b.numpy()[same])
    if gate > 1.0:
        assert cand_t.sum() < (rl.numpy() > 0).sum()   # the gate bites
    # The dispatching wrapper takes the plain version for CPU tensors.
    r2, a2 = detect_maps(T(base), taps, CFG.thresh, CFG.edge_limit, gate, False)
    np.testing.assert_array_equal(a2.numpy(), at)


def test_select_from_maps_six_map_layout_matches_jax(img):
    """The gated mode's 6 maps through both packages' selection: the
    same maps give the same detections."""
    base = pyramid.base_chain(T(img), TCFG)[0].numpy()
    taps = pyramid.octave_kernel_bank(CFG, 0)
    rj, aj, _, _ = _gated_maps(base, taps, 1.0)
    dj = jdetect.select_from_maps(jnp.asarray(rj), jnp.asarray(aj), CFG)
    dt = detect.select_from_maps(T(rj), T(aj), TCFG)
    vj, vt = np.array(dj.valid), dt.valid.numpy()
    assert vj.sum() > 50
    np.testing.assert_array_equal(vt, vj)
    for f in ("x", "y", "scale", "sharpness", "edgeness"):
        np.testing.assert_allclose(getattr(dt, f).numpy()[vt],
                                   np.array(getattr(dj, f))[vj], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n,groups", [
    (5, [(0, 5)]), (8, [(0, 8)]), (9, [(0, 8), (8, 9)]),
    (17, [(0, 8), (8, 16), (16, 17)])])
def test_octave_groups_are_launches_of_at_most_8(n, groups):
    assert octave_groups(n) == groups


def test_detect_maps_octaves_cpu_route_is_per_octave_plain(img):
    bases = pyramid.base_chain(T(img), TCFG)
    taps = [pyramid.octave_kernel_bank(TCFG, o) for o in range(len(bases))]
    multi = detect_maps_octaves(bases, taps, CFG.thresh, CFG.edge_limit)
    assert len(multi) == len(bases) == CFG.num_octaves
    for (r, a), b, t in zip(multi, bases, taps):
        rp, ap = detect_maps_plain(b, t, CFG.thresh, CFG.edge_limit)
        assert torch.equal(r, rp) and torch.equal(a, ap)
    with pytest.raises(ValueError):
        detect_maps_octaves(bases, taps[:-1], CFG.thresh, CFG.edge_limit)


@pytest.mark.parametrize("lowest_scale", [0.0, 1.0])
def test_detect_stage_matches_jax(img, lowest_scale):
    """The port's detect stage (base chain, all octaves' maps, per-octave
    top-k, atlas) against the JAX package's Pallas route (interpret);
    with ``lowest_scale`` > 0 both run K3's gated mode, octave o gated at
    ``lowest_scale / 2**o``."""
    jcfg = dataclasses.replace(CFG, use_pallas=True, fused_detect=True,
                               pyramid_pallas=True, lowest_scale=lowest_scale)
    atlas_j, dets_j = jfrontend._detect_stage(jnp.asarray(img), jcfg)
    atlas_t, dets_t = frontend.detect_stage(T(img), interop.config_to_torch(jcfg))
    np.testing.assert_allclose(atlas_t.numpy(), np.array(atlas_j), atol=1e-3)
    assert len(dets_t) == len(dets_j) == CFG.num_octaves
    assert sum(int(np.array(d.valid).sum()) for d in dets_j) > 50
    for dj, dt in zip(dets_j, dets_t):
        nj, nt = int(np.array(dj.valid).sum()), int(dt.valid.sum())
        assert abs(nt - nj) <= max(2, 0.01 * nj)
        pj, pt = _positions(dj), _positions(dt)
        assert len(pj & pt) >= 0.95 * len(pj)
