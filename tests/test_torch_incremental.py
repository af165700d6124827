"""Parity: the port's incremental SfM (``models/incremental.py``) against
the JAX package's, on ``tests/test_incremental.py:_synthetic_orbit``
(5 frames, 256 keypoint slots, injected features), and the 12-frame
sequence renderer (``tests/synthetic_sequence.py``).

Tolerances: integer tables (point ids, masks, counts, BA problems) are
held exactly; coordinates built by the same f32 algorithms to 1e-4.
With the JAX draws injected, one registration or closure step gives the
same tables, and so does a whole run (its poses to 1e-5 / 1e-3, its
points to 1e-3: f32 through ~20 RANSAC and LM decisions on both sides).
On a one-rank mesh (the sharded matcher and the partitioned global BA,
an in-process gloo group) a whole run with the JAX draws is held to the
same bars against the JAX package's run on ``make_mesh(1)``.
With its own generator's draws, a whole run is held to the quality bars
of the JAX package's own test (every pose, ATE < 0.05, < 1 px) in each
package and to stated factors of JAX's ATE and point count.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.config import PipelineConfig, RansacConfig
from sfm_tpu.geometry import camera as jcamera
from sfm_tpu.geometry import ransac as jransac
from sfm_tpu.models import incremental as jinc
from sfm_tpu.parallel import mesh as jmeshmod
from sfm_tpu.sift import match as jmatch
from sfm_tpu.utils import metrics as jmetrics
from sfm_tpu_torch import interop
from sfm_tpu_torch.models import incremental as inc
from sfm_tpu_torch.parallel import mesh as meshmod
from synthetic_sequence import (arc_poses, orbit_features, synthetic_sequence,
                                view_overlap)
from test_incremental import _synthetic_orbit
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = torch.as_tensor
JCFG = PipelineConfig(ransac=RansacConfig(n_hyps=512, threshold=3e-6, chunk=128))
TCFG = interop.config_to_torch(JCFG)
sample_minimal_sets_jax = jax.jit(jransac.sample_minimal_sets, static_argnums=(2, 3))


@pytest.fixture(scope="module")
def orbit():
    """The 5-frame orbit, the JAX package's run_incremental on it, and
    the minimal sets that run drew, in order (bootstrap [n_hyps, 8],
    then frame 2, 3, 4's PnP [n_hyps, 6]).  The draws are read by a
    debug callback on ``sample_minimal_sets``, traced afresh: the caches
    are cleared before the run, and after it, so that no later trace
    keeps the callback."""
    feats, K, R_gt, t_gt = _synthetic_orbit(n_images=5)
    draws = []
    sample = jransac.sample_minimal_sets

    def recorded(key, mask, n_hyps, k=8):
        idx = sample(key, mask, n_hyps, k)
        jax.debug.callback(lambda v: draws.append(np.array(v)), idx, ordered=True)
        return idx

    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jransac, "sample_minimal_sets", recorded)
        res = jinc.run_incremental([None] * 5, K, JCFG, ba_iters=12, feats=feats)
        jax.block_until_ready(res)
        jax.effects_barrier()
    jax.clear_caches()
    return feats, K, R_gt, t_gt, res, draws


def _np(x):
    return np.array(x)


def _assert_state_equal(st, sj, atol=1e-4):
    """Port MapState against the JAX one: tables exactly, floats to atol."""
    for f in ("X_valid", "n_points", "pose_valid", "point_id"):
        np.testing.assert_array_equal(_np(getattr(st, f)), _np(getattr(sj, f)), f)
    for f in ("X", "R", "t"):
        np.testing.assert_allclose(_np(getattr(st, f)), _np(getattr(sj, f)),
                                   atol=atol, err_msg=f)


def test_append_points_matches_jax_and_drops_past_capacity(rng):
    sj = jinc._empty_state(3, 10, 8)._replace(n_points=jnp.int32(5))
    X_new = rng.normal(size=(10, 3)).astype(np.float32)
    mask = np.zeros(10, bool)
    mask[[0, 2, 3, 6, 9]] = True            # 5 new points, 3 slots left
    sj2, idj = jinc._append_points(sj, jnp.asarray(X_new), jnp.asarray(mask))
    st2, idt = inc._append_points(interop.to_torch(sj), T(X_new), T(mask))
    np.testing.assert_array_equal(idt.numpy(), _np(idj))
    np.testing.assert_array_equal(idt.numpy()[[0, 2, 3, 6, 9]], [5, 6, 7, -1, -1])
    _assert_state_equal(st2, sj2, atol=0)
    assert int(st2.n_points) == 8


@pytest.mark.parametrize("dup", [0, 3, 12])
def test_scatter_rules_match_xla(rng, dup):
    """_set_last against XLA's scatter-set on the CPU (updates applied in
    order: the last writer of a slot wins; the capacity index dropped),
    with ``dup`` forced duplicate targets; _set_rows against the same
    with unique targets."""
    K, n = 16, 24
    idx = rng.integers(0, K, n)
    idx[1:1 + dup] = idx[0]                  # forced duplicates of slot idx[0]
    keep = rng.random(n) < 0.8
    keep[:1 + dup] = True
    vals = rng.integers(0, 1000, n)
    dst = rng.integers(-1, 50, K)
    ref = _np(jnp.asarray(dst).at[jnp.where(keep, idx, K)].set(
        jnp.asarray(vals), mode="drop"))
    out = inc._set_last(T(dst), T(idx), T(vals), T(keep)).numpy()
    np.testing.assert_array_equal(out, ref)
    if dup:
        assert out[idx[0]] == vals[dup]      # the last of the duplicates
    uniq = rng.permutation(K)[:10]
    slot = np.where(rng.random(10) < 0.7, uniq, K)
    rows = rng.normal(size=(10, 3)).astype(np.float32)
    base = rng.normal(size=(K, 3)).astype(np.float32)
    ref = _np(jnp.asarray(base).at[jnp.asarray(slot)].set(jnp.asarray(rows),
                                                         mode="drop"))
    np.testing.assert_array_equal(inc._set_rows(T(base), T(slot), T(rows)).numpy(), ref)


@pytest.mark.parametrize("n", [1, 2, 7, 10])
def test_median_matches_jnp_nanmedian(rng, n):
    """Even counts average the two middle values (jnp.nanmedian), where
    torch.nanmedian would take the lower one."""
    x = rng.random(32).astype(np.float32)
    mask = np.zeros(32, bool)
    mask[rng.permutation(32)[:n]] = True
    ref = float(jnp.nanmedian(jnp.where(jnp.asarray(mask), jnp.asarray(x), jnp.nan)))
    got = float(inc._median(T(x), T(mask)))
    assert got == pytest.approx(ref, rel=1e-6)
    if n % 2 == 0:
        s = np.sort(x[mask])
        assert got == pytest.approx((s[n // 2 - 1] + s[n // 2]) / 2, rel=1e-6)
        assert got != float(torch.nanmedian(torch.where(T(mask), T(x), float("nan"))))
    assert math.isnan(float(inc._median(T(x), T(np.zeros(32, bool)))))


def _norm(feats, K):
    K_inv = jcamera.inv_intrinsics(jnp.asarray(K))
    uv = jnp.stack([jnp.stack([f.keypoints.x, f.keypoints.y], -1) for f in feats])
    kpv = jnp.stack([f.keypoints.valid for f in feats])
    return uv, kpv, K_inv, [jcamera.normalize_points(uv[i], K_inv)
                            for i in range(len(feats))]


def test_build_ba_problem_and_window_problem_match_jax(orbit):
    feats, K, _, _, res, _ = orbit
    uv, kpv, K_inv, _ = _norm(feats, K)
    pj = jinc.build_ba_problem(res.state, uv, kpv, K_inv)
    pt = inc.build_ba_problem(interop.to_torch(res.state), T(_np(uv)), T(_np(kpv)),
                              T(_np(K_inv)))
    for f in ("cam_idx", "pt_idx", "mask", "fixed"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(), _np(getattr(pj, f)), f)
    np.testing.assert_allclose(pt.uv.numpy(), _np(pj.uv), rtol=1e-6, atol=1e-7)
    assert int(pt.mask.sum()) > 500
    # A window over cameras 2-4 capped below its own observations plus
    # anchors: the cap sheds anchor terms first.
    fixed = pj.fixed | (jnp.arange(5) < 2)
    pj = pj._replace(fixed=fixed)
    pt = pt._replace(fixed=T(_np(fixed)))
    for cap in (600, 1000):
        wj, oj, sj = jinc._window_problem(pj, res.state.X_valid, jnp.int32(2),
                                          jnp.int32(4), cap)
        wt, ot, st = inc._window_problem(pt, T(_np(res.state.X_valid)), 2, 4, cap)
        for f in ("cam_idx", "pt_idx", "mask", "fixed"):
            np.testing.assert_array_equal(getattr(wt, f).numpy(), _np(getattr(wj, f)), f)
        np.testing.assert_array_equal(wt.uv.numpy(), _np(wj.uv))
        np.testing.assert_array_equal(ot.numpy(), _np(oj))
        np.testing.assert_array_equal(st.numpy(), _np(sj))


def _registration_inputs(feats, K, state, cur, prev):
    uv, kpv, _, xn = _norm(feats, K)
    midx, mok = [], []
    for p in prev:
        m = jmatch.match(feats[p].descriptors, feats[cur].descriptors,
                         feats[p].keypoints.valid, feats[cur].keypoints.valid)
        midx.append(_np(m.index))
        mok.append(_np(m.valid & kpv[p] & kpv[cur][m.index]))
    return (_np(xn[cur]), np.stack([_np(xn[p]) for p in prev]), np.stack(midx),
            np.stack(mok))


@pytest.mark.parametrize("forced_duplicates", [False, True])
def test_register_image_matches_jax(orbit, forced_duplicates):
    """One registration of frame 4 against frames 3, 2, 1 on the JAX
    run's map, with JAX's PnP draws injected.  With forced duplicates,
    slots of frame 3 that carry a copy of a point (same coordinates, a
    new id) aim at the same frame-4 slot as the original's: both are
    PnP inliers, and the later slot's id must win, as in XLA."""
    feats, K, _, _, res, _ = orbit
    cur, prev = 4, [3, 2, 1]
    x_cur, x_prev, midx, mok = _registration_inputs(feats, K, res.state, cur, prev)
    st = {f: _np(v).copy() for f, v in res.state._asdict().items()}
    if forced_duplicates:
        pid3 = st["point_id"][3]
        src = np.flatnonzero((pid3 >= 0) & mok[0])[:20]
        spare = np.flatnonzero((pid3 < 0) & ~mok[0])[:20]
        n0 = int(st["n_points"])
        for k, (a, b) in enumerate(zip(src, spare)):
            lo, hi = min(a, b), max(a, b)      # the copy sits in the later slot
            new = n0 + k
            st["X"][new] = st["X"][pid3[a]]
            st["X_valid"][new] = True
            pid3[hi], pid3[lo] = new, pid3[a]
            midx[0][hi] = midx[0][lo] = midx[0][a]
            mok[0][hi] = mok[0][lo] = True
        st["n_points"] = np.int32(n0 + len(src))
    sj = jinc.MapState(**{f: jnp.asarray(v) for f, v in st.items()})
    corr = ((st["point_id"][prev] >= 0) & mok
            & st["X_valid"][np.maximum(st["point_id"][prev], 0)])
    key = jax.random.PRNGKey(11)
    sets = _np(sample_minimal_sets_jax(key, jnp.asarray(corr.reshape(-1)),
                                       JCFG.ransac.n_hyps, 6))
    sj2, nj = jinc._register_image(sj, cur, jnp.asarray(x_cur), jnp.asarray(prev),
                                   jnp.asarray(x_prev), jnp.asarray(midx),
                                   jnp.asarray(mok), key, JCFG)
    st2, nt = inc._register_image(interop.to_torch(sj), cur, T(x_cur), prev,
                                  T(x_prev), T(midx.astype(np.int64)), T(mok), TCFG,
                                  minimal_sets=T(sets))
    assert int(nt) == int(nj) > 100
    _assert_state_equal(st2, sj2)
    if forced_duplicates:
        won = _np(sj2.point_id)[cur][midx[0][src]]
        assert (won >= n0).sum() >= 10        # the copies' ids won their slots


def test_apply_closure_matches_jax(orbit):
    """Closure (0, 4) on the JAX run's map: merges, inherits and new
    tracks exactly as JAX reconciles them."""
    feats, K, _, _, res, _ = orbit
    uv, kpv, _, xn = _norm(feats, K)
    m = jmatch.match(feats[0].descriptors, feats[4].descriptors,
                     feats[0].keypoints.valid, feats[4].keypoints.valid)
    ok = m.valid & kpv[0] & kpv[4][m.index]
    gate = JCFG.ransac.threshold * 4 * 64.0
    sj, nj = jinc._apply_closure(res.state, jnp.int32(0), jnp.int32(4), xn[0], xn[4],
                                 m.index, ok, jnp.float32(gate), JCFG)
    st, nt = inc._apply_closure(interop.to_torch(res.state), 0, 4, T(_np(xn[0])),
                                T(_np(xn[4])), T(_np(m.index)).long(), T(_np(ok)),
                                gate)
    assert int(nt) == int(nj) > 0
    _assert_state_equal(st, sj)


def test_run_incremental_with_jax_draws_matches_jax(orbit):
    """A whole run with the JAX run's draws injected: the same tables,
    poses and points as JAX's (measured on the CPU: R 2.7e-6, t 8.2e-5,
    X 2.4e-4), the same BA costs and reprojection error."""
    feats, K, _, _, rj, draws = orbit
    assert [d.shape[1] for d in draws] == [8, 6, 6, 6]
    sets = {i: T(d) for i, d in zip([0, 2, 3, 4], draws)}
    rt = inc.run_incremental([None] * 5, K, TCFG, ba_iters=12,
                             feats=[interop.to_torch(f) for f in feats],
                             minimal_sets=sets)
    for f in ("X_valid", "n_points", "pose_valid", "point_id"):
        np.testing.assert_array_equal(_np(getattr(rt.state, f)),
                                      _np(getattr(rj.state, f)), f)
    np.testing.assert_allclose(_np(rt.state.R), _np(rj.state.R), atol=1e-5)
    np.testing.assert_allclose(_np(rt.state.t), _np(rj.state.t), atol=1e-3)
    np.testing.assert_allclose(_np(rt.state.X), _np(rj.state.X), atol=1e-3)
    np.testing.assert_allclose(_np(rt.ba_costs), _np(rj.ba_costs), rtol=1e-4)
    assert math.isclose(float(rt.mean_reproj), float(rj.mean_reproj), rel_tol=1e-4)


def test_run_incremental_matches_jax_quality(orbit):
    feats, K, R_gt, t_gt, rj, _ = orbit
    rt = inc.run_incremental([None] * 5, K, TCFG, ba_iters=12,
                             feats=[interop.to_torch(f) for f in feats])
    out = {}
    for name, r in (("jax", rj), ("port", rt)):
        st = r.state
        assert _np(st.pose_valid).all(), name
        ate, _ = jmetrics.ate_rmse(_np(st.R), _np(st.t), R_gt, t_gt)
        px = math.sqrt(float(r.mean_reproj) / 2) * 500.0
        assert ate < 0.05 and px < 1.0, (name, ate, px)
        costs = _np(r.ba_costs)
        assert np.isfinite(costs).all() and costs[-1] <= costs[0], name
        out[name] = (ate, int(_np(st.X_valid).sum()))
    # Measured: ATE 0.0045 (JAX) / 0.0026 (port), 227 / 225 points.
    assert out["port"][0] <= 2.0 * out["jax"][0]
    assert out["port"][1] >= 0.9 * out["jax"][1]
    assert rt.state.point_id.dtype == torch.int64


def test_run_incremental_on_a_mesh_matches_jax(orbit):
    """A whole run on a one-rank mesh (in-process gloo group: the sharded
    matcher and the partitioned global BA) with the JAX run's draws
    injected, against the JAX package's run on ``make_mesh(1)`` at the
    bars of the run without a mesh above."""
    feats, K, _, _, _, draws = orbit
    rj = jinc.run_incremental([None] * 5, K, JCFG, ba_iters=12, feats=feats,
                              mesh=jmeshmod.make_mesh(1))
    sets = {i: T(d) for i, d in zip([0, 2, 3, 4], draws)}
    with meshmod.make_mesh(1, device="cpu") as mesh:
        rt = inc.run_incremental([None] * 5, K, TCFG, ba_iters=12,
                                 feats=[interop.to_torch(f) for f in feats],
                                 minimal_sets=sets, mesh=mesh)
    for f in ("X_valid", "n_points", "pose_valid", "point_id"):
        np.testing.assert_array_equal(_np(getattr(rt.state, f)),
                                      _np(getattr(rj.state, f)), f)
    np.testing.assert_allclose(_np(rt.state.R), _np(rj.state.R), atol=1e-5)
    np.testing.assert_allclose(_np(rt.state.t), _np(rj.state.t), atol=1e-3)
    np.testing.assert_allclose(_np(rt.state.X), _np(rj.state.X), atol=1e-3)
    np.testing.assert_allclose(_np(rt.ba_costs), _np(rj.ba_costs), rtol=1e-4)
    assert math.isclose(float(rt.mean_reproj), float(rj.mean_reproj), rel_tol=1e-4)


def test_synthetic_sequence_renders_the_arc():
    seq = synthetic_sequence(48, 60, with_scene=True)
    imgs = seq["images"]
    assert imgs.shape == (12, 48, 60) and imgs.dtype == np.float32
    assert np.isfinite(imgs).all() and imgs.min() >= 0 and imgs.max() <= 255
    assert imgs.std(axis=(1, 2)).min() > 10           # textured, not blank
    R, t = arc_poses()
    np.testing.assert_allclose(seq["R"], R, atol=1e-6)
    np.testing.assert_allclose(seq["t"], t, atol=1e-6)
    np.testing.assert_allclose(R[0], np.eye(3), atol=1e-12)
    np.testing.assert_allclose(np.einsum("nij,nkj->nik", R, R),
                               np.broadcast_to(np.eye(3), R.shape), atol=1e-12)
    C = -np.einsum("nji,nj->ni", R, t)                # centres 7 from CENTER, 4 deg apart
    np.testing.assert_allclose(np.linalg.norm(C - [0, 0, 7], axis=1), 7.0, atol=1e-9)
    step = np.degrees(np.arccos(np.clip(np.einsum("ni,ni->n", C[:-1] - [0, 0, 7],
                                                  C[1:] - [0, 0, 7]) / 49.0, -1, 1)))
    np.testing.assert_allclose(step, 4.0, atol=1e-6)
    K = seq["K"].astype(np.float64)
    planes = seq["scene"]
    assert view_overlap(planes, K, R[0], t[0], R[1], t[1], 48, 60, 2) > 0.9
    assert view_overlap(planes, K, R[0], t[0], R[11], t[11], 48, 60, 2) > 0.7


def test_orbit_features_equal_the_jax_tests_orbit():
    """The numpy orbit (for the card's tests, which run without jax) is
    _synthetic_orbit's."""
    feats, K, R_gt, t_gt = _synthetic_orbit(n_images=5)
    frames, K2, R2, t2 = orbit_features(n_images=5)
    np.testing.assert_array_equal(K2, K)
    np.testing.assert_allclose(R2, R_gt, atol=1e-12)
    np.testing.assert_allclose(t2, t_gt, atol=1e-12)
    for f, fr in zip(feats, frames):
        np.testing.assert_array_equal(fr["x"], _np(f.keypoints.x))
        np.testing.assert_array_equal(fr["y"], _np(f.keypoints.y))
        np.testing.assert_array_equal(fr["valid"], _np(f.keypoints.valid))
        np.testing.assert_array_equal(fr["descriptors"], _np(f.descriptors))
