"""Parity: the port's turntable path (``models/turntable.py``,
``geometry/lie.so3_log``) against the JAX package's, on
``tests/test_turntable.py``'s synthetic rings.

Tolerances: closed forms computed by the same f32 algorithms (so3_log,
the model's poses, undistortion, the model update) to 1e-5 of their
scale; the turntable fit to 1e-5 (its 3 x 3 least squares is solved in
float64 by the port, by an f32 SVD in JAX); the LM Jacobian to 1e-5 of
its largest entry (both forward mode through the same f32 ops).  The
LM loops go through ~100 accept/reject decisions in f32 on each side,
so whole runs are held to the quality they reach (steps to 1e-3 deg,
rms and f to 1e-3 relative) and their track tables exactly; k1 to 2e-3
absolute (2% of the refine's -0.09): in a narrow field of view f and
k1 trade off along a flat valley (the JAX package's own test holds only
k1's sign), where f32 rounding moves the LM's end point along it.
"""

import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.config import PipelineConfig
from sfm_tpu.geometry import lie as jlie
from sfm_tpu.models import turntable as jtt
from sfm_tpu_torch import interop
from sfm_tpu_torch.geometry import lie
from sfm_tpu_torch.models import bundle_adjust as ba
from sfm_tpu_torch.models import turntable as tt
from synthetic_ring import injected_ring
from test_turntable import (C_PX, F_PX, K_SYN, N_FRAMES, STEP, _collapse,
                            _observations, _steps_deg, _true_scene)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = torch.as_tensor


def _np(x):
    return np.array(x)


def _rotations(rng, n, lo, hi):
    """[n, 3, 3] float32 rotations at angles uniform in [lo, hi]."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.uniform(lo, hi, n)
    return _np(jlie.so3_exp(jnp.asarray((axis * ang[:, None]).astype(np.float32))))


@pytest.mark.parametrize("lo,hi", [(0.0, 3.0), (0.0, 1e-4), (3.0, math.pi - 1e-3)],
                         ids=["random", "series", "past_3"])
def test_so3_log_matches_jax(lo, hi):
    """All three branches; compared through so3_exp (past 3.0 the
    diagonal extraction is sign-ambiguous near pi), and the log vectors
    themselves away from pi."""
    R = _rotations(np.random.default_rng(int(hi * 1e4)), 256, lo, hi)
    w = lie.so3_log(T(R))
    wj = _np(jlie.so3_log(jnp.asarray(R)))
    np.testing.assert_allclose(lie.so3_exp(w).numpy(), _np(jlie.so3_exp(jnp.asarray(wj))),
                               atol=2e-5)
    np.testing.assert_allclose(lie.so3_exp(w).numpy(), R, atol=5e-3 if lo >= 3.0 else 2e-5)
    if lo < 3.0:
        np.testing.assert_allclose(w.numpy(), wj, atol=2e-5)


def _model(rng):
    axis = rng.normal(size=3).astype(np.float32)
    axis /= np.linalg.norm(axis)
    R0 = _rotations(rng, 1, 0.2, 1.0)[0]
    return jtt.TurntableModel(axis=jnp.asarray(axis), center=jnp.asarray(
        rng.normal(size=3).astype(np.float32)), R0=jnp.asarray(R0),
        C0=jnp.asarray(rng.normal(size=3).astype(np.float32) * 5),
        sign=jnp.asarray(np.float32(-1.0)))


def _to_port(model):
    return tt.TurntableModel(*(T(_np(v)) for v in model))


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_turntable_poses_and_params_to_model_match_jax(rng, sign):
    mj = _model(rng)._replace(sign=jnp.asarray(np.float32(sign)))
    phases = np.linspace(0, 2 * np.pi, 13, dtype=np.float32)[:-1]
    Rj, tj = jtt.turntable_poses(mj, jnp.asarray(phases))
    R, t = tt.turntable_poses(_to_port(mj), T(phases))
    np.testing.assert_allclose(R.numpy(), _np(Rj), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), _np(tj), atol=1e-5 * np.abs(_np(tj)).max())
    p = rng.normal(scale=0.05, size=5).astype(np.float32)
    m2j = jtt._params_to_model(jnp.asarray(p), mj)
    m2 = tt._params_to_model(T(p), _to_port(mj))
    for a, b in zip(m2, m2j):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-6)


@pytest.mark.parametrize("collapsed", [False, True], ids=["true_ring", "collapsed"])
def test_fit_turntable_matches_jax(collapsed):
    R, t, _ = _true_scene(np.random.default_rng(0))
    if collapsed:
        R, t = _collapse(R, t)
    for close_loop in (False, True):
        mj = jtt.fit_turntable(jnp.asarray(R), jnp.asarray(t), close_loop=close_loop)
        m = tt.fit_turntable(T(R), T(t), close_loop=close_loop)
        for name, a, b in zip(m._fields, m, mj):
            np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-5 * max(
                1.0, np.abs(_np(b)).max()), err_msg=name)


def test_undistort_pixels_matches_jax(rng):
    uv = rng.uniform([0, 0], [720, 576], size=(500, 2)).astype(np.float32)
    c = np.array(C_PX, np.float32)
    for k1, k2 in ((-0.45, 0.0), (0.3, 2.0)):
        ref = _np(jtt.undistort_pixels(jnp.asarray(uv), jnp.asarray(c), 2360.0, k1, k2))
        out = tt.undistort_pixels(T(uv), T(c), 2360.0, k1, k2).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6)


def _jax_residuals(phases, cam_idx, pt_idx, uv_pix, f0, c):
    """The JAX package's refine_turntable residual closure
    (``sfm_tpu/models/turntable.py:224-234``), as a function of p."""
    def residuals(p, X, base):
        m = jtt._params_to_model(p[:5], base)
        R, t = jtt.turntable_poses(m, phases)
        f, k1, k2 = f0 * jnp.exp(p[5]), p[6], p[7]
        Xc = jnp.einsum("oij,oj->oi", R[cam_idx], X[pt_idx]) + t[cam_idx]
        z = Xc[..., 2:3]
        z = jnp.where(jnp.abs(z) < 1e-8, 1e-8, z)
        xn = Xc[..., :2] / z
        r2 = jnp.sum(xn * xn, axis=-1, keepdims=True)
        xd = xn * (1.0 + k1 * r2 + k2 * r2 * r2)
        return xd * f + c - uv_pix
    return residuals


@pytest.mark.parametrize("at", ["zero", "random"])
def test_lm_jacobian_matches_jax_jacfwd(at):
    """The refine LM's Jacobian by torch.func.jacfwd against jax.jacfwd,
    at p[:5] = 0 (so3_exp's series branch, where every round starts)
    and at a random p; finite, and to 1e-5 of its largest entry."""
    rng = np.random.default_rng(4)
    R, t, X = _true_scene(rng)
    ci, pi, _, uv_pix, _ = _observations(R, t, X, rng, k1=-0.15)
    base = jtt.fit_turntable(jnp.asarray(R), jnp.asarray(t))
    p = np.zeros(8, np.float32)
    p[5:7] = (0.02, -0.1)
    if at == "random":
        p = rng.normal(scale=0.02, size=8).astype(np.float32)
    phases = (2.0 * np.pi / N_FRAMES) * np.arange(N_FRAMES, dtype=np.float32)
    c = np.array(C_PX, np.float32)
    res_j = _jax_residuals(jnp.asarray(phases), ci, pi, uv_pix, F_PX, jnp.asarray(c))
    Jj = _np(jax.jacfwd(res_j)(jnp.asarray(p), jnp.asarray(X), base))
    args = (T(X), _to_port(base), T(phases), T(_np(ci)).long(), T(_np(pi)).long(),
            T(_np(uv_pix)), torch.tensor(F_PX), T(c))
    J = torch.func.jacfwd(tt._pixel_residuals)(T(p), *args).numpy()
    r = tt._pixel_residuals(T(p), *args).numpy()
    assert np.isfinite(J).all()
    np.testing.assert_allclose(r, _np(res_j(jnp.asarray(p), jnp.asarray(X), base)),
                               atol=1e-3)
    np.testing.assert_allclose(J, Jj, atol=1e-5 * np.abs(Jj).max())


def test_refine_turntable_matches_jax_on_a_collapsed_chain():
    """tests/test_turntable.py's collapsed 12-frame chain (k1 = -0.15),
    from the same fitted model."""
    rng = np.random.default_rng(3)
    R, t, X = _true_scene(rng)
    ci, pi, _, uv_pix, mask = _observations(R, t, X, rng, k1=-0.15)
    Rc, tc = _collapse(R, t)
    mj = jtt.fit_turntable(jnp.asarray(Rc), jnp.asarray(tc))
    kw = dict(n_frames=N_FRAMES, n_points=X.shape[0], iters=12, tri_rounds=3)
    outj = jtt.refine_turntable(mj, ci, pi, uv_pix, mask, K_SYN, **kw)
    out = tt.refine_turntable(_to_port(mj), T(_np(ci)).long(), T(_np(pi)).long(),
                              T(_np(uv_pix)), T(_np(mask)), K_SYN, **kw)
    (mj2, intrj, Rj, tj, Xj, keepj, rmsj), (m2, intr, R2, t2, X2, keep, rms) = outj, out
    ss, ssj = _steps_deg(R2.numpy()), _steps_deg(_np(Rj))
    np.testing.assert_allclose(ss, ssj, atol=1e-3)
    assert abs(ss.mean() - math.degrees(STEP)) < 0.15
    np.testing.assert_array_equal(keep.numpy(), _np(keepj))
    assert float(rms) == pytest.approx(float(rmsj), rel=1e-3)
    assert float(intr[0]) == pytest.approx(float(intrj[0]), rel=1e-3)
    assert float(intr[1]) == pytest.approx(float(intrj[1]), abs=2e-3)
    assert float(intr[2]) == float(intrj[2]) == 0.0     # k2 frozen
    np.testing.assert_allclose(m2.axis.numpy(), _np(mj2.axis), atol=1e-4)


def _feats(frames, xp):
    return [types.SimpleNamespace(
        keypoints=types.SimpleNamespace(x=xp(f["x"]), y=xp(f["y"]), valid=xp(f["valid"])),
        descriptors=xp(f["descriptors"])) for f in frames]


@pytest.fixture(scope="module")
def injected(tmp_path_factory):
    """The injected ring (``synthetic_ring.injected_ring``: the draws of
    tests/test_turntable.py's end-to-end test) and the JAX package's
    reconstruct_turntable on it, its free-BA stage dumped
    (SFM_TPU_TT_DUMP) to ``jax_dump.npz``."""
    frames, Rc, tc, R_gt, _ = injected_ring()
    d = tmp_path_factory.mktemp("tt")
    os.environ["SFM_TPU_TT_DUMP"] = str(d / "jax_dump.npz")
    try:
        res = jtt.reconstruct_turntable(_feats(frames, jnp.asarray), Rc, tc, K_SYN,
                                        PipelineConfig(),
                                        pose_valid=np.ones(N_FRAMES, bool))
    finally:
        del os.environ["SFM_TPU_TT_DUMP"]
    return frames, Rc, tc, R_gt, res, d


def test_reconstruct_turntable_matches_jax_end_to_end(injected, monkeypatch):
    frames, Rc, tc, _, rj, d = injected
    monkeypatch.setenv("SFM_TPU_TT_DUMP", str(d / "port_dump.npz"))
    r = tt.reconstruct_turntable(_feats(frames, T), Rc, tc, K_SYN,
                                 interop.config_to_torch(PipelineConfig()),
                                 pose_valid=np.ones(N_FRAMES, bool))
    assert r.tracks.n_tracks == rj.tracks.n_tracks
    np.testing.assert_array_equal(r.tracks.cam_idx.numpy(), _np(rj.tracks.cam_idx))
    np.testing.assert_array_equal(r.tracks.pt_idx.numpy(), _np(rj.tracks.pt_idx))
    np.testing.assert_array_equal(r.tracks.uv_pix.numpy(), _np(rj.tracks.uv_pix))
    ss, ssj = r.step_deg.numpy(), _np(rj.step_deg)
    np.testing.assert_allclose(ss, ssj, atol=1e-3)
    assert r.total_deg == pytest.approx(rj.total_deg, abs=1e-2)
    assert abs(ss.mean() - math.degrees(STEP)) < 0.2 and ss.std() < 0.3
    assert r.rms_px == pytest.approx(rj.rms_px, rel=1e-3)
    assert r.f == pytest.approx(rj.f, rel=1e-4)
    assert r.k1 == pytest.approx(rj.k1, abs=2e-3)
    assert abs(int(r.keep.sum()) - int(_np(rj.keep).sum())) <= 2
    assert r.R.dtype == torch.float32 and r.R.device.type == "cpu"
    # The free-BA dumps: the same keys and dtypes, equal tables, the
    # pinned LM's poses to 1e-4.
    a, b = np.load(d / "port_dump.npz"), np.load(d / "jax_dump.npz")
    assert set(a.files) == set(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype, k
        if a[k].dtype.kind in "biu":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_allclose(a[k], b[k], atol=1e-4, err_msg=k)


def test_free_ba_problem_replays_a_jax_dump(injected):
    """free_ba_problem rebuilds the JAX run's first free-BA stage from its
    dump; run_ba on it lowers the cost by the stage's Huber width."""
    *_, d = injected
    R, t, X, problem, delta = tt.free_ba_problem(d / "jax_dump.npz", "cpu")
    dump = np.load(d / "jax_dump.npz")
    assert delta == pytest.approx(8.0 / float(dump["f0"]))
    assert not bool(problem.fixed.any()) and problem.cam_idx.dtype == torch.int64
    assert int(problem.mask.sum()) > 0.8 * len(dump["mask"])
    _, costs = ba.run_ba(R, t, X, problem, iters=5, huber_delta=delta)
    assert float(costs[-1]) < float(costs[0])


def test_reconstruct_turntable_refuses_a_chain_without_its_bootstrap_pair(injected):
    frames, Rc, tc, *_ = injected
    with pytest.raises(ValueError):
        tt.reconstruct_turntable(_feats(frames, T), Rc, tc, K_SYN,
                                 interop.config_to_torch(PipelineConfig()),
                                 pose_valid=np.array([True, False] + [True] * 10))
