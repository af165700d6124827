"""Parity: the port's PnP (``sfm_tpu_torch/geometry/pnp.py``) against the
JAX package's on the same seeded numpy inputs.

Tolerances: both sides run the same f32 algorithms (ridge inverse
iteration, fixed-sweep Jacobi SVD, damped Gauss-Newton); the port
writes the Jacobians out where JAX takes ``jacfwd``, and the two sum in
different orders, so weighted DLT fits agree to 2e-5 (minimal 6-point
sets, singular to f32 rounding, to 2e-3), squared residuals to 1e-5
relative or 1e-9 absolute (f32 cancellation in pred - obs), a polished
pose to 1e-5 and RANSAC's pose to 1e-4.  With the JAX draws injected
the inlier masks are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import rot
from sfm_tpu.geometry import pnp as jpnp
from sfm_tpu.geometry import ransac as jransac
from sfm_tpu_torch.geometry import pnp
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = torch.as_tensor
sample_minimal_sets_jax = jax.jit(jransac.sample_minimal_sets, static_argnums=(2, 3))


def _scene(rng, n=100, noise=0.0, outliers=0):
    R = rot([0.2, 1.0, 0.1], 0.4).astype(np.float32)
    t = np.array([0.3, -0.2, 0.5], np.float32)
    X = rng.uniform([-1, -1, 3], [1, 1, 7], size=(n, 3)).astype(np.float32)
    Xc = X @ R.T + t
    x = (Xc / Xc[:, 2:3]).astype(np.float32)
    if noise:
        x[:, :2] += rng.normal(scale=noise, size=(n, 2)).astype(np.float32)
    if outliers:
        x[:outliers, :2] = rng.uniform(-0.4, 0.4, size=(outliers, 2))
    return x, X, R, t


def _conditioned(X):
    c = X.mean(0)
    return ((X - c) / np.linalg.norm(X - c, axis=1).mean()).astype(np.float32)


def test_pnp_dlt_matches_jax(rng):
    # A weighted all-point fit, then a batch of exact 6-point minimal
    # systems: their 12 x 12 Gram matrices are singular to f32 rounding,
    # so the two LU factorizations' ridge inverse iterations part at
    # ~1e-4 and the poses at up to 2e-3 (both within 1e-2 of the truth),
    # and XLA's LU may return NaN for one (a hypothesis that then scores
    # no inliers) where LAPACK's does not.
    x, X, R, t = _scene(rng, n=60, noise=2e-4)
    Xn = _conditioned(X)
    w = (rng.random(60) > 0.2).astype(np.float32)
    Rj, tj = map(np.array, jpnp.pnp_dlt(jnp.asarray(x), jnp.asarray(Xn), jnp.asarray(w)))
    Rt, tt = pnp.pnp_dlt(T(x), T(Xn), T(w))
    np.testing.assert_allclose(Rt.numpy(), Rj, atol=2e-5)
    np.testing.assert_allclose(tt.numpy(), tj, atol=2e-5)
    x, X, R, _ = _scene(rng, n=60)
    Xn = _conditioned(X)
    idx = np.stack([rng.choice(60, 6, replace=False) for _ in range(8)])
    Rj, tj = map(np.array, jpnp.pnp_dlt(jnp.asarray(x[idx]), jnp.asarray(Xn[idx])))
    Rt, tt = map(np.asarray, pnp.pnp_dlt(T(x[idx]), T(Xn[idx])))
    ok = np.isfinite(Rj).all(axis=(1, 2)) & np.isfinite(tj).all(axis=1)
    assert ok.sum() >= 6 and np.isfinite(Rt).all() and np.isfinite(tt).all()
    np.testing.assert_allclose(Rt[ok], Rj[ok], atol=2e-3)
    np.testing.assert_allclose(tt[ok], tj[ok], atol=2e-3)
    assert np.abs(Rt - R).max() < 1e-2


def test_reprojection_residuals_match_jax(rng):
    x, X, R, t = _scene(rng, n=50, noise=1e-3)
    X[:3, 2] = -X[:3, 2]          # behind the camera: 1e6
    Rb = np.stack([R, rot([1, 0, 0], 0.1).astype(np.float32) @ R])
    tb = np.stack([t, t + 0.05]).astype(np.float32)
    rj = np.array(jpnp.reprojection_residuals(jnp.asarray(Rb), jnp.asarray(tb),
                                              jnp.asarray(x), jnp.asarray(X)))
    rt = pnp.reprojection_residuals(T(Rb), T(tb), T(x), T(X)).numpy()
    assert (rj == 1e6).sum() >= 3
    np.testing.assert_array_equal(rt == 1e6, rj == 1e6)
    np.testing.assert_allclose(rt, rj, rtol=1e-5, atol=1e-9)


def test_refine_pose_matches_jax(rng):
    x, X, R, t = _scene(rng, n=80, noise=5e-4, outliers=10)
    R0 = (rot([0, 1, 0], 0.02) @ R).astype(np.float32)
    t0 = (t + np.array([0.02, -0.01, 0.03])).astype(np.float32)
    w = (rng.random(80) > 0.1).astype(np.float32)
    for weights in (None, w):
        jw = None if weights is None else jnp.asarray(weights)
        Rj, tj = map(np.array, jpnp.refine_pose(jnp.asarray(R0), jnp.asarray(t0),
                                                jnp.asarray(x), jnp.asarray(X), jw))
        Rt, tt = pnp.refine_pose(T(R0), T(t0), T(x), T(X),
                                 None if weights is None else T(weights))
        np.testing.assert_allclose(Rt.numpy(), Rj, atol=1e-5)
        np.testing.assert_allclose(tt.numpy(), tj, atol=1e-5)
        assert np.abs(Rj - R).max() < 2e-3     # it converged


@pytest.mark.parametrize("prior", [False, True], ids=["no_prior", "R_init"])
def test_ransac_pnp_with_jax_draws_matches_jax(rng, prior):
    x, X, R, t = _scene(rng, n=200, noise=3e-4, outliers=60)
    mask = np.ones(200, bool)
    mask[190:] = False
    key = jax.random.PRNGKey(3)
    kw = dict(n_hyps=256, threshold=1e-5)
    R_init = t_init = None
    if prior:
        R_init = (rot([0, 0, 1], 0.01) @ R).astype(np.float32)
        t_init = (t + 0.01).astype(np.float32)
        kw_j = dict(R_init=jnp.asarray(R_init), t_init=jnp.asarray(t_init))
        kw_t = dict(R_init=T(R_init), t_init=T(t_init))
    else:
        kw_j = kw_t = {}
    rj = jpnp.ransac_pnp(key, jnp.asarray(x), jnp.asarray(X), jnp.asarray(mask),
                         **kw, **kw_j)
    sets = np.array(sample_minimal_sets_jax(key, jnp.asarray(mask), 256, 6))
    rt = pnp.ransac_pnp(T(x), T(X), T(mask), minimal_sets=T(sets), **kw, **kw_t)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.array(rj.inliers))
    assert int(rt.num_inliers) == int(rj.num_inliers) > 120
    np.testing.assert_allclose(rt.R.numpy(), np.array(rj.R), atol=1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.array(rj.t), atol=1e-4)
    assert np.abs(rt.R.numpy() - R).max() < 5e-3


def test_ransac_pnp_needs_exactly_one_draw_source(rng):
    x, X, _, _ = _scene(rng, n=20)
    with pytest.raises(ValueError):
        pnp.ransac_pnp(T(x), T(X))
    g = torch.Generator()
    g.manual_seed(0)
    res = pnp.ransac_pnp(T(x), T(X), generator=g, n_hyps=32, threshold=1e-6)
    assert int(res.num_inliers) == 20


def test_ransac_pnp_on_cpu_takes_the_plain_lo_stage(rng, monkeypatch):
    # CPU inputs take pnp_lo_plain, whatever the dtype: the kernel
    # library is never built or loaded, and nothing is launched.
    from sfm_tpu_torch.ops import _cuda

    def no_library():
        raise AssertionError("the CPU route reached the kernel library")

    monkeypatch.setattr(_cuda, "library", no_library)
    _cuda.reset_launches()
    x, X, R, t = _scene(rng, n=120, noise=3e-4, outliers=30)
    sets = np.stack([rng.choice(np.arange(30, 120), 6, replace=False) for _ in range(64)])
    for dtype in (torch.float32, torch.float64):
        seen = []
        lo = pnp.pnp_lo

        def spy(*args, **kwargs):
            seen.append((args, kwargs))
            return lo(*args, **kwargs)

        monkeypatch.setattr(pnp, "pnp_lo", spy)
        res = pnp.ransac_pnp(T(x).to(dtype), T(X).to(dtype), minimal_sets=T(sets),
                             n_hyps=64, threshold=1e-5)
        monkeypatch.setattr(pnp, "pnp_lo", lo)
        (args, kwargs), = seen
        plain = pnp.pnp_lo_plain(*args, **kwargs)
        assert torch.equal(res.R, plain[0]) and torch.equal(res.inliers, plain[2])
        assert res.num_inliers.dtype == torch.int32 and int(res.num_inliers) == int(plain[3]) >= 85
        assert np.abs(res.R.double().numpy() - R).max() < 5e-3
    assert _cuda.LAUNCHES["pnp_lo"] == 0
