"""Parity: the port's bundle adjustment (``models/bundle_adjust.py``),
``triangulate_tracks`` and ``so3_project`` against the JAX package's on
the same seeded problem (``tests/test_bundle_adjust.py:_make_problem``:
5 cameras, 200 points, every point seen by every camera).

Tolerances: the Jacobians are written out in the port and taken with
``jacfwd`` in JAX, and the segment sums add in other orders, so the
residuals agree to 1e-6, the system blocks to 1e-5 of their largest
entry and the Schur steps to 1e-4 of theirs (the dense [6M, 6M] LU and
32 CG steps amplify the f32 differences); LM costs over the first
iterations to 1e-3 relative, the final poses to 1e-4.  Fixed cameras
are left unchanged bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ba_problems import ring_problem
from helpers import rot
from sfm_tpu.geometry import triangulate as jtri
from sfm_tpu.models import bundle_adjust as jba
from sfm_tpu.ops import linalg as jlinalg
from sfm_tpu_torch import interop
from sfm_tpu_torch.geometry import triangulate
from sfm_tpu_torch.models import bundle_adjust as ba
from sfm_tpu_torch.ops import linalg
from test_bundle_adjust import _make_problem
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = torch.as_tensor
DELTA = 3e-3


@pytest.fixture
def problem(rng):
    """The JAX problem with a few masked and a few gross observations,
    and the same problem on the port's side."""
    prob_j, gt, init, _ = _make_problem(rng, outliers=20)
    mask = np.ones(prob_j.mask.shape, bool)
    mask[rng.choice(mask.size, 30, replace=False)] = False
    prob_j = prob_j._replace(mask=jnp.asarray(mask))
    R0, t0, X0 = (np.asarray(a, np.float32) for a in init)
    return prob_j, interop.to_torch(prob_j), (R0, t0, X0), gt


def _close(a, b, rel):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=0,
                               atol=rel * max(np.abs(b).max(), 1e-30))


def test_residuals_and_robust_cost_match_jax(problem):
    prob_j, prob_t, (R0, t0, X0), _ = problem
    rj = np.array(jba._residuals(R0, t0, X0, prob_j))
    rt = ba._residuals(T(R0), T(t0), T(X0), prob_t).numpy()
    np.testing.assert_allclose(rt, rj, atol=1e-6)
    assert (rt[~prob_t.mask.numpy()] == 0).all()
    cj = float(jba.robust_cost(R0, t0, X0, prob_j, DELTA))
    ct = float(ba.robust_cost(T(R0), T(t0), T(X0), prob_t, DELTA))
    assert ct == pytest.approx(cj, rel=1e-5)


def test_system_blocks_match_jax(problem):
    prob_j, prob_t, (R0, t0, X0), _ = problem
    M, P = R0.shape[0], X0.shape[0]
    sj = jba.weighted_system(R0, t0, X0, prob_j, DELTA, M, P)
    st = ba.weighted_system(T(R0), T(t0), T(X0), prob_t, DELTA, M, P)
    for name, a, b in zip(("U", "V", "gc", "gp", "Jc_w", "Jc", "Jp", "r", "w"), st, sj):
        assert a.shape == b.shape, name
        _close(a.numpy(), b, 1e-5)
    nj = jba.normal_equation_blocks(R0, t0, X0, prob_j, DELTA, M, P)
    nt = ba.normal_equation_blocks(T(R0), T(t0), T(X0), prob_t, DELTA, M, P)
    for a, b in zip(nt, nj):
        assert a.shape == b.shape
        _close(a.numpy(), b, 1e-5)


@pytest.mark.parametrize("lam", [1e-3, 10.0])
def test_schur_solves_match_jax(problem, lam):
    """The dense Schur solve (its S[m, :, m, :] diagonal blocks written
    through split advanced indices) and the CG solve, on the same
    blocks, against JAX's."""
    prob_j, prob_t, (R0, t0, X0), _ = problem
    M, P = R0.shape[0], X0.shape[0]
    U, V, Wg, gc, gp = (np.array(a) for a in
                        jba.normal_equation_blocks(R0, t0, X0, prob_j, DELTA, M, P))
    fixed = np.array(prob_j.fixed)
    dj = jba.schur_solve(U, V, Wg, gc, gp, jnp.float32(lam), fixed)
    dt = ba.schur_solve(*map(T, (U, V, Wg, gc, gp)), torch.tensor(lam), T(fixed))
    for a, b in zip(dt, dj):
        _close(a.numpy(), b, 1e-4)
    assert (dt[0].numpy()[fixed] == 0).all()
    U, V, gc, gp, Jc_w, _, Jp, r, w = (
        np.array(a) for a in jba.weighted_system(R0, t0, X0, prob_j, DELTA, M, P))
    cj = jba.schur_solve_cg(U, V, Jc_w, Jp, r, w, prob_j, gc, gp, jnp.float32(lam),
                            prob_j.fixed)
    ct = ba.schur_solve_cg(*map(T, (U, V, Jc_w, Jp, r, w)), prob_t,
                           *map(T, (gc, gp)), torch.tensor(lam), prob_t.fixed)
    for a, b in zip(ct, cj):
        _close(a.numpy(), b, 1e-4)
    # CG reaches the dense solution on this small system.
    _close(ct[0].numpy(), dt[0].numpy(), 1e-3)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_run_ba_matches_jax(problem, solver):
    prob_j, prob_t, (R0, t0, X0), _ = problem
    fj, cj = jba.run_ba(R0, t0, X0, prob_j, iters=8, solver=solver)
    ft, ct = ba.run_ba(T(R0), T(t0), T(X0), prob_t, iters=8, solver=solver)
    cj = np.array(cj)
    np.testing.assert_allclose(ct.numpy()[:5], cj[:5], rtol=1e-3)
    # 20 gross outliers hold the robust cost at ~15% of the start.
    assert float(ct[-1]) == pytest.approx(cj[-1], rel=1e-3) and ct[-1] < 0.2 * ct[0]
    np.testing.assert_allclose(ft.R.numpy(), np.array(fj.R), atol=1e-4)
    np.testing.assert_allclose(ft.t.numpy(), np.array(fj.t), atol=1e-4)
    # Camera 0 is fixed: unchanged bit for bit.
    assert torch.equal(ft.R[0], T(R0[0])) and torch.equal(ft.t[0], T(t0[0]))


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_run_ba_free_gauge_matches_jax_and_float64(solver):
    """A 36-camera ring with no camera fixed (the 7-dimensional gauge
    held by the LM damping alone, as in the JAX package's turntable
    free-BA stage): the port's f32 costs follow JAX's to 1e-4 and end
    within 1e-4 of the port's own float64 dense solve (measured 2.6e-7)."""
    R0, t0, X0, *arrs = ring_problem(M=36, P=400)
    f32 = [np.asarray(a, np.float32) for a in (R0, t0, X0)]
    cam, pt, uv, mask, fixed = arrs
    prob_j = jba.BAProblem(jnp.asarray(cam, jnp.int32), jnp.asarray(pt, jnp.int32),
                           jnp.asarray(uv, jnp.float32), jnp.asarray(mask),
                           jnp.asarray(fixed))
    _, cj = jba.run_ba(*f32, prob_j, iters=10, solver=solver)
    _, ct = ba.run_ba(*map(T, f32), interop.to_torch(prob_j), iters=10, solver=solver)
    prob64 = ba.BAProblem(T(cam), T(pt), T(uv), T(mask), T(fixed))
    _, c64 = ba.run_ba(*map(T, (R0, t0, X0)), prob64, iters=10, solver="dense")
    np.testing.assert_allclose(ct.numpy(), np.array(cj), rtol=1e-4)
    assert abs(float(ct[-1]) / float(c64[-1]) - 1) <= 1e-4
    assert ct[-1] < 0.05 * ct[0]


def test_run_ba_solver_choice():
    # One rule on the CPU and the card, whatever the gauge: dense up to
    # 8M camera x point products (the 12-frame sequence's global BA),
    # CG beyond.
    assert ba.resolve_solver("auto", 5, 200) == "dense"
    assert ba.resolve_solver("auto", 12, 15360) == "dense"
    assert ba.resolve_solver("auto", 200, 100_000) == "cg"
    assert ba.resolve_solver("dense", 200, 100_000) == "dense"
    with pytest.raises(ValueError):
        ba.resolve_solver("lu", 5, 200)


def test_triangulate_tracks_matches_jax(problem):
    prob_j, prob_t, _, (R_gt, t_gt, X_gt) = problem
    P = X_gt.shape[0] + 3          # 3 points without observations
    Xj, okj = map(np.array, jtri.triangulate_tracks(
        R_gt, t_gt, prob_j.cam_idx, prob_j.pt_idx, prob_j.uv, prob_j.mask, P))
    Xt, okt = triangulate.triangulate_tracks(
        T(R_gt), T(t_gt), prob_t.cam_idx, prob_t.pt_idx, prob_t.uv, prob_t.mask, P)
    np.testing.assert_array_equal(okt.numpy(), okj)
    assert okj[:-3].all() and not okj[-3:].any()
    np.testing.assert_allclose(Xt.numpy(), Xj, atol=1e-4)


def test_so3_project_matches_jax(rng):
    A = np.stack([rot(rng.normal(size=3), rng.uniform(0, 3)) for _ in range(16)])
    M = (A + rng.normal(scale=0.05, size=A.shape)).astype(np.float32)
    M[3] = -M[3]                    # det < 0: still a proper rotation out
    Rj = np.array(jlinalg.so3_project(jnp.asarray(M)))
    Rt = linalg.so3_project(T(M)).numpy()
    np.testing.assert_allclose(Rt, Rj, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(Rt), 1.0, atol=1e-5)
