"""Parity: the port's geometry (sfm_tpu_torch) against the JAX package
on the same seeded numpy inputs.

Tolerances: both sides run the same f32 algorithms (fixed-sweep
Jacobi, Householder QR, ridge inverse iteration, 5-DOF Gauss-Newton);
they differ only in the order of f32 sums, so single decompositions
agree to ~1e-5 and the end results (R, t) to 1e-4.  Inlier decisions
can flip for residuals within rounding of the threshold, hence the
>= 99.5% mask agreement and 1% valid-count bounds (+-2 points with the
translation re-vote).  The re-vote's integer scores tie across
neighbouring directions; both packages take the lowest index, so the
winning direction must be the same one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import rot, synthetic_two_view
from synthetic_pair import pose_problem
from sfm_tpu.config import PipelineConfig, RansacConfig
from sfm_tpu.models import two_view as jtv
from sfm_tpu.geometry import epipolar as jep
from sfm_tpu.geometry import lie as jlie
from sfm_tpu.geometry import pose as jpose
from sfm_tpu.geometry import ransac as jransac
from sfm_tpu.geometry import refine as jrefine
from sfm_tpu.geometry import triangulate as jtri
from sfm_tpu.ops import compact as jcompact
from sfm_tpu.ops import linalg as jlinalg
from sfm_tpu_torch import interop
from sfm_tpu_torch.geometry import epipolar, lie, pose, ransac, refine, triangulate
from sfm_tpu_torch.models import two_view
from sfm_tpu_torch.ops import compact, linalg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = torch.as_tensor
# Jitted: one compile instead of an eager dispatch per op; the same draw.
sample_minimal_sets_jax = jax.jit(jransac.sample_minimal_sets, static_argnums=(2,))


def _sym(rng, b, n):
    A = rng.normal(size=(b, n, n)).astype(np.float32)
    return A + np.swapaxes(A, -1, -2)


def _align_cols(V, Vref):
    """Flip each column of V to the sign of Vref (eigenvectors are
    defined up to sign)."""
    s = np.sign(np.sum(V * Vref, axis=-2, keepdims=True))
    return V * np.where(s == 0, 1.0, s)


@pytest.mark.parametrize("n", [3, 4])
def test_jacobi_eigh_matches_jax(rng, n):
    A = _sym(rng, 16, n)
    wj, Vj = map(np.array, jlinalg.jacobi_eigh(jnp.asarray(A)))
    wt, Vt = (a.numpy() for a in linalg.jacobi_eigh(T(A)))
    np.testing.assert_allclose(wt, wj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_align_cols(Vt, Vj), Vj, atol=1e-4)


def test_svd3x3_and_essential_projection(rng):
    E = rng.normal(size=(32, 3, 3)).astype(np.float32)
    Uj, sj, Vj = map(np.array, jlinalg.svd3x3(jnp.asarray(E)))
    Ut, st, Vt = (a.numpy() for a in linalg.svd3x3(T(E)))
    np.testing.assert_allclose(st, sj, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(Ut, Uj, atol=1e-4)
    np.testing.assert_allclose(Vt, Vj, atol=1e-4)
    Pj = np.array(jlinalg.project_to_essential(jnp.asarray(E)))
    Pt = linalg.project_to_essential(T(E)).numpy()
    np.testing.assert_allclose(Pt, Pj, atol=1e-5)


def test_nullvectors_match_jax(rng):
    A = rng.normal(size=(16, 8, 9)).astype(np.float32)
    ej = np.array(jlinalg.qr_nullvec(jnp.asarray(A)))
    et = linalg.qr_nullvec(T(A)).numpy()
    np.testing.assert_allclose(np.abs(np.sum(et * ej, -1)), 1.0, atol=1e-5)
    G = np.einsum("bmi,bmj->bij", A, A)[:, :8, :8] + np.eye(8, dtype=np.float32)
    pj = np.array(jlinalg.smallest_eigvec_power(jnp.asarray(G)))
    pt = linalg.smallest_eigvec_power(T(G)).numpy()
    np.testing.assert_allclose(pt, pj, atol=1e-5)
    t = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_array_equal(linalg.cross_matrix(T(t)).numpy(),
                                  np.array(jlinalg.cross_matrix(jnp.asarray(t))))


def test_lie_maps_match_jax(rng):
    w = rng.normal(size=(32, 3)).astype(np.float32) * 0.5
    w[:4] = [[0, 0, 0], [1e-7, 0, 0], [0, 2e-4, 0], [3.0, 0, 0]]  # series guards
    np.testing.assert_allclose(lie.so3_exp(T(w)).numpy(),
                               np.array(jlie.so3_exp(jnp.asarray(w))), atol=1e-6)
    t = rng.normal(size=(32, 3)).astype(np.float32)
    t[0] = [1.0, 0.0, 0.0]                                   # the axis switch
    np.testing.assert_allclose(lie.tangent_basis(T(t)).numpy(),
                               np.array(jlie.tangent_basis(jnp.asarray(t))),
                               atol=1e-6)


def test_epipolar_residuals_and_transform(rng):
    sc = synthetic_two_view(rng, n_points=300, n_outliers=40)
    x1, x2 = sc["x1"], sc["x2"]
    mask = rng.random(300) > 0.1
    Ej = jnp.asarray(np.stack([sc["E"], sc["E"] * 2.0 + 0.01]))
    rj = np.array(jep.epipolar_residuals(Ej, jnp.asarray(x1), jnp.asarray(x2)))
    rt = epipolar.epipolar_residuals(T(np.array(Ej)), T(x1), T(x2)).numpy()
    np.testing.assert_allclose(rt, rj, rtol=1e-4, atol=1e-9)
    Tj = np.array(jep.normalizing_transform(jnp.asarray(x1), jnp.asarray(mask)))
    Tt = epipolar.normalizing_transform(T(x1), T(mask)).numpy()
    np.testing.assert_allclose(Tt, Tj, rtol=1e-5, atol=1e-6)


def test_pose_candidates_and_recover_pose(rng):
    sc = synthetic_two_view(rng, n_points=400, n_outliers=30)
    x1, x2, E = sc["x1"], sc["x2"], sc["E"]
    w = (rng.random(400) > 0.2).astype(np.float32)
    # An exact essential matrix has s0 == s1, so the singular basis of
    # that plane (and with it the candidate ORDER) is decided by
    # rounding; the candidate SET is what both must agree on.
    Rj, tj = map(np.array, jpose.pose_candidates(jnp.asarray(E)))
    Rt, tt = (a.numpy() for a in pose.pose_candidates(T(E)))
    for R_, t_ in zip(Rj, tj):
        d = [max(np.abs(R_ - Rc).max(), np.abs(t_ - tc).max())
             for Rc, tc in zip(Rt, tt)]
        assert min(d) < 1e-4
    pj = jpose.recover_pose(jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2),
                            jnp.asarray(w))
    pt = pose.recover_pose(T(E), T(x1), T(x2), T(w))
    np.testing.assert_allclose(np.sort(pt["votes"].numpy()),
                               np.sort(np.array(pj["votes"])))
    np.testing.assert_allclose(pt["R"].numpy(), np.array(pj["R"]), atol=1e-5)
    np.testing.assert_array_equal(pt["front"].numpy(), np.array(pj["front"]))
    ok = np.array(pj["front"])
    np.testing.assert_allclose(pt["points"].numpy()[ok],
                               np.array(pj["points"])[ok], rtol=1e-3, atol=1e-4)


def test_triangulation_depths_and_reprojection(rng):
    sc = synthetic_two_view(rng, n_points=256)
    x1, x2, R, t = sc["x1"], sc["x2"], sc["R"], sc["t"]
    P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    P2 = np.concatenate([R, t[:, None]], 1).astype(np.float32)
    Xj, wj, fj = map(np.array, jtri.triangulate(*map(jnp.asarray, (x1, x2, P1, P2))))
    Xt, wt, ft = (a.numpy() for a in triangulate.triangulate(*map(T, (x1, x2, P1, P2))))
    np.testing.assert_allclose(Xt, Xj, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(ft, fj)
    z1j, z2j = map(np.array, jtri.midpoint_depths(*map(jnp.asarray, (x1, x2, R, t))))
    z1t, z2t = (a.numpy() for a in triangulate.midpoint_depths(*map(T, (x1, x2, R, t))))
    np.testing.assert_allclose(z1t, z1j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(z2t, z2j, rtol=1e-5, atol=1e-5)
    ej = np.array(jtri.reprojection_errors(*map(jnp.asarray, (Xj, x1, x2, R, t))))
    et = triangulate.reprojection_errors(*map(T, (Xj, x1, x2, R, t))).numpy()
    np.testing.assert_allclose(et, ej, rtol=1e-4, atol=1e-12)


def test_refine_relative_pose_single_and_batched(rng):
    sc = synthetic_two_view(rng, n_points=300, noise=1e-3, n_outliers=20)
    x1, x2 = sc["x1"], sc["x2"]
    w = (rng.random(300) > 0.1).astype(np.float32)
    R0 = (rot([0.3, 1.0, 0.2], 0.03) @ sc["R"]).astype(np.float32)
    t0 = (sc["t"] + np.array([0.05, -0.04, 0.02])).astype(np.float32)
    rj = jrefine.refine_relative_pose(*map(jnp.asarray, (R0, t0, x1, x2, w)), iters=8)
    rt = refine.refine_relative_pose(*map(T, (R0, t0, x1, x2, w)), iters=8)
    # At convergence the Sampson cost is flat to f32 rounding along the
    # rotation/translation valley of this narrow-FOV scene: the costs
    # agree to 1e-6 relative while the poses may sit ~1e-4 apart in it.
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-6)
    np.testing.assert_allclose(rt.R.numpy(), np.array(rj.R), atol=5e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.array(rj.t), atol=5e-4)
    # The probe form: a leading batch of starts, as vmapped in JAX.
    R0s = np.stack([R0, sc["R"], rot([1, 0, 0], 0.02) @ R0]).astype(np.float32)
    t0s = np.stack([t0, sc["t"], t0[::-1]]).astype(np.float32)
    ws = np.stack([w, np.ones_like(w), w]).astype(np.float32)
    rjb = jax.vmap(lambda R, t, ww: jrefine.refine_relative_pose(
        R, t, jnp.asarray(x1), jnp.asarray(x2), weights=ww, iters=6))(
            *map(jnp.asarray, (R0s, t0s, ws)))
    rtb = refine.refine_relative_pose(T(R0s), T(t0s), T(x1), T(x2),
                                      weights=T(ws), iters=6)
    np.testing.assert_allclose(rtb.cost.numpy(), np.array(rjb.cost), rtol=1e-5)
    np.testing.assert_allclose(rtb.R.numpy(), np.array(rjb.R), atol=5e-4)
    np.testing.assert_allclose(rtb.t.numpy(), np.array(rjb.t), atol=5e-4)


def test_refine_relative_pose_on_cpu_takes_the_plain_route(rng, monkeypatch):
    """CPU tensors, float32 or float64, go to ``refine_relative_pose_plain``
    (the route the JAX parity test above holds) and never reach the
    kernel library; K10 is for float32 CUDA tensors alone."""
    from sfm_tpu_torch.ops import _cuda

    def no_library():
        raise AssertionError("a CPU call reached the kernel library")

    monkeypatch.setattr(_cuda, "library", no_library)
    sc = synthetic_two_view(rng, n_points=200, noise=1e-3, n_outliers=20)
    R0 = (rot([0.3, 1.0, 0.2], 0.03) @ sc["R"]).astype(np.float32)
    t0 = (sc["t"] + np.array([0.05, -0.04, 0.02])).astype(np.float32)
    w = T(rng.random(200) > 0.1)
    before = dict(_cuda.LAUNCHES)
    for dtype in (torch.float32, torch.float64):
        args = [T(a).to(dtype) for a in (R0, t0, sc["x1"], sc["x2"])]
        got = refine.refine_relative_pose(*args, weights=w, iters=4)
        want = refine.refine_relative_pose_plain(*args, weights=w, iters=4)
        for a, b in zip(got, want):
            assert a.dtype == dtype and torch.equal(a, b)
    assert _cuda.LAUNCHES == before


def test_recover_pose_on_cpu_takes_the_plain_route(monkeypatch):
    """CPU tensors, float32 or float64, go to ``recover_pose_plain`` (the
    route the JAX parity test above holds) and never reach the kernel
    library; K12 is for float32 CUDA tensors alone."""
    from sfm_tpu_torch.ops import _cuda

    def no_library():
        raise AssertionError("a CPU call reached the kernel library")

    monkeypatch.setattr(_cuda, "library", no_library)
    E, x1, x2, w01, _ = pose_problem(0, 200)
    before = dict(_cuda.LAUNCHES)
    for dtype in (torch.float32, torch.float64):
        args = [T(a).to(dtype) for a in (E, x1, x2)]
        for w in (None, T(w01).to(dtype)):
            got = pose.recover_pose(*args, weights=w)
            want = pose.recover_pose_plain(*args, weights=w)
            assert got.keys() == want.keys()
            for k in got:
                assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
            assert got["R"].dtype == dtype and got["index"].dtype == torch.int64
    assert _cuda.LAUNCHES == before


@pytest.mark.parametrize("s1", [1.0, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_recover_pose_takes_the_first_maximum_on_tied_votes(s1, dtype):
    """Half the points behind both cameras vote for the true rotation
    with -t as many times as the other half votes for the truth: the
    two branches tie, and the lower index wins, as ``torch.argmax``
    (and ``jnp.argmax``) takes it, whatever order the SVD's rounding
    gives the candidates."""
    E, x1, x2, _, _ = pose_problem(1, 300, behind=0.5, outliers=0.0, s1=s1)
    p = pose.recover_pose(*(T(a).to(dtype) for a in (E, x1, x2)))
    votes = p["votes"].tolist()
    assert sorted(votes) == [0.0, 0.0, 150.0, 150.0]
    assert int(p["index"]) == votes.index(150.0)
    assert int(p["front"].sum()) == 150
    Rs, ts = pose.pose_candidates(T(E).to(dtype))
    i = int(p["index"])
    assert torch.equal(p["R"], Rs[i]) and torch.equal(p["t"], ts[i])
    j = votes.index(150.0, i + 1)
    assert torch.equal(Rs[j], Rs[i]) and torch.equal(ts[j], -ts[i])


def test_recover_pose_counts_like_all_ones_weights():
    """``weights=None`` votes the count of rows in front of both cameras:
    the same votes, branch and rows as weights of all ones."""
    E, x1, x2, _, _ = pose_problem(2, 257)
    args = [T(a) for a in (E, x1, x2)]
    a = pose.recover_pose(*args)
    b = pose.recover_pose(*args, weights=torch.ones(257))
    assert a["votes"].dtype == b["votes"].dtype == torch.float32
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert float(a["votes"][a["index"]]) == int(a["front"].sum())


def test_compaction_order_is_stable_partition(rng):
    valid = rng.random(97) > 0.4
    ot = compact.compaction_order(T(valid)).numpy()
    oj = np.array(jcompact.compaction_order(jnp.asarray(valid)))
    np.testing.assert_array_equal(ot, oj)
    np.testing.assert_array_equal(ot, np.argsort(~valid, kind="stable"))
    scores = T(np.array([3, 5, 5, 1, 5, 3], np.int64))
    np.testing.assert_array_equal(compact.stable_topk_indices(scores, 4).numpy(),
                                  [1, 2, 4, 0])


def test_sample_minimal_sets_distinct_valid():
    mask = torch.zeros(300, dtype=torch.bool)
    mask[::3] = True
    gen = torch.Generator().manual_seed(5)
    idx = ransac.sample_minimal_sets(gen, mask, 512)
    assert idx.shape == (512, 8)
    assert bool(mask[idx].all())
    s = torch.sort(idx, dim=1).values
    assert bool((s[:, 1:] != s[:, :-1]).all())


def _pixel_problem(rng, n=600, n_outliers=60):
    sc = synthetic_two_view(rng, n_points=n, noise=3e-4, n_outliers=n_outliers)
    K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1]], np.float32)
    uv1 = (sc["x1"] @ K.T)[:, :2].astype(np.float32)
    uv2 = (sc["x2"] @ K.T)[:, :2].astype(np.float32)
    mask = rng.random(n) > 0.05
    return uv1, uv2, mask, K, sc


def test_ransac_essential_with_injected_minimal_sets(rng):
    uv1, uv2, mask, K, _ = _pixel_problem(rng)
    Kinv = np.linalg.inv(K).astype(np.float32)
    x1 = np.concatenate([uv1, np.ones((len(uv1), 1), np.float32)], 1) @ Kinv.T
    x2 = np.concatenate([uv2, np.ones((len(uv2), 1), np.float32)], 1) @ Kinv.T
    x1, x2 = x1.astype(np.float32), x2.astype(np.float32)
    key = jax.random.PRNGKey(3)
    idx = np.array(sample_minimal_sets_jax(key, jnp.asarray(mask), 256))
    rj = jransac.ransac_essential(key, jnp.asarray(x1), jnp.asarray(x2),
                                  jnp.asarray(mask), n_hyps=256, threshold=3e-6)
    rt = ransac.ransac_essential(T(x1), T(x2), T(mask), minimal_sets=T(idx),
                                 n_hyps=256, threshold=3e-6)
    cj, ct = np.array(rj.counts), rt.counts.numpy()
    assert np.abs(ct - cj).max() <= 2
    assert int(rt.best_index) == int(rj.best_index)

    def e_err(a, b):
        return min(np.abs(a - b).max(), np.abs(a + b).max())

    # The bank's winner (topk_E[0]) agrees to f32 rounding; the
    # least-squares polish re-weights by the inlier set, where one
    # residual at the threshold flipping moves E by up to ~1e-3.
    assert e_err(rt.topk_E[0].numpy(), np.array(rj.topk_E[0])) < 1e-4
    assert e_err(rt.E.numpy(), np.array(rj.E)) < 2e-3
    assert (rt.inliers.numpy() == np.array(rj.inliers)).mean() >= 0.995
    top_j = np.array(jax.lax.top_k(jnp.asarray(cj), 16)[1])
    np.testing.assert_array_equal(
        compact.stable_topk_indices(T(cj), 16).numpy(), top_j)


def test_two_view_geometry_with_generator_recovers_pose(rng):
    uv1, uv2, mask, K, sc = _pixel_problem(rng)
    cfg = interop.config_to_torch(PipelineConfig(
        ransac=RansacConfig(n_hyps=256, threshold=3e-6), tvote_rounds=0))
    gen = torch.Generator().manual_seed(0)
    rt = two_view.two_view_geometry(*map(T, (uv1, uv2, mask, K)), cfg,
                                    generator=gen)
    from helpers import rot_angle_error

    assert rot_angle_error(rt.R.numpy(), sc["R"]) < 5e-3
    assert float(rt.t.numpy() @ sc["t"]) > 0.999
    # The translation re-vote rounds (the package default) keep the pose.
    rv = two_view.two_view_geometry(*map(T, (uv1, uv2, mask, K)),
                                    dataclasses.replace(cfg, tvote_rounds=1),
                                    generator=torch.Generator().manual_seed(0))
    assert rot_angle_error(rv.R.numpy(), sc["R"]) < 5e-3
    assert float(rv.t.numpy() @ sc["t"]) > 0.999


def test_fibonacci_sphere_matches_jax():
    np.testing.assert_array_equal(pose._fibonacci_sphere(1024),
                                  jpose._fibonacci_sphere(1024))


@pytest.mark.parametrize("n_dirs", [256, 1024])
def test_cheirality_t_vote_matches_jax(rng, n_dirs):
    # A rotation-dominant pair (small baseline), where the vote matters.
    sc = synthetic_two_view(rng, n_points=400, noise=3e-4, n_outliers=30,
                            R=rot([0.2, 1.0, 0.1], 0.2),
                            t=np.array([0.05, 0.02, 0.01]))
    R = (rot([1.0, 0.3, 0.0], 0.002) @ sc["R"]).astype(np.float32)
    mask = rng.random(400) > 0.1
    args = (R, sc["x1"], sc["x2"], mask)
    vj = jpose.cheirality_t_vote(*map(jnp.asarray, args), 3e-6, n_dirs=n_dirs)
    vt = pose.cheirality_t_vote(*map(T, args), 3e-6, n_dirs=n_dirs)
    np.testing.assert_array_equal(vt["t"].numpy(), np.array(vj["t"]))
    np.testing.assert_allclose(vt["E"].numpy(), np.array(vj["E"]), atol=1e-5)
    assert int(vt["score"]) == int(vj["score"]) > 100
    assert (vt["ok"].numpy() == np.array(vj["ok"])).mean() >= 0.995
    assert float(vt["t"].numpy() @ sc["t"]) / np.linalg.norm(sc["t"]) > 0.9


def test_two_view_geometry_tvote_matches_jax(rng):
    uv1, uv2, mask, K, sc = _pixel_problem(rng)
    cfg = PipelineConfig(ransac=RansacConfig(n_hyps=256, threshold=3e-6),
                         tvote_rounds=1)
    key = jax.random.PRNGKey(1)
    disp_ok = np.sum((uv1 - uv2) ** 2, -1) > cfg.ransac.min_disparity_px ** 2
    idx = np.array(sample_minimal_sets_jax(key, jnp.asarray(mask & disp_ok),
                                           cfg.ransac.n_hyps))
    rj = jtv.two_view_geometry(key, *map(jnp.asarray, (uv1, uv2, mask, K)), cfg)
    rt = two_view.two_view_geometry(*map(T, (uv1, uv2, mask, K)),
                                    interop.config_to_torch(cfg), minimal_sets=T(idx))
    np.testing.assert_allclose(rt.R.numpy(), np.array(rj.R), atol=1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.array(rj.t), atol=1e-4)
    assert (rt.inliers.numpy() == np.array(rj.inliers)).mean() >= 0.995
    assert abs(int(rt.point_valid.sum()) - int(np.array(rj.point_valid).sum())) <= 2
