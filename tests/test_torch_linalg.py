"""The closed-form solvers and the geometry API that the port gained with
the JAX package's XLA routes, against the JAX package on the same seeded
inputs: ``eigh3x3``, ``svd3x3(method="analytic")``,
``gram_nullvec4_adj``, ``triangulate(solver="adj")``,
``estimate_E_8pt``, ``sampson_residuals``, ``align_candidates``,
``intrinsics`` and ``project``.

Tolerances: both sides run the same f32 formulas in another summation
order.  Eigenvalues to 1e-5 of the largest |eigenvalue|; eigenvectors
up to sign where their eigenvalue is apart from the others (by 1e-3 of
the largest), and as the projector onto the eigenspace where two or
three coincide (an eigenspace of dimension 2 or 3 has no preferred
basis, and the closed form's choice there turns on rounding);
null vectors up to sign to 1e-4; points, residuals and poses to 1e-4
relative (1e-5 for exact formulas).  The defaults stay Jacobi, and
unknown ``method=`` / ``solver=`` names raise as in the JAX package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import rot, synthetic_two_view
from sfm_tpu.geometry import camera as jcamera
from sfm_tpu.geometry import epipolar as jep
from sfm_tpu.geometry import pose as jpose
from sfm_tpu.geometry import triangulate as jtri
from sfm_tpu.ops import linalg as jlinalg
from sfm_tpu_torch.geometry import camera, epipolar, pose, triangulate
from sfm_tpu_torch.ops import linalg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = torch.as_tensor


def _symmetric_cases(rng):
    """Random symmetric matrices, E^T E of essential matrices (s ~ (1,
    1, 0), a degenerate pair and a zero), rotated repeated eigenvalues,
    scaled ones and zero matrices: {name: [B, 3, 3]}."""
    A = rng.normal(size=(32, 3, 3)).astype(np.float32)
    Rs = np.stack([rot(rng.normal(size=3), rng.uniform(0.1, 3.0)) for _ in range(8)])
    E = np.stack([np.diag([1.0, 1.0, 0.0]) @ R for R in Rs])
    E = np.einsum("bij,bjk->bik", Rs[::-1], E)
    rep = np.stack([R @ np.diag(d) @ R.T for R, d in zip(
        Rs, [(2, 2, 5), (5, 2, 2), (3, 3, 3), (0, 1, 1), (1, 1, 0), (-2, -2, 4),
             (1e-3, 1e-3, 1.0), (7, 7, 7)])])
    return {"random": A + np.swapaxes(A, -1, -2),
            "essential": np.einsum("bji,bjk->bik", E, E).astype(np.float32),
            "repeated": rep.astype(np.float32),
            "scaled": (A + np.swapaxes(A, -1, -2)) * np.float32(1e4),
            "zero": np.zeros((4, 3, 3), np.float32)}


def _assert_same_eigen(wt, Vt, wj, Vj, A):
    big = max(np.abs(wj).max(), 1e-30)
    np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-5 * big)
    for b in range(wj.shape[0]):
        for i in range(3):
            near = np.abs(wj[b] - wj[b, i]) <= 1e-3 * max(np.abs(wj[b]).max(), 1e-30)
            Pt = Vt[b][:, near] @ Vt[b][:, near].T
            Pj = Vj[b][:, near] @ Vj[b][:, near].T
            np.testing.assert_allclose(Pt, Pj, atol=1e-4, err_msg=f"{b}, {i}")
    # Orthonormal columns, and A = V diag(w) V^T.
    np.testing.assert_allclose(np.einsum("bki,bkj->bij", Vt, Vt),
                               np.broadcast_to(np.eye(3), Vt.shape), atol=1e-5)
    rec = np.einsum("bik,bk,bjk->bij", Vt, wt, Vt)
    np.testing.assert_allclose(rec, A, atol=1e-5 * big)


@pytest.mark.parametrize("case", ["random", "essential", "repeated", "scaled", "zero"])
def test_eigh3x3_matches_jax(rng, case):
    A = _symmetric_cases(rng)[case]
    wj, Vj = map(np.asarray, jlinalg.eigh3x3(jnp.asarray(A)))
    wt, Vt = (a.numpy() for a in linalg.eigh3x3(T(A)))
    assert np.isfinite(wt).all() and np.isfinite(Vt).all()
    assert (np.diff(wt, axis=-1) >= -1e-5 * max(np.abs(wt).max(), 1e-30)).all()
    _assert_same_eigen(wt, Vt, wj, Vj, A)


@pytest.mark.parametrize("case", ["random", "essential"])
def test_svd3x3_analytic_matches_jax(rng, case):
    if case == "random":
        E = rng.normal(size=(32, 3, 3)).astype(np.float32)
    else:
        sc = [synthetic_two_view(rng, n_points=16) for _ in range(4)]
        E = np.stack([s["E"] for s in sc]).astype(np.float32)
    Uj, sj, Vj = map(np.asarray, jlinalg.svd3x3(jnp.asarray(E), method="analytic"))
    Ut, st, Vt = (a.numpy() for a in linalg.svd3x3(T(E), method="analytic"))
    # s = sqrt(w) of E^T E's eigenvalues: held as w (1e-5 of the largest),
    # since a near-zero s (an essential matrix's third) is the square
    # root of rounding.
    np.testing.assert_allclose(st ** 2, sj ** 2, rtol=0, atol=1e-5 * (sj ** 2).max())
    # E = U diag(s) V^T, with orthonormal U and V.
    np.testing.assert_allclose(np.einsum("bik,bk,bjk->bij", Ut, st, Vt), E, atol=1e-4)
    for M in (Ut, Vt):
        np.testing.assert_allclose(np.einsum("bki,bkj->bij", M, M),
                                   np.broadcast_to(np.eye(3), M.shape), atol=1e-5)
    if case == "random":   # distinct singular values: the vectors themselves
        np.testing.assert_allclose(Ut, Uj, atol=1e-4)
        np.testing.assert_allclose(Vt, Vj, atol=1e-4)
    # The default stays Jacobi: it equals method="jacobi".
    for a, b in zip(linalg.svd3x3(T(E)), linalg.svd3x3(T(E), method="jacobi")):
        assert torch.equal(a, b)


def test_gram_nullvec4_adj_matches_jax_across_scales(rng):
    A = rng.normal(size=(6, 16, 4, 4)).astype(np.float32)
    A[..., 3] *= 0.0
    A[..., 3] += rng.normal(size=(6, 16, 4)).astype(np.float32) * 1e-4
    A = A * np.float32(10.0) ** np.arange(-3, 3, dtype=np.float32)[:, None, None, None]
    A = np.concatenate([A.reshape(-1, 4, 4), np.zeros((2, 4, 4), np.float32)])
    vj = np.asarray(jlinalg.gram_nullvec4_adj(jnp.asarray(A)))
    vt = linalg.gram_nullvec4_adj(T(A)).numpy()
    assert np.isfinite(vt).all()
    np.testing.assert_allclose(np.linalg.norm(vt, axis=-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(np.abs(np.sum(vt * vj, -1)), 1.0, atol=1e-4)
    np.testing.assert_array_equal(vt[-2:], [[0, 0, 0, 1]] * 2)   # zero systems: e3


def test_triangulate_adj_matches_jax(rng):
    sc = synthetic_two_view(rng, n_points=256)
    x1, x2, R, t = sc["x1"], sc["x2"], sc["R"], sc["t"]
    P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    P2 = np.concatenate([R, t[:, None]], 1).astype(np.float32)
    args = (x1, x2, P1, P2)
    Xj, wj, fj = map(np.asarray, jtri.triangulate(*map(jnp.asarray, args), solver="adj"))
    Xt, wt, ft = (a.numpy() for a in triangulate.triangulate(*map(T, args), solver="adj"))
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(Xt[fj], Xj[fj], rtol=1e-4, atol=1e-4)
    # The default stays Jacobi.
    for a, b in zip(triangulate.triangulate(*map(T, args)),
                    triangulate.triangulate(*map(T, args), solver="jacobi")):
        assert torch.equal(a, b)


def test_unknown_method_or_solver_raises():
    with pytest.raises(ValueError, match="unknown method"):
        linalg.svd3x3(torch.eye(3)[None], method="qr")
    z = torch.zeros((4, 3))
    P = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="unknown solver"):
        triangulate.triangulate(z, z, P, P, solver="svd")


def test_estimate_E_8pt_and_sampson_match_jax(rng):
    sc = synthetic_two_view(rng, n_points=80, noise=0.0)
    x1, x2 = sc["x1"], sc["x2"]
    idx = np.stack([rng.choice(80, 8, replace=False) for _ in range(16)])
    Ej = np.asarray(jep.estimate_E_8pt(jnp.asarray(x1[idx]), jnp.asarray(x2[idx])))
    Et = epipolar.estimate_E_8pt(T(x1[idx]), T(x2[idx])).numpy()
    # E up to sign; each is the noise-free pair's essential matrix.
    sgn = np.sign(np.sum(Et * Ej, axis=(-2, -1)))[:, None, None]
    np.testing.assert_allclose(Et * sgn, Ej, atol=1e-4)
    sgn_gt = np.sign(np.sum(Et * sc["E"], axis=(-2, -1)))[:, None, None]
    np.testing.assert_allclose(Et * sgn_gt / np.sqrt(2.0),
                               np.broadcast_to(sc["E"], Et.shape), atol=1e-3)
    Es = np.stack([sc["E"], sc["E"] + 0.01 * rng.normal(size=(3, 3))]).astype(np.float32)
    rj = np.asarray(jep.sampson_residuals(*map(jnp.asarray, (Es, x1, x2))))
    rt = epipolar.sampson_residuals(*map(T, (Es, x1, x2))).numpy()
    np.testing.assert_allclose(rt, rj, rtol=1e-4, atol=1e-12)


def test_align_candidates_matches_jax(rng):
    sc = synthetic_two_view(rng, n_points=16)
    E, R, t = (sc[k].astype(np.float32) for k in ("E", "R", "t"))
    R_off = (rot([0.3, 0.2, 1.0], 0.05) @ R).astype(np.float32)
    for R_ref, t_ref in ((R, t), (R, -t), (R_off, t)):
        Rj, tj = map(np.asarray, jpose.align_candidates(*map(jnp.asarray, (E, R_ref, t_ref))))
        Rt, tt = (a.numpy() for a in pose.align_candidates(*map(T, (E, R_ref, t_ref))))
        np.testing.assert_allclose(Rt, Rj, atol=1e-5)
        np.testing.assert_allclose(tt, tj, atol=1e-5)
    np.testing.assert_allclose(Rt, R, atol=1e-3)


def test_intrinsics_and_project_match_jax(rng):
    Kj = np.asarray(jcamera.intrinsics(800.0, cx=320.0, cy=240.0, skew=0.5))
    Kt = camera.intrinsics(800.0, cx=320.0, cy=240.0, skew=0.5)
    assert Kt.dtype == torch.float32 and Kt.device.type == "cpu"
    np.testing.assert_array_equal(Kt.numpy(), Kj)
    np.testing.assert_array_equal(
        camera.intrinsics(700.0, 710.0, dtype=torch.float64).numpy(),
        np.asarray(jcamera.intrinsics(700.0, 710.0, dtype=jnp.float32)).astype(np.float64))
    X = rng.normal(size=(50, 3)).astype(np.float32) + np.float32([0, 0, 5])
    X[0] = [0.0, 0.0, 0.0]   # depth 0 after the pose below: the 1e-12 guard
    R = rot([0.1, 0.9, 0.2], 0.1).astype(np.float32)
    t = (-R @ X[0]).astype(np.float32)
    for K in (None, Kj):
        uj, dj = map(np.asarray, jcamera.project(*map(jnp.asarray, (X, R, t)),
                                                 None if K is None else jnp.asarray(K)))
        ut, dt = (a.numpy() for a in camera.project(*map(T, (X, R, t)),
                                                    None if K is None else T(K)))
        np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ut[1:], uj[1:], rtol=1e-5, atol=1e-4)
        np.testing.assert_array_equal(np.isfinite(ut), np.isfinite(uj))
