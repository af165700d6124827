"""Parity: the port's self-calibrating BA (``models/calibrate.py``)
against the JAX package's, on ``tests/test_calibrate.py``'s distorted
orbit (6 cameras around 160 points, f = 2800, k1 = -0.28, 0.15 px
noise, camera 0 fixed).

Tolerances: the distortion model and its fixed-point inverse are the
same f32 arithmetic (1e-6 of their scale); the per-observation
Jacobians are written out in the port and taken by ``jacfwd`` in JAX,
equal to 1e-5 of each block's largest entry.  The intrinsics are held
by what the data identify: in this ~5 degree field of view the
columns of (f, f k1, f k2) are nearly parallel (r^2 <= 0.017), so f32
sums in another order move k1 and k2 along a flat valley (by up to
1e-2 and 5e-2 here) while the pixels they predict move by < 0.01 px:
the projections of the same normalized points under both packages'
intrinsics agree to 0.02 px (the noise is 0.15 px) and f to 1e-4
relative.  The LM runs (25 joint iterations, 3 x 15 alternating ones)
go through f32 accept/reject decisions on both sides: costs to 5e-4
relative (the first step of the bordered [6M + 3] solve differs by
1.2e-4), poses to 1e-4, points to 1e-3; all well inside the JAX
package's own recovery bars (2% on f, 0.05 on k1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import rot
from sfm_tpu.models import calibrate as jcal
from sfm_tpu_torch.models import calibrate as cal
from test_calibrate import CX, CY, F_GT, K1_GT, _turntable
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _np(x):
    return np.array(x)


def _t(arrays):
    """JAX arrays -> port tensors (index arrays as int64)."""
    out = []
    for a in arrays:
        a = _np(a)
        out.append(torch.as_tensor(a.astype(np.int64) if a.dtype.kind == "i" else a))
    return out


def _intr(xp, f, k1=0.0, k2=0.0, cls=jcal.Intrinsics):
    return cls(*(xp(np.float32(v)) for v in (f, CX, CY, k1, k2)))


def _tintr(f, k1=0.0, k2=0.0):
    return _intr(torch.as_tensor, f, k1, k2, cal.Intrinsics)


def _assert_same_camera(intr, intr_j, r_max=0.13):
    """f to 1e-4 relative, and the pixel radius f r (1 + k1 r^2 + k2 r^4)
    of every normalized radius r <= ``r_max`` (the observations' range)
    to 0.02 px."""
    assert float(intr.f) == pytest.approx(float(intr_j.f), rel=1e-4)
    r = np.linspace(0.0, r_max, 64)

    def radius(i):
        f, k1, k2 = (float(v) for v in (i.f, i.k1, i.k2))
        return f * r * (1 + k1 * r * r + k2 * r ** 4)

    assert np.abs(radius(intr) - radius(intr_j)).max() < 0.02
    assert float(intr.cx) == float(intr_j.cx) and float(intr.cy) == float(intr_j.cy)


def _perturbed(rng):
    """The distorted orbit, its start perturbed as test_calibrate's joint
    test perturbs it (poses 0.02 / 0.015 rad, points 0.02)."""
    R, t, X, ci, pi, mask, fixed, uv = _turntable(rng)
    Rn = np.array(R)
    tn = np.array(t) + np.where(np.arange(len(t))[:, None] > 0,
                                rng.normal(scale=0.02, size=t.shape), 0).astype(np.float32)
    for i in range(1, len(Rn)):
        Rn[i] = Rn[i] @ rot(rng.normal(size=3), 0.015)
    Xn = np.array(X) + rng.normal(scale=0.02, size=X.shape).astype(np.float32)
    return Rn.astype(np.float32), tn.astype(np.float32), Xn, ci, pi, mask, fixed, uv


def test_distortion_model_matches_jax(rng):
    xn = rng.uniform(-0.12, 0.12, size=(300, 2)).astype(np.float32)
    ij, it = _intr(jnp.asarray, F_GT, K1_GT, 0.03), _tintr(F_GT, K1_GT, 0.03)
    uvj = jcal.project_pixels(jnp.asarray(xn), ij)
    uv = cal.project_pixels(torch.as_tensor(xn), it)
    np.testing.assert_allclose(uv.numpy(), _np(uvj), atol=1e-6 * 3000)
    np.testing.assert_allclose(cal.distort(torch.as_tensor(xn), it).numpy(),
                               _np(jcal.distort(jnp.asarray(xn), ij)), atol=1e-7)
    for iters in (5, 8):
        np.testing.assert_allclose(
            cal.undistort_normalize(uv, it, iters=iters).numpy(),
            _np(jcal.undistort_normalize(uvj, ij, iters=iters)), atol=1e-6)
    K = np.array([[F_GT, 0, CX], [0, F_GT, CY], [0, 0, 1]], np.float32)
    for a, b in zip(cal.intrinsics_from_K(torch.as_tensor(K), k1=-0.1),
                    jcal.intrinsics_from_K(jnp.asarray(K), k1=-0.1)):
        assert float(a) == pytest.approx(float(b))


@pytest.mark.parametrize("weighted", [False, True])
def test_fit_intrinsics_matches_jax(rng, weighted):
    R, t, X, ci, pi, mask, fixed, uv = _turntable(rng)
    w = rng.uniform(0.2, 1.0, size=uv.shape[0]).astype(np.float32) if weighted else None
    fj = jcal.fit_intrinsics(R, t, X, ci, pi, mask, uv, _intr(jnp.asarray, 0.8 * F_GT),
                             w=None if w is None else jnp.asarray(w))
    Rt, tt_, Xt, cit, pit, mt, _, uvt = _t((R, t, X, ci, pi, mask, fixed, uv))
    f = cal.fit_intrinsics(Rt, tt_, Xt, cit, pit, mt, uvt, _tintr(0.8 * F_GT),
                           w=None if w is None else torch.as_tensor(w))
    _assert_same_camera(f, fj)
    assert abs(float(f.f) - F_GT) / F_GT < 0.01 and abs(float(f.k1) - K1_GT) < 0.03


def test_obs_jacobians_intr_match_jax(rng):
    Rn, tn, Xn, ci, pi, mask, fixed, uv = _perturbed(rng)
    m = _np(mask).copy()
    m[::7] = False                       # masked rows must come out zero
    ij, it = _intr(jnp.asarray, 0.9 * F_GT, -0.1, 0.02), _tintr(0.9 * F_GT, -0.1, 0.02)
    outj = jcal._obs_jacobians_intr(jnp.asarray(Rn), jnp.asarray(tn), jnp.asarray(Xn),
                                    ci, pi, jnp.asarray(m), uv, ij)
    out = cal._obs_jacobians_intr(*_t((Rn, tn, Xn, ci, pi, m, uv)), it)
    for name, a, b in zip(("r", "Jc", "Jp", "Jt"), out, outj):
        b = _np(b)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * np.abs(b).max(), err_msg=name)
        assert not a.numpy()[~m].any()


def test_run_ba_joint_matches_jax_from_a_perturbed_init(rng):
    """test_calibrate's joint test: 12% wrong focal, zero k, 25 LM
    iterations."""
    Rn, tn, Xn, ci, pi, mask, fixed, uv = _perturbed(rng)
    (Rj, tj, Xj), ij, cj = jcal.run_ba_joint(
        jnp.asarray(Rn), jnp.asarray(tn), jnp.asarray(Xn), ci, pi, mask, fixed, uv,
        _intr(jnp.asarray, 0.88 * F_GT), iters=25, huber_px=2.0)
    Rt, tt_, Xt, cit, pit, mt, fx, uvt = _t((Rn, tn, Xn, ci, pi, mask, fixed, uv))
    (R2, t2, X2), intr, costs = cal.run_ba_joint(
        Rt, tt_, Xt, cit, pit, mt, fx, uvt, _tintr(0.88 * F_GT), iters=25, huber_px=2.0)
    np.testing.assert_allclose(costs.numpy(), _np(cj), rtol=5e-4)
    assert costs[-1] < costs[0] * 0.05
    _assert_same_camera(intr, ij)
    assert abs(float(intr.f) - F_GT) / F_GT < 0.02 and abs(float(intr.k1) - K1_GT) < 0.05
    np.testing.assert_allclose(R2.numpy(), _np(Rj), atol=1e-4)
    np.testing.assert_allclose(t2.numpy(), _np(tj), atol=1e-4)
    np.testing.assert_allclose(X2.numpy(), _np(Xj), atol=1e-3)


def test_run_ba_joint_pinhole_mode_leaves_intrinsics(rng):
    R, t, X, ci, pi, mask, fixed, uv = _turntable(rng, k1=0.0)
    (Rj, tj, Xj), ij, cj = jcal.run_ba_joint(R, t, X, ci, pi, mask, fixed, uv,
                                             _intr(jnp.asarray, F_GT), iters=8,
                                             estimate_f=False, estimate_k=False)
    (R2, t2, X2), intr, costs = cal.run_ba_joint(
        *_t((R, t, X, ci, pi, mask, fixed, uv)), _tintr(F_GT), iters=8,
        estimate_f=False, estimate_k=False)
    assert float(intr.f) == pytest.approx(F_GT)
    assert float(intr.k1) == 0.0 and float(intr.k2) == 0.0
    np.testing.assert_allclose(costs.numpy(), _np(cj), rtol=5e-4)
    np.testing.assert_allclose(R2.numpy(), _np(Rj), atol=1e-4)


def test_run_ba_selfcal_matches_jax(rng):
    """Three rounds of (run_ba on undistorted normalized observations,
    fit_intrinsics) from the perturbed start, K's focal 10% off."""
    Rn, tn, Xn, ci, pi, mask, fixed, uv = _perturbed(rng)
    K = np.array([[0.9 * F_GT, 0, CX], [0, 0.9 * F_GT, CY], [0, 0, 1]], np.float32)
    stj, ij, cj = jcal.run_ba_selfcal(jnp.asarray(Rn), jnp.asarray(tn), jnp.asarray(Xn),
                                      ci, pi, mask, fixed, uv, K)
    st, intr, costs = cal.run_ba_selfcal(*_t((Rn, tn, Xn, ci, pi, mask, fixed, uv)), K)
    assert costs.shape == (3, 16)
    np.testing.assert_allclose(costs.numpy(), _np(cj), rtol=5e-4)
    _assert_same_camera(intr, ij)
    np.testing.assert_allclose(st.R.numpy(), _np(stj.R), atol=1e-4)
    np.testing.assert_allclose(st.X.numpy(), _np(stj.X), atol=1e-3)
