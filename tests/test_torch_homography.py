"""Parity: the port's homography fit (``sfm_tpu_torch/geometry/
homography.py``) against the JAX package's, and the rotation-only
synthetic pair's ground truth.

Tolerances: the DLT rows and transfer errors are the same f32
expressions (1e-5 relative); RANSAC takes the JAX package's own
minimal-set draw, so the bank and its counts agree and H differs only
by f32 QR / solve rounding in the two libraries (1e-4 after
H[2, 2] = 1); an inlier flag may flip where an error sits within
rounding of the gate (>= 99.5% equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_pair import _cast, homography_grid_errors, rotation_pair
from sfm_tpu.geometry import homography as jhom
from sfm_tpu.geometry import ransac as jransac
from sfm_tpu_torch import interop
from sfm_tpu_torch.geometry import homography
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

T = torch.as_tensor
sample_minimal_sets_jax = jax.jit(jransac.sample_minimal_sets, static_argnums=(2, 3))


def _h_true():
    return np.array([[0.97, -0.06, 14.0], [0.04, 1.02, -9.0],
                     [2e-5, -3e-5, 1.0]], np.float64)


@pytest.fixture(scope="module")
def corr():
    """400 correspondences in a 640 x 480 view: 70% under H_true with
    0.5 px noise, 30% uniform outliers; 5% masked off."""
    rng = np.random.default_rng(7)
    n = 400
    uv1 = rng.uniform([0, 0], [640, 480], (n, 2))
    p = np.c_[uv1, np.ones(n)] @ _h_true().T
    uv2 = p[:, :2] / p[:, 2:] + rng.normal(scale=0.5, size=(n, 2))
    out = rng.random(n) < 0.3
    uv2[out] = rng.uniform([0, 0], [640, 480], (out.sum(), 2))
    mask = rng.random(n) > 0.05
    return uv1.astype(np.float32), uv2.astype(np.float32), mask, ~out


def test_rotation_pair_h_gt_maps_rendered_points():
    pair = rotation_pair(48, 64, seed=3, with_scene=True)
    planes, K, R = pair["scene"]
    v, u = np.mgrid[0:48, 0:64].astype(np.float64)
    val1, X1 = _cast(planes, K, np.eye(3), np.zeros(3), u, v)
    p = np.stack([u, v, np.ones_like(u)], -1) @ pair["H_gt"].astype(np.float64).T
    u2, v2 = p[..., 0] / p[..., 2], p[..., 1] / p[..., 2]
    # Camera 2 sees the same world point through the H_gt-mapped pixel.
    q = X1 @ (K @ R).T
    np.testing.assert_allclose(u2, q[..., 0] / q[..., 2], atol=1e-3)
    np.testing.assert_allclose(v2, q[..., 1] / q[..., 2], atol=1e-3)
    val2, X2 = _cast(planes, K, R, np.zeros(3), u2, v2)
    np.testing.assert_allclose(X2, X1, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(val2, val1, atol=0.05)
    assert pair["img1"].shape == pair["img2"].shape == (48, 64)


def test_homography_system_and_transfer_errors_match_jax(corr):
    uv1, uv2 = corr[0][:50], corr[1][:50]
    rng = np.random.default_rng(1)
    Hs = (np.eye(3) + 0.05 * rng.normal(size=(4, 3, 3))).astype(np.float32)
    Hs[:, :2, 2] += rng.normal(scale=10.0, size=(4, 2)).astype(np.float32)
    np.testing.assert_allclose(
        homography.homography_system(T(uv1), T(uv2)).numpy(),
        np.asarray(jhom.homography_system(jnp.asarray(uv1), jnp.asarray(uv2))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        homography.transfer_errors(T(Hs), T(uv1), T(uv2)).numpy(),
        np.asarray(jhom.transfer_errors(*map(jnp.asarray, (Hs, uv1, uv2)))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("refit_iters", [0, 2])
def test_ransac_homography_matches_jax_on_the_jax_draw(corr, refit_iters):
    uv1, uv2, mask, _ = corr
    key = jax.random.PRNGKey(3)
    rj = jhom.ransac_homography(key, *map(jnp.asarray, (uv1, uv2, mask)),
                                n_hyps=256, threshold=9.0, refit_iters=refit_iters)
    idx = np.asarray(sample_minimal_sets_jax(key, jnp.asarray(mask), 256, 4))
    rt = homography.ransac_homography(T(uv1), T(uv2), T(mask),
                                      minimal_sets=interop.to_torch(idx),
                                      n_hyps=256, threshold=9.0,
                                      refit_iters=refit_iters)
    np.testing.assert_allclose(rt.H.numpy(), np.asarray(rj.H), rtol=1e-4, atol=1e-4)
    assert (rt.inliers.numpy() == np.asarray(rj.inliers)).mean() >= 0.995
    assert abs(int(rt.num_inliers) - int(rj.num_inliers)) <= 2
    back = interop.to_torch(jhom.HomographyResult(*map(np.asarray, rj)))
    assert isinstance(back, homography.HomographyResult)


def test_ransac_homography_with_a_generator_finds_the_truth(corr):
    uv1, uv2, mask, good = corr
    gen = torch.Generator().manual_seed(0)
    r = homography.ransac_homography(T(uv1), T(uv2), T(mask), generator=gen,
                                     n_hyps=512, threshold=9.0)
    assert float(np.median(homography_grid_errors(r.H.numpy(), _h_true(),
                                                  480, 640))) < 0.5
    expect = mask & good
    assert (r.inliers.numpy() == expect).mean() >= 0.98
    with pytest.raises(ValueError):
        homography.ransac_homography(T(uv1), T(uv2))      # no draw given


def test_improve_homography_keeps_the_seed_when_a_round_gates_no_point():
    """H = I against 50 correspondences 500 px off: no round gates 4
    points, so the seed comes back (the refit of an empty gate was an
    all-zero H)."""
    rng = np.random.default_rng(2)
    uv1 = rng.uniform(0, 600, (50, 2)).astype(np.float32)
    uv2 = uv1 + np.float32(500.0)
    H = homography.improve_homography(T(np.eye(3, dtype=np.float32)), T(uv1),
                                      T(uv2), T(np.ones(50, bool)))
    assert torch.equal(H, torch.eye(3))


def test_improve_homography_matches_jax(corr):
    uv1, uv2, mask, _ = corr
    # A seed within the 3 px gate of most inliers, as RANSAC hands over.
    H0 = (_h_true() + np.diag([0.002, -0.002, 0.0])).astype(np.float32)
    H0[:2, 2] += (1.0, -0.5)
    hj = jhom.improve_homography(*map(jnp.asarray, (H0, uv1, uv2, mask)),
                                 loops=5, threshold=9.0)
    ht = homography.improve_homography(T(H0), T(uv1), T(uv2), T(mask),
                                       loops=5, threshold=9.0)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-4, atol=1e-4)
    assert float(ht[2, 2]) == 1.0
    assert float(np.max(homography_grid_errors(ht.numpy(), _h_true(),
                                                480, 640))) < 1.0
