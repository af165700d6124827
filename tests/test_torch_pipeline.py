"""The whole slice: the port's two-view pipeline against the JAX
package's bench route (the bench config's Pallas branch, base chain
included: pyramid_pallas=True, kernels in interpret mode) at 192 x 256 on
the synthetic textured pair, with stage outputs handed across through
``sfm_tpu_torch.interop`` in both directions.

Tolerances: keypoint sets as in test_torch_detect (count within
max(2, 1%), >= 95% position overlap); the match count within max(3, 2%)
(the matcher's ratio test flips on near-ties); geometry on identical
correspondences and injected minimal sets to 1e-4 in R and t; and the port's
end-to-end pose within 1 deg (R) / 5 deg (t direction) of the ground
truth the pair was rendered with (median over 3 RANSAC seeds; at this
size single seeds of either package land up to ~0.5 / 2.5 deg off).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthetic_pair import pose_errors_deg, synthetic_pair
from sfm_tpu.config import MatchConfig, PipelineConfig, RansacConfig, SiftConfig
from sfm_tpu.geometry import ransac as jransac
from sfm_tpu.models import two_view as jtv
from sfm_tpu.sift import frontend as jfrontend
from sfm_tpu_torch import interop
from sfm_tpu_torch.models import two_view
from sfm_tpu_torch.sift import frontend
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# sample_block_k is a TPU tiling knob the port ignores.  The JAX side's
# interpret-mode compile of the sampling kernels grows with the block,
# while its descriptors agree to 1e-6 across block sizes, so the test
# takes the smallest block, 8.
CFG = PipelineConfig(
    sift=SiftConfig(num_octaves=3, max_pts_per_octave=256, use_pallas=True,
                    fused_detect=True, pyramid_pallas=True, sample_block_k=8),
    match=MatchConfig(use_pallas=True),
    ransac=RansacConfig(n_hyps=256, threshold=3e-6, chunk=256),
    tvote_rounds=0,
)
TCFG = interop.config_to_torch(CFG)   # the same configuration, the port's classes
# Jitted: one compile instead of an eager dispatch per op; the same draw.
sample_minimal_sets_jax = jax.jit(jransac.sample_minimal_sets, static_argnums=(2,))


@pytest.fixture(scope="module")
def pair():
    return synthetic_pair(192, 256, seed=0)


@pytest.fixture(scope="module")
def jax_stages(pair):
    s1 = jfrontend.extract_sift(jnp.asarray(pair["img1"]), CFG.sift)
    s2 = jfrontend.extract_sift(jnp.asarray(pair["img2"]), CFG.sift)
    corr = jtv._match_stage(s1, s2, CFG)
    return (jax.tree_util.tree_map(np.asarray, s1),
            jax.tree_util.tree_map(np.asarray, s2),
            tuple(np.asarray(a) for a in corr))


def _kp_positions(kp):
    v = np.asarray(kp.valid)
    return {(round(float(x), 1), round(float(y), 1))
            for x, y, ok in zip(np.asarray(kp.x), np.asarray(kp.y), v) if ok}


def test_frontend_matches_jax_slice(pair, jax_stages):
    s1j, s2j, (uv1j, uv2j, maskj) = jax_stages
    s1t = frontend.extract_sift(torch.as_tensor(pair["img1"]), TCFG.sift)
    nj = int(s1j.keypoints.valid.sum())
    nt = int(s1t.keypoints.valid.sum())
    assert nj > 300
    assert abs(nt - nj) <= max(2, 0.01 * nj)
    pj, pt = _kp_positions(s1j.keypoints), _kp_positions(interop.to_numpy(s1t).keypoints)
    assert len(pj & pt) >= 0.95 * len(pj)

    # Port SIFT -> port match stage, against the JAX match stage.
    s2t = frontend.extract_sift(torch.as_tensor(pair["img2"]), TCFG.sift)
    uv1t, uv2t, maskt = two_view.match_stage(s1t, s2t, TCFG)
    mj, mt = int(maskj.sum()), int(maskt.sum())
    assert mj > 200
    assert abs(mt - mj) <= max(3, 0.02 * mj)

    # Port SIFT handed to the JAX match stage (port -> JAX direction).
    n1 = interop.to_numpy(s1t)
    n2 = interop.to_numpy(s2t)
    def as_jax(s):
        kp = {k: jnp.asarray(v) for k, v in s.keypoints._asdict().items()}
        return jfrontend.SiftResult(keypoints=jfrontend.Keypoints(**kp),
                                    descriptors=jnp.asarray(s.descriptors))

    _, _, mask_x = jtv._match_stage(as_jax(n1), as_jax(n2), CFG)
    assert abs(int(np.asarray(mask_x).sum()) - mt) <= max(3, 0.02 * mt)


def test_geometry_on_jax_correspondences(pair, jax_stages):
    uv1, uv2, mask = jax_stages[2]
    K = pair["K"]
    key = jax.random.PRNGKey(0)
    disp_ok = np.sum((uv1 - uv2) ** 2, -1) > CFG.ransac.min_disparity_px ** 2
    idx = np.asarray(sample_minimal_sets_jax(
        key, jnp.asarray(mask & disp_ok), CFG.ransac.n_hyps))
    rj = jtv.two_view_geometry(key, *map(jnp.asarray, (uv1, uv2, mask, K)), CFG)
    uv1t, uv2t, maskt = interop.to_torch((uv1, uv2, mask))
    rt = two_view.two_view_geometry(uv1t, uv2t, maskt, torch.as_tensor(K), TCFG,
                                    minimal_sets=interop.to_torch(idx))
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-4)
    assert (rt.inliers.numpy() == np.asarray(rj.inliers)).mean() >= 0.995
    back = interop.to_torch(jtv.TwoViewResult(*map(np.asarray, rj)))
    assert isinstance(back, two_view.TwoViewResult)
    assert abs(int(back.point_valid.sum()) - int(rt.point_valid.sum())) <= max(
        1, 0.01 * int(back.point_valid.sum()))


def test_end_to_end_pose_against_ground_truth(pair):
    img1, img2, K = (torch.as_tensor(pair[k]) for k in ("img1", "img2", "K"))
    errs = []
    for seed in range(3):
        res = two_view.run_two_view(img1, img2, K, TCFG, seed=seed)
        errs.append(pose_errors_deg(res.R.numpy(), res.t.numpy(), pair["R"],
                                    pair["t"]))
        assert int(res.point_valid.sum()) > 0
        assert bool(torch.isfinite(res.reproj_err))
    rot, tdir = np.median(np.array(errs), axis=0)
    assert rot < 1.0 and tdir < 5.0, errs
