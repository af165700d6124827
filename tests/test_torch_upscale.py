"""The up-scale path: the port's ``up_scale=True`` frontend and matcher
against the JAX package's Pallas branch (interpret mode, K7 -> K1 -> K2
-> K3 -> K4/K5 -> K6) on the rotation-only synthetic pair at 96 x 128
input (a 192 x 256 base), then bench_upscale's H-fit on the port's
output against the pair's exact homography.

Tolerances: keypoint sets as in test_torch_detect (count within
max(2, 1%), >= 95% position overlap); the match count within
max(3, 2%) (the ratio test flips on near-ties).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import h_fit
from synthetic_pair import homography_grid_errors, rotation_pair
from sfm_tpu.config import MatchConfig, SiftConfig
from sfm_tpu.sift import frontend as jfrontend
from sfm_tpu.sift import match as jmatch
from sfm_tpu_torch import interop
from sfm_tpu_torch.sift import frontend, match
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# tools/bench_upscale.py's up_t2.0 (thresh 2, init_blur 1, up_scale) cut
# to 3 octaves and small caps; sample_block_k=8 keeps the JAX side's
# interpret-mode compile small (a TPU tiling knob the port ignores).
CFG = SiftConfig(num_octaves=3, max_pts_per_octave=512, octave_caps=(512, 256, 128),
                 sample_cap=16384, thresh=2.0, init_blur=1.0, up_scale=True,
                 use_pallas=True, fused_detect=True, pyramid_pallas=True,
                 sample_block_k=8)
MCFG = MatchConfig(use_pallas=True)
TCFG, TMCFG = map(interop.config_to_torch, (CFG, MCFG))   # the port's classes


@pytest.fixture(scope="module")
def pair():
    return rotation_pair(96, 128, seed=0)


@pytest.fixture(scope="module")
def jax_stages(pair):
    s1 = jfrontend.extract_sift(jnp.asarray(pair["img1"]), CFG)
    s2 = jfrontend.extract_sift(jnp.asarray(pair["img2"]), CFG)
    m = jmatch.match(s1.descriptors, s2.descriptors, s1.keypoints.valid,
                     s2.keypoints.valid, MCFG)
    return tuple(jax.tree_util.tree_map(np.asarray, x) for x in (s1, s2, m))


def _positions(kp):
    return {(round(float(x), 1), round(float(y), 1))
            for x, y, ok in zip(np.asarray(kp.x), np.asarray(kp.y),
                                np.asarray(kp.valid)) if ok}


def test_upscale_frontend_and_matches_match_jax(pair, jax_stages):
    s1j, s2j, mj = jax_stages
    s1 = frontend.extract_sift(torch.as_tensor(pair["img1"]), TCFG)
    s2 = frontend.extract_sift(torch.as_tensor(pair["img2"]), TCFG)
    for sj, st in ((s1j, s1), (s2j, s2)):
        nj, nt = int(sj.keypoints.valid.sum()), int(st.keypoints.valid.sum())
        assert nj > 150
        assert abs(nt - nj) <= max(2, 0.01 * nj)
        pj, pt = _positions(sj.keypoints), _positions(interop.to_numpy(st).keypoints)
        assert len(pj & pt) >= 0.95 * len(pj)
    # Keypoints are back in input pixels.
    assert float(s1.keypoints.x[s1.keypoints.valid].max()) < 128
    m = match.match(s1.descriptors, s2.descriptors, s1.keypoints.valid,
                    s2.keypoints.valid, TMCFG)
    nmj, nmt = int(mj.valid.sum()), int(m.valid.sum())
    assert nmj > 100
    assert abs(nmt - nmj) <= max(3, 0.02 * nmj)


def test_upscale_h_fit_on_the_port_recovers_the_pair(pair):
    # bench_upscale.py:116-134 (chip_smoke.h_fit) on the port's own
    # extraction and matches.
    s1 = frontend.extract_sift(torch.as_tensor(pair["img1"]), TCFG)
    s2 = frontend.extract_sift(torch.as_tensor(pair["img2"]), TCFG)
    m = match.match(s1.descriptors, s2.descriptors, s1.keypoints.valid,
                    s2.keypoints.valid, interop.config_to_torch(MatchConfig()))
    fit = h_fit(s1, s2, m, torch.Generator().manual_seed(0))
    err = homography_grid_errors(fit.H.numpy(), pair["H_gt"], 96, 128)
    assert fit.numfit > 0.5 * int(m.valid.sum())
    assert float(np.median(err)) < 0.5 and float(err.max()) < 2.0, err


def test_octave_caps_must_match_the_octave_count():
    with pytest.raises(ValueError):
        frontend.extract_sift(torch.zeros((32, 32)),
                              dataclasses.replace(TCFG, octave_caps=(8, 8)))
