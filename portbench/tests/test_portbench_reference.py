"""The references at a tiny size on the CPU: the frozen frontend and
matcher (``reference/sfm``) equal the port's CPU path bit for bit; the
geometry written apart from the port (``reference/geometry.py``)
recovers an exact pose, sides with the ground truth of the rendered
pair, and agrees with the port's CPU path."""

import math

import numpy as np
import pytest
import torch

from portbench.gen import scene
from portbench.harness import compare as cmp
from portbench.harness import draws
from portbench.harness.pipeline import pipeline_config
from portbench.reference import geometry

CONFIG = {"sift": {"num_octaves": 3, "max_pts_per_octave": 256}}
TRAFFIC = {"ransac": {"n_hyps": 256, "threshold": 3e-6}, "pipeline": {"tvote_rounds": 0}}


def _cfgs(config=CONFIG, traffic=TRAFFIC):
    from portbench.reference.sfm import config as refcfg
    from sfm_tpu_torch import config as cfgmod

    return pipeline_config(cfgmod, config, traffic), pipeline_config(refcfg, config, traffic)


@pytest.fixture(scope="module")
def pair():
    return scene.synthetic_pair(288, 360, scene=scene.TorchDraws(11, "cpu"),
                                noise=scene.TorchDraws(12, "cpu"), device="cpu")


def _rot(axis, deg):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    return geometry._rodrigues(axis * math.radians(deg))


@pytest.mark.parametrize("control", [False, True])
def test_geometry_recovers_an_exact_pose(control):
    """Noise-free correspondences of random points: the float64 reference
    gives the pose to 1e-7 degrees and the points to 1e-9; the control
    (float32, TF32 operands) only to TF32's rounding."""
    rng = np.random.default_rng(0)
    n = 400
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 12, n)], 1)
    R = _rot([0.1, 1.0, -0.05], -3.0)
    t = np.array([-0.5, 0.06, 0.12])
    K = np.array([[800.0, 0, 320], [0, 800, 240], [0, 0, 1]])
    x2 = X @ R.T + t
    uv1 = (X / X[:, 2:]) @ K.T
    uv2 = (x2 / x2[:, 2:]) @ K.T
    mask = np.ones(n, bool)
    mask[-20:] = False
    u = draws.uniforms(3, 64, 8, "cpu")
    sets = draws.minimal_sets(u, torch.as_tensor(mask)).numpy()
    g = geometry.two_view_geometry(uv1[:, :2], uv2[:, :2], mask, K, sets, _cfgs()[1],
                                   control=control)
    rot, dirn = cmp.rotation_gap_deg(g.R, R), cmp.direction_gap_deg(g.t, t)
    assert g.num_inliers == n - 20 and g.point_valid.sum() == n - 20
    pts = np.linalg.norm(g.points[mask] * np.linalg.norm(t) - X[mask], axis=1) / np.linalg.norm(
        X[mask], axis=1)
    if control:
        assert 1e-4 < max(rot, dirn) < 1.0 and 1e-5 < np.median(pts) < 1e-2
    else:
        assert rot < 1e-7 and dirn < 1e-7 and pts.max() < 1e-9


def test_tf32_rounds_to_ten_mantissa_bits():
    x = np.array([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -10, -3.0], np.float32)
    np.testing.assert_array_equal(geometry.tf32(x), [1.0, 1.0 + 2.0 ** -9, 1.0 + 2.0 ** -10, -3.0])


def test_frontend_equal_and_geometry_agrees(pair):
    """The frozen frontend gives the port's correspondences bit for bit;
    on them the port's geometry and the reference's agree, and both lie
    near the rendered pair's ground truth."""
    from portbench.reference.sfm.models import two_view as ref
    from sfm_tpu_torch.models import two_view

    cfg, rcfg = _cfgs({"sift": {"num_octaves": 3, "max_pts_per_octave": 512}})
    a = two_view.frontend_stage(pair["img1"], pair["img2"], cfg)
    b = ref.frontend_stage(pair["img1"], pair["img2"], rcfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    u = draws.uniforms(5, 256, 8, "cpu")
    K = torch.as_tensor(pair["K"])
    sets = draws.minimal_sets(u, a[2])
    ra = two_view.two_view_geometry(*a, K, cfg, minimal_sets=sets)
    g = geometry.two_view_geometry(*(v.numpy() for v in b), K.numpy(), sets.numpy(), rcfg)
    assert int(ra.num_inliers) > 500
    assert cmp.rotation_gap_deg(ra.R.numpy(), g.R) < 0.05
    assert cmp.direction_gap_deg(ra.t.numpy(), g.t) < 0.5
    assert abs(int(ra.num_inliers) - g.num_inliers) <= 0.02 * g.num_inliers
    assert cmp.rotation_gap_deg(g.R, pair["R"]) < 0.5
    assert cmp.direction_gap_deg(g.t, pair["t"]) < 3.0


def test_upscale_extract_and_match_equal():
    from portbench.reference.sfm.sift import frontend as rfront, match as rmatch
    from sfm_tpu_torch.sift import frontend, match

    config = {"sift": {"num_octaves": 3, "max_pts_per_octave": 256,
                       "octave_caps": [256, 256, 128], "sample_cap": 1024,
                       "thresh": 2.0, "init_blur": 1.0, "up_scale": True}}
    cfg, rcfg = _cfgs(config, {})
    p = scene.rotation_pair(96, 128, scene=scene.TorchDraws(3, "cpu"),
                            noise=scene.TorchDraws(4, "cpu"), device="cpu")
    sa = [frontend.extract_sift(p[k], cfg.sift) for k in ("img1", "img2")]
    sb = [rfront.extract_sift(p[k], rcfg.sift) for k in ("img1", "img2")]
    for x, y in zip(sa, sb):
        assert int(x.keypoints.valid.sum()) > 50
        assert torch.equal(x.descriptors, y.descriptors)
        for f in x.keypoints._fields:
            assert torch.equal(getattr(x.keypoints, f), getattr(y.keypoints, f))
    ma = match.match(sa[0].descriptors, sa[1].descriptors, sa[0].keypoints.valid,
                     sa[1].keypoints.valid, cfg.match)
    mb = rmatch.match(sb[0].descriptors, sb[1].descriptors, sb[0].keypoints.valid,
                      sb[1].keypoints.valid, rcfg.match)
    for f in ma._fields:
        assert torch.equal(getattr(ma, f), getattr(mb, f))


def test_control_lowers_the_matcher_to_fp8():
    from portbench.reference.sfm.ops import match as rmatch
    from portbench.reference.sfm.utils import precision

    g = torch.Generator().manual_seed(0)
    d1 = torch.nn.functional.normalize(torch.randn(64, 128, generator=g), dim=1)
    d2 = torch.nn.functional.normalize(torch.randn(80, 128, generator=g), dim=1)
    best, _, _ = rmatch.match_top2(d1, d2)
    with precision.control():
        low, _, _ = rmatch.match_top2(d1, d2)
    assert precision.lower_precision() is False
    exact = (d1.to(torch.bfloat16).float() @ d2.to(torch.bfloat16).float().T).max(1).values
    torch.testing.assert_close(best, exact)
    assert (low - best).abs().max() > 1e-3
