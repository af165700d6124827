"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Marked ``cuda``: they skip where no card is present (a CUDA
kernel has no interpret mode).  On the card, run them without the
JAX-importing conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: K1, K2, K7, K3 and K5 evaluate the same IEEE roundings as
their plain versions (bit-exact expected; held to 1e-4 / 1e-5); K4's histogram sums
in another order, so a near-tie peak may swap on rare rows (>= 99% of
rows within 1e-3); K6's bf16 products accumulate in another order
(1e-5, argmax agreement >= 99.9%).
"""

import dataclasses

import numpy as np
import pytest
import torch

from synthetic_pair import pose_errors_deg, synthetic_pair

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def pair():
    return synthetic_pair(192, 256, seed=0)


@pytest.mark.parametrize("shape", [(576, 720), (575, 719), (960, 1280), (5, 3)])
def test_pyramid_kernels_match_plain(dev, shape):
    from sfm_tpu_torch.ops import _cuda, pyramid as pyr
    from sfm_tpu_torch.ops.image import gaussian_kernel

    rng = np.random.default_rng(4)
    img = torch.as_tensor((rng.random(shape) * 255).astype(np.float32), device=dev)
    lp, sd = gaussian_kernel(4, 1.0), gaussian_kernel(2, 0.5)
    _cuda.reset_launches()
    out = pyr.blur9(img, lp)
    assert float((out - pyr.blur9_plain(img, lp)).abs().max()) <= 1e-4
    down = pyr.scale_down(img, sd)
    assert tuple(down.shape) == (shape[0] // 2, shape[1] // 2)
    assert float((down - pyr.scale_down_plain(img, sd)).abs().max()) <= 1e-4
    up = pyr.scale_up(img)
    assert tuple(up.shape) == (2 * shape[0], 2 * shape[1])
    assert float((up - pyr.scale_up_plain(img)).abs().max()) <= 1e-4
    torch.cuda.synchronize()
    assert (_cuda.LAUNCHES["blur9"], _cuda.LAUNCHES["scale_down"],
            _cuda.LAUNCHES["scale_up"]) == (1, 1, 1)


def test_detect_kernel_matches_plain(dev, pair):
    from sfm_tpu.config import SiftConfig
    from sfm_tpu_torch.ops.detect import detect_maps, detect_maps_plain
    from sfm_tpu_torch.sift import pyramid

    cfg = SiftConfig(num_octaves=3)
    bases = pyramid.base_chain(torch.as_tensor(pair["img1"], device=dev), cfg)
    for o, b in enumerate(bases):
        taps = pyramid.octave_kernel_bank(cfg, o)
        rk, ak = detect_maps(b, taps, cfg.thresh, cfg.edge_limit)
        rp, ap = detect_maps_plain(b, taps, cfg.thresh, cfg.edge_limit)
        ck, cp = rk > 0, rp > 0
        assert int((ck != cp).sum()) <= max(2, 0.001 * int(cp.sum()))
        both = ck & cp
        assert float((rk - rp)[both].abs().max()) <= 1e-4
        assert float((ak - ap)[:, both].abs().max()) <= 1e-4
        assert bool((rk[~ck] == -1).all())


def _keypoints(rng, K, H, W, dev):
    x = rng.uniform(0.5, W - 1.5, K).astype(np.float32)
    y = rng.uniform(0.5, H - 1.5, K).astype(np.float32)
    s = rng.uniform(0.8, 2.0, K).astype(np.float32)
    o = rng.uniform(0, 360, K).astype(np.float32)
    return (torch.as_tensor(a, device=dev) for a in (x, y, s, o))


def test_sample_kernels_match_plain(dev, pair):
    from sfm_tpu_torch.ops import sample
    from sfm_tpu_torch.sift.describe import normalize_descriptors

    atlas = torch.as_tensor(pair["img1"], device=dev)
    x, y, s, o = _keypoints(np.random.default_rng(0), 256, 192, 256, dev)
    count = torch.tensor(250, device=dev)
    d1k, o1k, o2k, dk = sample.fused_orient_descriptor(atlas, x, y, s, count)
    d1p, o1p, o2p, dp = sample.fused_orient_descriptor_plain(atlas, x, y, s, count)
    row = (normalize_descriptors(d1k) - normalize_descriptors(d1p)).abs().amax(1)
    assert float((row[:250] <= 1e-3).float().mean()) >= 0.99
    assert float((dk == dp)[:250].float().mean()) >= 0.99
    assert not bool(d1k[250:].any()) and not bool(o1k[250:].any())
    rk = sample.descriptor_sample(atlas, x, y, s, o, count)
    rp = sample.descriptor_sample_plain(atlas, x, y, s, o, count)
    err = (normalize_descriptors(rk) - normalize_descriptors(rp)).abs().max()
    assert float(err) <= 1e-5
    assert not bool(rk[250:].any())


@pytest.mark.parametrize("bf16", [False, True])
def test_match_kernel_matches_plain(dev, bf16):
    from sfm_tpu_torch.ops.match import match_top2, match_top2_plain

    rng = np.random.default_rng(2)
    d1 = np.abs(rng.normal(size=(300, 128))).astype(np.float32)
    d2 = np.abs(rng.normal(size=(700, 128))).astype(np.float32)
    d2[650:] = d2[600:650]                       # exact ties in the columns
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    v2 = rng.random(700) > 0.1
    args = [torch.as_tensor(a, device=dev) for a in (d1, d2, v2)]
    bk, sk, ik = match_top2(*args, bf16=bf16)
    bp, sp, ip = match_top2_plain(*args, bf16=bf16)
    assert float((ik == ip).float().mean()) >= 0.999
    assert float((bk - bp).abs().max()) <= 1e-5
    assert float((sk - sp).abs().max()) <= 1e-5
    assert bool(torch.as_tensor(v2, device=dev)[ik.long()].all())


def test_wrappers_check_their_inputs(dev):
    from sfm_tpu_torch.ops.match import match_top2
    from sfm_tpu_torch.ops.sample import descriptor_sample

    from sfm_tpu_torch.ops.pyramid import blur9, scale_down

    d = torch.zeros((8, 64), device=dev)
    with pytest.raises(ValueError):
        match_top2(d, d)                          # not 128-D
    with pytest.raises(ValueError):
        blur9(d.double(), [1.0])                  # wrong dtype
    with pytest.raises(ValueError):
        scale_down(d[:1], [1.0])                  # no 2x decimation
    atlas = torch.zeros((64, 64), device=dev)
    xs = torch.zeros(8, device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        descriptor_sample(atlas, xs, xs, xs, xs)  # wrong dtype


def test_pipeline_on_cuda_goes_through_every_kernel(dev, pair):
    from sfm_tpu.config import PipelineConfig, RansacConfig, SiftConfig
    from sfm_tpu_torch.models import two_view
    from sfm_tpu_torch.ops import _cuda

    cfg = PipelineConfig(sift=SiftConfig(num_octaves=3, max_pts_per_octave=256),
                         ransac=RansacConfig(n_hyps=256, threshold=3e-6),
                         tvote_rounds=0)
    img1, img2, K = (torch.as_tensor(pair[k], device=dev)
                     for k in ("img1", "img2", "K"))
    _cuda.reset_launches()
    errs = []
    for seed in range(3):
        res = two_view.run_two_view(img1, img2, K, cfg, seed=seed)
        errs.append(pose_errors_deg(res.R.cpu().numpy(), res.t.cpu().numpy(),
                                    pair["R"], pair["t"]))
    assert _cuda.LAUNCHES["scale_up"] == 0, _cuda.LAUNCHES
    assert all(n > 0 for k, n in _cuda.LAUNCHES.items() if k != "scale_up"), \
        _cuda.LAUNCHES
    rot, tdir = np.median(np.array(errs), axis=0)
    assert rot < 1.0 and tdir < 5.0, errs
    from sfm_tpu_torch.sift import frontend

    frontend.extract_sift(img1, dataclasses.replace(cfg.sift, up_scale=True))
    assert _cuda.LAUNCHES["scale_up"] == 1
