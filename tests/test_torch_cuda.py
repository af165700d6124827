"""The port's CUDA kernels against their plain PyTorch versions on the
card: the repository's one place for kernel-vs-plain holds, at small
and ragged shapes and at the bench and up-scale paths' own (the base
chain on the 1920 x 2560 up-scale base, K3 on both paths' octave bases,
K4, K5, K8 and K9 on both paths' capped sample slots, K6 at 23,552^2 x
128, the XLA route's kernels on both paths' inputs).  Marked ``cuda``:
they skip where no card is present (a CUDA kernel has no interpret
mode).  On the card, run them without the JAX-importing conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: K1 + K2 (the base chain, one launch) and K3 evaluate the
same IEEE roundings as their plain versions, so they are held bit for
bit (K7 to 1e-4); K4, K5, K8 and K9 too, except their bin
sums, which the plain versions take with einsum (K5 to 1e-5, K8 to 1e-6
of the largest bin, K4 and K9 to 1e-3 on >= 99% of rows); K9 must equal
K4 exactly, and K5 at K4's own orientations K4's descriptors, each pair
evaluating the same roundings in the same order; K6's bf16
products accumulate on the tensor cores in another order (1e-5, argmax
agreement >= 99.9%), while its tie rule (lowest index, across column
ranges of the split grid too) is held exactly.  K3's one-launch
multi-octave form equals its per-octave launches and the plain version
bit for bit, in both modes (lean, and gated with its dense solve and
scale gate), at 4 to 13 planes, at 14 and 19 (the run-time-plane
route) and past 8 octaves (one launch per 8).  On the XLA routes
(``fused_detect=False``, ``use_pallas=False``, the f32 matcher) the
dense DoG equals the CPU's bit for bit, ``extract_sift`` matches the
CPU's to 1e-3 px with no K3, K4 or K9 launch, and K6's f32 mode holds
its scores to 1e-5 with the same index wherever the best is clear.
K10 (the pose refinement) and its plain route are both f32 loops whose
converged poses wander along the cost's flat valley on rounding, so
each is measured against the plain route in float64 and K10 may pass
the plain f32 route's error there by 1e-4 relative (costs) and 1e-3 /
2e-3 deg (poses after one / more steps); K11 (PnP's LO stage) likewise
by 1e-4 deg in R and 5e-6 relative in t, with equal strict counts.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from synthetic_pair import pnp_problem, pose_errors_deg, refine_problem, synthetic_pair

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def pair():
    return synthetic_pair(192, 256, seed=0)


@pytest.fixture(scope="module")
def path_scene():
    """The bench path's pair and SIFT config (bench.py's on the 576 x 720
    synthetic pair) and the up-scale path's (up_t2.0 on the 960 x 1280
    rotation pair), each rendered once: path -> (pair, SiftConfig)."""
    from path_configs import slice_config, upscale_config
    from synthetic_pair import rotation_pair

    scenes = {}

    def get(path):
        if path not in scenes:
            scenes[path] = ((rotation_pair(960, 1280, seed=0), upscale_config())
                            if path == "up-scale" else
                            (synthetic_pair(576, 720, seed=0), slice_config().sift))
        return scenes[path]
    return get


# The sample slots each path hands the sampling kernels.
PATH_SLOTS = {"bench": 2560, "module API": 5120, "up-scale": 11776}


def _path_slots(path_scene, path, dev):
    """(atlas, x, y, scale, count) of the first image's sample slots on a
    path: the capped slots the bench and up-scale paths hand K4 / K9, or
    the module API's every detection slot, compacted valid-first."""
    from sfm_tpu_torch.ops import compact
    from sfm_tpu_torch.sift import frontend

    scene, cfg = path_scene("up-scale" if path == "up-scale" else "bench")
    atlas, dets = frontend.detect_stage(torch.as_tensor(scene["img1"], device=dev), cfg)
    x, y, s, v, sharp = (torch.cat([getattr(d, f) for d in dets])
                         for f in ("x", "y", "scale", "valid", "sharpness"))
    order = (compact.compaction_order(v) if path == "module API" else
             frontend._sample_order(v, sharp, cfg.sample_cap, [d.x.shape[0] for d in dets]))
    assert order.shape[0] == PATH_SLOTS[path]
    return atlas, x[order], y[order], s[order], v[order].sum().to(torch.int32)


@pytest.mark.parametrize("shape", [(576, 720), (575, 719), (960, 1280), (5, 3), (1920, 2560)])
def test_pyramid_kernels_match_plain(dev, shape):
    """The base chain (K1 + K2 in one launch) equals the plain chain bit
    for bit at 1, 2, 5 and 9 levels where the shape has them; blur9,
    scale_down (the chain kernel's one-phase cases) and K7 equal their
    plain versions bit for bit too."""
    from sfm_tpu_torch.ops import _cuda, pyramid as pyr
    from sfm_tpu_torch.ops.image import gaussian_kernel

    rng = np.random.default_rng(4)
    img = torch.as_tensor((rng.random(shape) * 255).astype(np.float32), device=dev)
    lp, sd = gaussian_kernel(4, 1.0), gaussian_kernel(2, 0.5)
    for levels in (1, 2, 5, 9):
        if min(shape) >> (levels - 1) < 1:
            continue
        _cuda.reset_launches()
        out = pyr.base_chain(img, lp, sd, levels)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["base_chain"] == 1
        ref = pyr.base_chain_plain(img, lp, sd, levels)
        assert [tuple(b.shape) for b in out] == [(shape[0] >> o, shape[1] >> o)
                                                 for o in range(levels)]
        for a, b in zip(out, ref):
            assert a.is_contiguous() and torch.equal(a, b)
    _cuda.reset_launches()
    assert torch.equal(pyr.blur9(img, lp), pyr.blur9_plain(img, lp))
    down = pyr.scale_down(img, sd)
    assert tuple(down.shape) == (shape[0] // 2, shape[1] // 2)
    assert torch.equal(down, pyr.scale_down_plain(img, sd))
    up = pyr.scale_up(img)
    assert tuple(up.shape) == (2 * shape[0], 2 * shape[1])
    assert float((up - pyr.scale_up_plain(img)).abs().max()) <= 1e-4
    torch.cuda.synchronize()
    assert (_cuda.LAUNCHES["base_chain"], _cuda.LAUNCHES["scale_up"]) == (2, 1)


def test_detect_kernel_matches_plain(dev, pair):
    from sfm_tpu_torch.config import SiftConfig
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


@pytest.mark.parametrize("shape,octaves", [((575, 719), 5), ((40, 30), 3), ((576, 720), 5),
                                           ((1920, 2560), 5)])
def test_detect_octaves_launch_is_exact(dev, shape, octaves):
    """All octaves in one launch equal the per-octave launches and the
    plain version bit for bit (the 40 x 30 image's last octave, 10 x 7,
    fills less than one strip; 576 x 720 and 1920 x 2560 are the bench
    and up-scale paths' bases)."""
    from sfm_tpu_torch.config import SiftConfig
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.ops.detect import (detect_maps, detect_maps_octaves,
                                          detect_maps_plain)
    from sfm_tpu_torch.sift import pyramid

    cfg = SiftConfig(num_octaves=octaves)
    rng = np.random.default_rng(7)
    img = torch.as_tensor((rng.random(shape) * 255).astype(np.float32), device=dev)
    bases = pyramid.base_chain(img, cfg)
    taps = [pyramid.octave_kernel_bank(cfg, o) for o in range(octaves)]
    _cuda.reset_launches()
    multi = detect_maps_octaves(bases, taps, cfg.thresh, cfg.edge_limit)
    assert _cuda.LAUNCHES["detect_maps"] == 1
    n_cand = 0
    for (rk, ak), b, t in zip(multi, bases, taps):
        rs, as_ = detect_maps(b, t, cfg.thresh, cfg.edge_limit)
        rp, ap = detect_maps_plain(b, t, cfg.thresh, cfg.edge_limit)
        assert tuple(rk.shape) == tuple(b.shape) and tuple(ak.shape) == (11, *b.shape)
        for a, b2 in ((rk, rs), (ak, as_), (rk, rp), (ak, ap)):
            assert torch.equal(a, b2)
        n_cand += int((rp > 0).sum())
    assert n_cand > 0


def _noise(shape, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((rng.random(shape) * 255).astype(np.float32), device=dev)


@pytest.mark.parametrize("shape,up", [((576, 720), False), ((960, 1280), True)])
@pytest.mark.parametrize("lowest_scale", [0.0, 1.0])
def test_detect_gated_mode_equals_plain(dev, shape, up, lowest_scale):
    """K3's gated mode at the bench and up-scale shapes, octave o gated
    at lowest_scale / 2**o as the frontend runs it (and at gate 0 with
    lean=False): one launch, equal to the plain version bit for bit."""
    from sfm_tpu_torch.config import SiftConfig
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.ops.detect import detect_maps_octaves, detect_maps_plain
    from sfm_tpu_torch.sift import frontend, pyramid

    cfg = SiftConfig(up_scale=up, thresh=2.0 if up else 1.0,
                     init_blur=1.0 if up else 1.5, lowest_scale=lowest_scale)
    bases = pyramid.base_chain(_noise(shape, 9, dev), cfg)
    taps = frontend._tap_banks(cfg)
    gates = [lowest_scale / 2 ** o for o in range(cfg.num_octaves)]
    _cuda.reset_launches()
    multi = detect_maps_octaves(bases, taps, cfg.thresh, cfg.edge_limit, gates,
                                lean=False)
    assert _cuda.LAUNCHES["detect_maps"] == 1
    n_cand = 0
    for (rk, ak), b, t, g in zip(multi, bases, taps, gates):
        rp, ap = detect_maps_plain(b, t, cfg.thresh, cfg.edge_limit, g, lean=False)
        assert tuple(ak.shape) == (6, *b.shape)
        assert torch.equal(rk, rp) and torch.equal(ak, ap)
        n_cand += int((rp > 0).sum())
    assert n_cand > 1000


@pytest.mark.parametrize("num_scales,lean", [(8, True), (10, False), (10, True), (8, False)])
def test_detect_nine_octaves_and_up_to_13_planes(dev, num_scales, lean):
    """9 octaves take two launches (8 + 1) equal to the per-octave
    launches and the plain version bit for bit, at 11 and 13 planes; a
    bank of more planes than the card's shared memory per block holds is
    refused, naming that limit."""
    from sfm_tpu_torch.config import SiftConfig
    from sfm_tpu_torch.ops import _cuda, detect
    from sfm_tpu_torch.ops.detect import (detect_maps, detect_maps_octaves,
                                          detect_maps_plain)
    from sfm_tpu_torch.sift import pyramid

    cfg = SiftConfig(num_octaves=9, num_scales=num_scales,
                     lowest_scale=0.0 if lean else 1.0)
    bases = pyramid.base_chain(_noise((512, 640), 11, dev), cfg)
    assert tuple(bases[-1].shape) == (2, 2)
    taps = [pyramid.octave_kernel_bank(cfg, o) for o in range(9)]
    gates = [cfg.lowest_scale / 2 ** o for o in range(9)]
    _cuda.reset_launches()
    multi = detect_maps_octaves(bases, taps, cfg.thresh, cfg.edge_limit, gates, lean)
    assert _cuda.LAUNCHES["detect_maps"] == 2
    n_cand = 0
    for (rk, ak), b, t, g in zip(multi, bases, taps, gates):
        rs, as_ = detect_maps(b, t, cfg.thresh, cfg.edge_limit, g, lean)
        rp, ap = detect_maps_plain(b, t, cfg.thresh, cfg.edge_limit, g, lean)
        for x, y in ((rk, rs), (ak, as_), (rk, rp), (ak, ap)):
            assert torch.equal(x, y)
        n_cand += int((rp > 0).sum())
    assert n_cand > 100
    # Past what the card's shared memory per block holds, a bank is refused.
    wide = np.zeros((2, detect.max_planes(dev) + 1, 9), np.float32)
    with pytest.raises(ValueError, match="shared memory"):
        detect_maps_octaves(bases[:2], wide, 1.0, 10.0)


@pytest.mark.parametrize("num_scales", [11, 16])
@pytest.mark.parametrize("lean", [True, False])
def test_detect_past_13_planes_equals_plain(dev, num_scales, lean):
    """14 and 19 planes take the run-time-plane route: 9 octaves in two
    launches (8 + 1), equal bit for bit to the per-octave launches and
    to the plain version, lean and gated (octave o at 1 / 2**o)."""
    from sfm_tpu_torch.config import SiftConfig
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.ops.detect import (detect_maps, detect_maps_octaves,
                                          detect_maps_plain)
    from sfm_tpu_torch.sift import frontend, pyramid

    cfg = SiftConfig(num_octaves=9, num_scales=num_scales,
                     lowest_scale=0.0 if lean else 1.0)
    bases = pyramid.base_chain(_noise((512, 640), 12, dev), cfg)
    taps = frontend._tap_banks(cfg)
    assert taps.shape[1] == num_scales + 3
    gates = [cfg.lowest_scale / 2 ** o for o in range(9)]
    _cuda.reset_launches()
    multi = detect_maps_octaves(bases, taps, cfg.thresh, cfg.edge_limit, gates, lean)
    assert _cuda.LAUNCHES["detect_maps"] == 2
    n_cand = 0
    for (rk, ak), b, t, g in zip(multi, bases, taps, gates):
        rs, as_ = detect_maps(b, t, cfg.thresh, cfg.edge_limit, g, lean)
        rp, ap = detect_maps_plain(b, t, cfg.thresh, cfg.edge_limit, g, lean)
        for x, y in ((rk, rs), (ak, as_), (rk, rp), (ak, ap)):
            assert torch.equal(x, y)
        n_cand += int((rp > 0).sum())
    assert n_cand > 100


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("n1", [1, 33, 300, 5121, 23552])
@pytest.mark.parametrize("n2", [1, 700, 5121, 23552])
def test_match_kernel_ragged_sizes(dev, n1, n2, bf16):
    from sfm_tpu_torch.ops.match import match_top2, match_top2_plain
    from sfm_tpu_torch.utils.precision import f32_precision

    rng = np.random.default_rng(n1 * 7 + n2)
    d1 = np.abs(rng.normal(size=(n1, 128))).astype(np.float32)
    d2 = np.abs(rng.normal(size=(n2, 128))).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    v2 = rng.random(n2) > 0.1
    v2[0] = True
    args = [torch.as_tensor(a, device=dev) for a in (d1, d2, v2)]
    bk, sk, ik = match_top2(*args, bf16=bf16)
    with f32_precision():
        bp, sp, ip = match_top2_plain(*args, bf16=bf16)
    assert float((ik == ip).float().mean()) >= 0.999
    assert float((bk - bp).abs().max()) <= 1e-5
    assert float((sk - sp).abs().max()) <= 1e-5


@pytest.mark.parametrize("bf16", [True, False])
def test_match_ties_across_column_ranges(dev, bf16):
    """Exact duplicate columns placed in different column ranges of the
    split grid (the mode's own): the lower index wins and second equals
    best."""
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.ops.match import grid_split, match_top2

    n1, n2 = 256, 5121
    split, cols = grid_split(n1, n2, bf16, _cuda.sm_count(dev))
    assert split >= 3
    rng = np.random.default_rng(3)
    d2 = np.abs(rng.normal(size=(n2, 128))).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    # Row r's column src[r] (in range 0) duplicated exactly at
    # src[r] + cols and src[r] + 2 cols (ranges 1 and 2).
    src = rng.permutation(cols)[np.arange(n1) % cols]
    for k in (1, 2):
        d2[src + k * cols] = d2[src]
    d1 = d2[src].copy()
    v2 = np.ones(n2, bool)
    best, second, idx = match_top2(*(torch.as_tensor(a, device=dev)
                                     for a in (d1, d2, v2)), bf16=bf16)
    np.testing.assert_array_equal(idx.cpu().numpy(), src)
    assert torch.equal(best, second)
    # With the first copy invalid, the next range's copy wins.
    v2[src] = False
    best, second, idx = match_top2(*(torch.as_tensor(a, device=dev)
                                     for a in (d1, d2, v2)), bf16=bf16)
    np.testing.assert_array_equal(idx.cpu().numpy(), src + cols)
    assert torch.equal(best, second)


def test_match_f32_kernel_on_full_mantissas(dev):
    """K6's f32 mode (three TF32 passes) on signed unit rows whose low 13
    mantissa bits, the ones TF32 drops, are live, at ragged sizes: scores
    within 2e-6 of a float64 top-2 and within 1e-5 of the plain f32
    version; the float64 index on every row whose best leads by more
    than 1e-5."""
    from sfm_tpu_torch.ops.match import match_top2, match_top2_plain
    from sfm_tpu_torch.utils.precision import f32_precision

    rng = np.random.default_rng(13)
    n1, n2 = 1000, 3000
    d1, d2 = (rng.normal(size=(n, 128)) for n in (n1, n2))
    d1, d2 = ((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
              for d in (d1, d2))
    for d in (d1, d2):
        assert (d.view(np.uint32) & np.uint32(0x1FFF)).astype(bool).mean() > 0.99
    v2 = rng.random(n2) > 0.1
    args = [torch.as_tensor(a, device=dev) for a in (d1, d2, v2)]
    bk, sk, ik = (t.cpu().numpy() for t in match_top2(*args, bf16=False))
    with f32_precision():
        bp, sp, _ = (t.cpu().numpy() for t in match_top2_plain(*args, bf16=False))
    s = d1.astype(np.float64) @ d2.astype(np.float64).T + (v2 - 1.0) * 1e3
    i64 = s.argmax(1)
    b64 = s[np.arange(n1), i64]
    s[np.arange(n1), i64] = -np.inf
    s64 = np.maximum(s.max(1), -2.0)
    assert max(np.abs(bk - b64).max(), np.abs(sk - s64).max()) <= 2e-6
    assert max(np.abs(bk - bp).max(), np.abs(sk - sp).max()) <= 1e-5
    clear = (b64 - s64) > 1e-5
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(ik[clear], i64[clear])


@pytest.mark.parametrize("bf16", [False, True])
def test_match_kernel_all_columns_invalid(dev, bf16):
    from sfm_tpu_torch.ops.match import match_top2

    rng = np.random.default_rng(1)
    d1 = torch.as_tensor(rng.normal(size=(300, 128)).astype(np.float32), device=dev)
    d2 = torch.as_tensor(rng.normal(size=(700, 128)).astype(np.float32), device=dev)
    best, second, idx = match_top2(d1, d2, torch.zeros(700, dtype=torch.bool,
                                                       device=dev), bf16=bf16)
    assert bool((best == -2.0).all()) and bool((second == -2.0).all())
    assert not bool(idx.any())


def _keypoints(rng, K, H, W, dev):
    x = rng.uniform(0.5, W - 1.5, K).astype(np.float32)
    y = rng.uniform(0.5, H - 1.5, K).astype(np.float32)
    s = rng.uniform(0.8, 2.0, K).astype(np.float32)
    o = rng.uniform(0, 360, K).astype(np.float32)
    return (torch.as_tensor(a, device=dev) for a in (x, y, s, o))


@pytest.mark.parametrize("slots", ["random", "bench", "up-scale", "module API"])
def test_sample_kernels_match_plain(dev, pair, path_scene, slots):
    """K4 and K5 against their plain versions: on 256 random keypoints of
    the 192 x 256 pair (250 live), 99% of K4's rows within 1e-3 and K5 at
    random orientations to 1e-5; on the bench and up-scale paths' capped
    slots, 99.5% of K4's rows within 1e-3 and 0.01 deg, and K5 on K4's
    duplicates, compacted valid-first, to 1e-3; on the module API's
    5,120 detection slots, compacted valid-first, K5 at
    ``assign_orientations``' first orientations (K8's route) to 1e-3.
    Rows >= count zero."""
    from sfm_tpu_torch.ops import compact, sample
    from sfm_tpu_torch.sift import orient
    from sfm_tpu_torch.sift.describe import normalize_descriptors

    if slots == "random":
        atlas = torch.as_tensor(pair["img1"], device=dev)
        x, y, s, o = _keypoints(np.random.default_rng(0), 256, 192, 256, dev)
        count = torch.tensor(250, device=dev)
        share, ori_tol, k5_tol = 0.99, None, 1e-5
    else:
        atlas, x, y, s, count = _path_slots(path_scene, slots, dev)
        share, ori_tol, k5_tol = 0.995, 0.01, 1e-3
    n = int(count)
    if slots == "module API":
        live = torch.arange(x.shape[0], device=dev) < n
        o = orient.assign_orientations(atlas, x, y, s, live, use_pallas=True)[0]
    else:
        d1k, o1k, o2k, dk = sample.fused_orient_descriptor(atlas, x, y, s, count)
        d1p, o1p, o2p, dp = sample.fused_orient_descriptor_plain(atlas, x, y, s, count)
        agree = (normalize_descriptors(d1k) - normalize_descriptors(d1p)).abs().amax(1) <= 1e-3
        if ori_tol is not None:
            agree &= ((o1k - o1p + 180.0) % 360.0 - 180.0).abs() <= ori_tol
        assert float(agree[:n].float().mean()) >= share
        assert float((dk == dp)[:n].float().mean()) >= share
        assert not bool(d1k[n:].any()) and not bool(o1k[n:].any())
    if slots in ("bench", "up-scale"):
        dup = dk & (torch.arange(dk.shape[0], device=dev) < n)
        od = compact.compaction_order(dup)
        x, y, s, o, count = x[od], y[od], s[od], o2k[od], dup.sum().to(torch.int32)
        assert int(count) > 0
    rk = sample.descriptor_sample(atlas, x, y, s, o, count)
    rp = sample.descriptor_sample_plain(atlas, x, y, s, o, count)
    err = (normalize_descriptors(rk) - normalize_descriptors(rp)).abs().max()
    assert float(err) <= k5_tol
    assert not bool(rk[int(count):].any())


def _border_keypoints(rng, K, H, W, dev):
    """Keypoints of which a third hug the image's edges and corners."""
    x = rng.uniform(0.5, W - 1.5, K).astype(np.float32)
    y = rng.uniform(0.5, H - 1.5, K).astype(np.float32)
    n = K // 3
    x[:n] = rng.choice([0.2, 1.7, W - 2.3, W - 0.6], n)
    y[:n] = rng.uniform(0.1, H - 0.2, n)
    y[n:2 * n:2] = rng.choice([0.4, 2.5, H - 1.2, H - 0.3], len(y[n:2 * n:2]))
    s = rng.uniform(0.8, 2.0, K).astype(np.float32)
    return (torch.as_tensor(a.astype(np.float32), device=dev) for a in (x, y, s))


@pytest.mark.parametrize("shape", [(192, 256), (30, 40), (200, 130), "bench", "module API",
                                   "up-scale"])
def test_orientation_kernel_matches_plain(dev, path_scene, shape):
    """K8 within 1e-6 of the largest bin of its plain version, on random
    keypoints a third of which hug the image's edges, and on the slots
    the bench path, the module API and the up-scale path hand it."""
    from sfm_tpu_torch.ops import sample

    if isinstance(shape, str):
        img, x, y, s, count = _path_slots(path_scene, shape, dev)
    else:
        rng = np.random.default_rng(5)
        img = torch.as_tensor((rng.random(shape) * 255).astype(np.float32), device=dev)
        x, y, s = _border_keypoints(rng, 259, *shape, dev)
        count = torch.tensor(250, device=dev)
    n = int(count)
    hk = sample.orientation_histogram_sample(img, x, y, s, count)
    hp = sample.orientation_histogram_sample_plain(img, x, y, s, count)
    assert float((hk - hp).abs().max()) <= 1e-6 * float(hp.abs().max())
    assert not bool(hk[n:].any()) and bool((hk[:n].sum(1) > 0).all())


@pytest.mark.parametrize("shape", [(192, 256), (30, 40), (200, 130), "bench", "up-scale"])
def test_window_kernel_equals_fused_kernel(dev, path_scene, shape):
    """K9 equals K4 bit for bit, and its rows hold to the plain version
    (99% within 1e-3 on random keypoints, 99.5% on the bench and up-scale
    paths' capped slots)."""
    from sfm_tpu_torch.ops import sample
    from sfm_tpu_torch.sift.describe import normalize_descriptors

    if isinstance(shape, str):
        img, x, y, s, count = _path_slots(path_scene, shape, dev)
        share = 0.995
    else:
        rng = np.random.default_rng(6)
        img = torch.as_tensor((rng.random(shape) * 255).astype(np.float32), device=dev)
        x, y, s = _border_keypoints(rng, 203, *shape, dev)
        count = torch.tensor(198, device=dev)
        share = 0.99
    n = int(count)
    win = sample.fused_orient_descriptor_win(img, x, y, s, count)
    for a, b in zip(win, sample.fused_orient_descriptor(img, x, y, s, count)):
        assert torch.equal(a, b)
    d1p, o1p, _, dp = sample.fused_orient_descriptor_plain(img, x, y, s, count)
    row = (normalize_descriptors(win[0]) - normalize_descriptors(d1p)).abs().amax(1)
    assert float((row[:n] <= 1e-3).float().mean()) >= share
    assert float((win[3] == dp)[:n].float().mean()) >= share
    assert not bool(win[0][n:].any()) and not bool(win[3][n:].any())


@pytest.mark.parametrize("shape", [(192, 256), (30, 40), (200, 130), "bench", "up-scale"])
def test_descriptor_kernel_at_fused_orientation_equals_fused(dev, path_scene, shape):
    """K5 on K4's (x, y, scale, ori1) gives K4's d1 bit for bit: both run
    one warp device function for the descriptor; on random keypoints and
    on the bench and up-scale paths' capped slots."""
    from sfm_tpu_torch.ops import sample

    if isinstance(shape, str):
        img, x, y, s, count = _path_slots(path_scene, shape, dev)
    else:
        rng = np.random.default_rng(6)
        img = torch.as_tensor((rng.random(shape) * 255).astype(np.float32), device=dev)
        x, y, s = _border_keypoints(rng, 203, *shape, dev)
        count = torch.tensor(198, device=dev)
    d1, o1, _, _ = sample.fused_orient_descriptor(img, x, y, s, count)
    assert torch.equal(sample.descriptor_sample(img, x, y, s, o1, count), d1)
    assert bool(d1[:int(count)].any(dim=1).all())


@pytest.mark.parametrize("kernel", ["K4+K5", "K8", "K9"])
@pytest.mark.parametrize("K,count", [(1, 0), (1, 1), (13, 0), (13, 7), (13, 13),
                                     (203, 203)])
def test_sample_kernels_ragged_slots(dev, kernel, K, count):
    """K4 and K5, K8, and K9 at slot counts that fill no whole block (4
    warps), with none, some or all live: rows >= count exactly zero,
    live rows equal to the same keypoints' rows in a batch of 203 (K9's
    to K4's), one launch each."""
    from sfm_tpu_torch.ops import _cuda, sample

    rng = np.random.default_rng(8)
    img = torch.as_tensor((rng.random((192, 256)) * 255).astype(np.float32),
                          device=dev)
    x, y, s = _border_keypoints(rng, 203, 192, 256, dev)
    o = torch.as_tensor(rng.uniform(0, 360, 203).astype(np.float32), device=dev)
    c = torch.tensor(count, device=dev)
    if kernel == "K4+K5":
        full = (*sample.fused_orient_descriptor(img, x, y, s),
                sample.descriptor_sample(img, x, y, s, o))
        _cuda.reset_launches()
        out = (*sample.fused_orient_descriptor(img, x[:K], y[:K], s[:K], c),
               sample.descriptor_sample(img, x[:K], y[:K], s[:K], o[:K], c))
        names = ("fused_orient_descriptor", "descriptor_sample")
    elif kernel == "K8":
        full = (sample.orientation_histogram_sample(img, x, y, s),)
        _cuda.reset_launches()
        out = (sample.orientation_histogram_sample(img, x[:K], y[:K], s[:K], c),)
        names = ("orientation_histogram_sample",)
    else:
        full = sample.fused_orient_descriptor(img, x, y, s)
        _cuda.reset_launches()
        out = sample.fused_orient_descriptor_win(img, x[:K], y[:K], s[:K], c)
        names = ("fused_orient_descriptor_win",)
    torch.cuda.synchronize()
    assert all(_cuda.LAUNCHES[n] == 1 for n in names), _cuda.LAUNCHES
    assert sum(_cuda.LAUNCHES.values()) == len(names)
    for a, b in zip(out, full):
        assert a.shape[0] == K
        assert torch.equal(a[:count], b[:count])
        assert not bool(a[count:].any())


@pytest.mark.parametrize("K,lo,hi", [(203, 2.0, 6.0), (6000, 0.8, 2.0), (6000, 2.0, 6.0)])
def test_window_kernel_equals_fused_kernel_at_large_scales_and_many_slots(dev, K, lo, hi):
    """K9 equals K4 bit for bit where the samples clamp at the patch's
    edges (scales 2-6: the staged box is the whole patch, and more) and
    past the slots the card's resident warps cover at one slot each
    (6,000 slots: two buffers, each warp walking several slots), with
    rows >= count zero."""
    from sfm_tpu_torch.ops import sample

    rng = np.random.default_rng(9)
    shape = (300, 412)
    img = torch.as_tensor((rng.random(shape) * 255).astype(np.float32), device=dev)
    x, y, _ = _border_keypoints(rng, K, *shape, dev)
    s = torch.as_tensor(rng.uniform(lo, hi, K).astype(np.float32), device=dev)
    count = torch.tensor(K - 37, device=dev)
    win = sample.fused_orient_descriptor_win(img, x, y, s, count)
    for a, b in zip(win, sample.fused_orient_descriptor(img, x, y, s, count)):
        assert torch.equal(a, b)
    assert bool(win[0][:K - 37].any(dim=1).all()) and not bool(win[0][K - 37:].any())


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
    from sfm_tpu_torch.config import PipelineConfig, RansacConfig, SiftConfig
    from sfm_tpu_torch.models import two_view
    from sfm_tpu_torch.ops import _cuda

    cfg = PipelineConfig(sift=SiftConfig(num_octaves=3, max_pts_per_octave=256),
                         ransac=RansacConfig(n_hyps=256, threshold=3e-6))
    img1, img2, K = (torch.as_tensor(pair[k], device=dev)
                     for k in ("img1", "img2", "K"))
    _cuda.reset_launches()
    errs = []
    for seed in range(3):
        res = two_view.run_two_view(img1, img2, K, cfg, seed=seed)
        errs.append(pose_errors_deg(res.R.cpu().numpy(), res.t.cpu().numpy(),
                                    pair["R"], pair["t"]))
    off_path = {"scale_up", "orientation_histogram_sample",
                "fused_orient_descriptor_win", "pnp_lo"}   # pnp_lo: PnP, multi-view only
    assert all(_cuda.LAUNCHES[k] == 0 for k in off_path), _cuda.LAUNCHES
    assert all(n > 0 for k, n in _cuda.LAUNCHES.items() if k not in off_path), \
        _cuda.LAUNCHES
    assert _cuda.LAUNCHES["detect_maps"] == 6   # one per image: 3 seeds x 2
    rot, tdir = np.median(np.array(errs), axis=0)
    assert rot < 1.0 and tdir < 5.0, errs
    from sfm_tpu_torch.sift import frontend

    frontend.extract_sift(img1, dataclasses.replace(cfg.sift, up_scale=True,
                                                    sample_window=True))
    assert _cuda.LAUNCHES["scale_up"] == 1
    assert _cuda.LAUNCHES["fused_orient_descriptor_win"] == 1


def _ba_problem(seed=0, M=6, P=300):
    """A BA problem in numpy (every point seen by every camera, camera 0
    fixed, perturbed start): (R0, t0, X0, cam, pt, uv, mask, fixed)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-1, -1, 4], [1, 1, 7], (P, 3))
    Rs, ts = [], []
    for i in range(M):
        a = 0.08 * i
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        Rs.append(R)
        ts.append(-R @ np.array([0.4 * i, 0.05 * i, 0.0]))
    R, t = np.stack(Rs), np.stack(ts)
    cam, pt = np.repeat(np.arange(M), P), np.tile(np.arange(P), M)
    Xc = np.einsum("oij,oj->oi", R[cam], X[pt]) + t[cam]
    uv = Xc[:, :2] / Xc[:, 2:3] + rng.normal(scale=5e-4, size=(M * P, 2))
    mask = rng.random(M * P) > 0.05
    fixed = np.arange(M) == 0
    dR = np.stack([np.eye(3)] + [np.array([[1, -d, 0], [d, 1, 0], [0, 0, 1]])
                                 for d in rng.normal(scale=0.02, size=M - 1)])
    R0 = np.einsum("mij,mjk->mik", R, dR)
    t0 = t + np.where(fixed[:, None], 0.0, rng.normal(scale=0.02, size=t.shape))
    X0 = X + rng.normal(scale=0.02, size=X.shape)
    f32 = (lambda a: a.astype(np.float32))
    return (f32(R0), f32(t0), f32(X0), cam, pt, f32(uv), mask, fixed)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_run_ba_on_cuda_matches_cpu(dev, solver):
    """run_ba on the card against the CPU on the same problem: costs
    within 1e-3 relative (float atomics in the card's segment sums, and
    other BLAS), poses within 5e-4 (only camera 0 is fixed: the scale
    gauge is held by the LM damping alone, and f32 differences move
    the poses along it; 1.1e-4 measured on an H100), the fixed camera
    unchanged bit for bit."""
    from sfm_tpu_torch.models import bundle_adjust as ba

    R0, t0, X0, cam, pt, uv, mask, fixed = _ba_problem()
    out = {}
    for d in (torch.device("cpu"), dev):
        prob = ba.BAProblem(*(torch.as_tensor(a, device=d)
                              for a in (cam, pt, uv, mask, fixed)))
        fin, costs = ba.run_ba(*(torch.as_tensor(a, device=d) for a in (R0, t0, X0)),
                               prob, iters=10, solver=solver)
        out[d.type] = (fin, costs.cpu().numpy())
    (fc, cc), (fg, cg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(cg, cc, rtol=1e-3)
    assert cg[-1] < 0.1 * cg[0]
    np.testing.assert_allclose(fg.R.cpu().numpy(), fc.R.numpy(), atol=5e-4)
    np.testing.assert_allclose(fg.t.cpu().numpy(), fc.t.numpy(), atol=5e-4)
    assert torch.equal(fg.R[0].cpu(), torch.as_tensor(R0[0]))
    assert torch.equal(fg.t[0].cpu(), torch.as_tensor(t0[0]))


@pytest.mark.parametrize("M", [12, 36])
@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_run_ba_free_gauge_on_cuda_matches_float64(dev, solver, M):
    """A ring of M cameras with no camera fixed, so the 7-dimensional
    similarity gauge is held by the LM damping alone (where the JAX
    package's accelerator LU stalled 13% above the CPU cost): each
    solver on the card ends within 1e-4 of a float64 dense solve on the
    CPU, and every cost on the way within 1e-3 of it."""
    from ba_problems import ring_problem
    from sfm_tpu_torch.models import bundle_adjust as ba

    R0, t0, X0, *arrs = ring_problem(M=M, P=400)

    def T(a, d, dt):
        return torch.as_tensor(a, device=d, dtype=dt if a.dtype.kind == "f" else None)

    costs = {}
    for d, dt, s in ((torch.device("cpu"), torch.float64, "dense"),
                     (dev, torch.float32, solver)):
        prob = ba.BAProblem(*(T(a, d, dt) for a in arrs))
        _, c = ba.run_ba(*(T(a, d, dt) for a in (R0, t0, X0)), prob, iters=20,
                         solver=s)
        costs[d.type] = c.cpu().double().numpy()
    c64, c32 = costs["cpu"], costs["cuda"]
    assert np.isfinite(c32).all() and c32[-1] < 0.05 * c32[0]
    assert abs(c32[-1] / c64[-1] - 1) <= 1e-4, (c32[-1], c64[-1])
    np.testing.assert_allclose(c32, c64, rtol=1e-3)


def test_orbit_run_incremental_on_cuda(dev):
    """The 5-frame orbit of injected features on the card: every pose,
    ATE < 0.05, < 1 px (the JAX package's own bars), and within 2x the
    CPU run's ATE and 10% of its points."""
    import math

    from sfm_tpu_torch.config import PipelineConfig, RansacConfig
    from sfm_tpu_torch.models import incremental
    from sfm_tpu_torch.sift.frontend import Keypoints, SiftResult
    from sfm_tpu_torch.utils import metrics
    from synthetic_sequence import orbit_features

    frames, K, R_gt, t_gt = orbit_features(n_images=5)
    cfg = PipelineConfig(ransac=RansacConfig(n_hyps=512, threshold=3e-6, chunk=128))
    out = {}
    for d in (torch.device("cpu"), dev):
        feats = []
        for fr in frames:
            T = (lambda a: torch.as_tensor(a, device=d))
            ones = T(np.ones(256, np.float32))
            feats.append(SiftResult(
                keypoints=Keypoints(x=T(fr["x"]), y=T(fr["y"]), scale=ones,
                                    sharpness=ones, edgeness=ones,
                                    orientation=ones * 0,
                                    octave=T(np.zeros(256, np.int64)),
                                    valid=T(fr["valid"])),
                descriptors=T(fr["descriptors"])))
        res = incremental.run_incremental([None] * 5, K, cfg, ba_iters=12, feats=feats)
        st = res.state
        assert bool(st.pose_valid.all()), d
        ate, _ = metrics.ate_rmse(st.R.cpu(), st.t.cpu(), R_gt, t_gt)
        px = math.sqrt(float(res.mean_reproj) / 2) * 500.0
        assert ate < 0.05 and px < 1.0, (d, ate, px)
        out[d.type] = (ate, int(st.X_valid.sum()))
    assert out["cuda"][0] <= 2.0 * max(out["cpu"][0], 1e-3)
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 0.1 * out["cpu"][1]


def test_scatters_past_capacity_stay_in_range_on_cuda(dev):
    """The capacity index JAX drops (mode="drop") never reaches a CUDA
    scatter: appends past the capacity, sentinel and duplicate targets
    and a capped window give the CPU's results, and the card raises no
    device-side assert (it would surface at the synchronize)."""
    from sfm_tpu_torch.models import incremental as inc

    rng = np.random.default_rng(2)
    X_new = rng.normal(size=(64, 3)).astype(np.float32)
    new = np.arange(64) % 3 == 0                       # 22 new points, 10 slots left
    idx = np.r_[np.full(8, 5), rng.integers(0, 64, 56)]   # duplicates of slot 5
    keep = rng.random(64) < 0.7
    slot = np.where(np.arange(64) < 40, np.arange(64), 40)  # 24 rows at the capacity
    out = {}
    for d in (torch.device("cpu"), dev):
        def T(a):
            return torch.as_tensor(a, device=d)

        st = inc._empty_state(4, 64, 40, device=d)._replace(n_points=T(np.int64(30)))
        st, ids = inc._append_points(st, T(X_new), T(new))
        tbl = inc._set_last(T(np.full(64, -1)), T(idx), T(np.arange(64)), T(keep))
        rows = inc._set_rows(T(np.zeros((40, 3), np.float32)), T(slot), T(X_new))
        if d.type == "cuda":
            torch.cuda.synchronize()
        out[d.type] = [a.cpu() for a in (*st, ids, tbl, rows)]
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.equal(a, b)
    assert int(out["cuda"][2]) == 40 and int((out["cuda"][7] >= 0).sum()) == 10


def _ring_feats(frames, d):
    from sfm_tpu_torch.sift.frontend import Keypoints, SiftResult

    def T(a):
        return torch.as_tensor(a, device=d)

    out = []
    for fr in frames:
        ones = T(np.ones(len(fr["x"]), np.float32))
        out.append(SiftResult(
            keypoints=Keypoints(x=T(fr["x"]), y=T(fr["y"]), scale=ones, sharpness=ones,
                                edgeness=ones, orientation=ones * 0,
                                octave=T(np.zeros(len(fr["x"]), np.int64)),
                                valid=T(fr["valid"])),
            descriptors=T(fr["descriptors"])))
    return out


def _steps(R):
    from sfm_tpu_torch.models.turntable import _steps_deg_np

    return _steps_deg_np(R)


def test_refine_turntable_on_cuda_matches_cpu(dev):
    """The pinned LM with shared (f, k1) from the collapsed injected
    ring's fitted model (``synthetic_ring.injected_ring``): the card's run
    against the CPU's, steps to 1e-2 deg, rms and f to 1e-3 relative
    (float atomics in the triangulation's segment sums), >= 99% equal
    kept observations."""
    from sfm_tpu_torch.models import tracks as tr, turntable as tt
    from sfm_tpu_torch.config import PipelineConfig
    from synthetic_ring import INJECTED_K, injected_ring

    frames, Rc, tc, _, _ = injected_ring()
    out = {}
    for d in (torch.device("cpu"), dev):
        ts = tr.build_tracks(_ring_feats(frames, d), tr.ring_pairs(12, gaps=(1, 2)),
                             PipelineConfig())
        model = tt.fit_turntable(torch.as_tensor(Rc, device=d), torch.as_tensor(tc, device=d))
        m, intr, R, t, X, keep, rms = tt.refine_turntable(
            model, ts.cam_idx, ts.pt_idx, ts.uv_pix, ts.mask, INJECTED_K, n_frames=12,
            n_points=ts.n_tracks, iters=12, tri_rounds=3)
        assert R.device.type == d.type
        out[d.type] = (_steps(R), float(rms), float(intr[0]), keep.cpu().numpy())
    (sc, rc, fc, kc), (sg, rg, fg, kg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(sg, sc, atol=1e-2)
    assert rg == pytest.approx(rc, rel=1e-3) and fg == pytest.approx(fc, rel=1e-3)
    assert (kg == kc).mean() >= 0.99


@pytest.mark.parametrize("tf32", [False, True])
def test_reconstruct_turntable_on_cuda_matches_cpu(dev, tf32):
    """The whole turntable path on the injected ring, on the card against
    the CPU: tracks and observations >= 99% of the CPU's (K6's bf16
    tensor-core sums may flip a near-cutoff ratio), steps to 0.02 deg,
    total to 0.1 deg, rms to 2%, f to 0.1%, and the JAX package's own bar
    (mean step within 0.2 deg, std < 0.3, 360 +- 2 deg, < 1.5 px).  With
    TF32 turned on globally the entry points still pin it off: the same
    steps, and the global flags are left as they were."""
    from sfm_tpu_torch.config import PipelineConfig
    from sfm_tpu_torch.models import turntable as tt
    from synthetic_ring import INJECTED_K, injected_ring

    frames, Rc, tc, _, _ = injected_ring()
    out = {}
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    for d in (torch.device("cpu"), dev):
        if d.type == "cuda" and tf32:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        try:
            r = tt.reconstruct_turntable(_ring_feats(frames, d), Rc, tc, INJECTED_K,
                                         PipelineConfig(), pose_valid=np.ones(12, bool))
            if d.type == "cuda" and tf32:
                assert torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        assert r.R.device.type == d.type
        out[d.type] = r
    c, g = out["cpu"], out["cuda"]
    assert g.tracks.n_tracks >= 0.99 * c.tracks.n_tracks
    assert g.tracks.cam_idx.shape[0] >= 0.99 * c.tracks.cam_idx.shape[0]
    assert int(g.keep.sum()) >= 0.99 * int(c.keep.sum())
    sg, sc = g.step_deg.numpy(), c.step_deg.numpy()
    np.testing.assert_allclose(sg, sc, atol=2e-2)
    assert g.total_deg == pytest.approx(c.total_deg, abs=0.1)
    assert g.rms_px == pytest.approx(c.rms_px, rel=2e-2)
    assert g.f == pytest.approx(c.f, rel=1e-3)
    assert abs(sg.mean() - 30.0) < 0.2 and sg.std() < 0.3
    assert abs(g.total_deg - 360.0) < 2.0 and g.rms_px < 1.5


def _distorted_orbit(rng, M=6, P=160, f=2800.0, k1=-0.28, noise_px=0.15):
    """tests/test_calibrate.py's distorted orbit in numpy: M cameras 10
    degrees apart around 160 points, pixel observations with k1, camera 0
    fixed; the start perturbed as its joint test perturbs it."""
    from helpers import rot

    X = rng.uniform([-1, -1, -1], [1, 1, 1], size=(P, 3)).astype(np.float32)
    Rs = [rot([0, 1, 0], np.radians(10.0) * i) for i in range(M)]
    ts = [-Ri @ (Ri.T @ np.array([0.0, 0.0, -6.0])) for Ri in Rs]
    R, t = np.stack(Rs).astype(np.float32), np.stack(ts).astype(np.float32)
    cam, pt = np.repeat(np.arange(M), P), np.tile(np.arange(P), M)
    Xc = np.einsum("oij,oj->oi", R[cam], X[pt]) + t[cam]
    xn = Xc[:, :2] / Xc[:, 2:3]
    uv = (360.0, 288.0) + f * xn * (1.0 + k1 * (xn ** 2).sum(1, keepdims=True))
    uv = (uv + rng.normal(scale=noise_px, size=uv.shape)).astype(np.float32)
    Rn = R.copy()
    for i in range(1, M):
        Rn[i] = Rn[i] @ rot(rng.normal(size=3), 0.015)
    tn = t + np.where(np.arange(M)[:, None] > 0, rng.normal(scale=0.02, size=t.shape),
                      0).astype(np.float32)
    Xn = X + rng.normal(scale=0.02, size=X.shape).astype(np.float32)
    fixed = np.zeros(M, bool)
    fixed[0] = True
    return Rn, tn, Xn, cam, pt, np.ones(M * P, bool), fixed, uv


def test_run_ba_joint_on_cuda_matches_cpu(dev):
    """The bordered joint LM (25 iterations from a 12% wrong focal) on the
    card against the CPU: costs to 1e-3 relative, f to 1e-4, the
    predicted pixel radius to 0.02 px, poses to 1e-4."""
    from sfm_tpu_torch.models import calibrate as cal

    arrays = _distorted_orbit(np.random.default_rng(5))
    out = {}
    for d in (torch.device("cpu"), dev):
        T = [torch.as_tensor(a, device=d) for a in arrays]
        intr = cal.Intrinsics(*(torch.tensor(v, device=d)
                                for v in (0.88 * 2800.0, 360.0, 288.0, 0.0, 0.0)))
        (R, t, X), it, costs = cal.run_ba_joint(*T, intr, iters=25, huber_px=2.0)
        assert costs.device.type == d.type
        out[d.type] = (R.cpu().numpy(), costs.cpu().numpy(),
                       [float(v) for v in (it.f, it.k1, it.k2)])
    (Rc, cc, ic), (Rg, cg, ig) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(cg, cc, rtol=1e-3)
    assert cg[-1] < 0.05 * cg[0]
    assert ig[0] == pytest.approx(ic[0], rel=1e-4)
    r = np.linspace(0, 0.13, 64)
    px = [i[0] * r * (1 + i[1] * r * r + i[2] * r ** 4) for i in (ic, ig)]
    assert np.abs(px[0] - px[1]).max() < 0.02
    np.testing.assert_allclose(Rg, Rc, atol=1e-4)
    assert abs(ig[0] - 2800.0) / 2800.0 < 0.02 and abs(ig[1] + 0.28) < 0.05


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_free_ba_stage_on_cuda_matches_float64(dev, solver, tmp_path, monkeypatch):
    """The turntable free-BA stage (no camera fixed: the 7-dimensional
    gauge held by the LM damping alone), dumped by SFM_TPU_TT_DUMP from the
    injected ring's run on the card and rebuilt by ``free_ba_problem``:
    30 LM iterations of each solver on the card end within 1e-4 of a
    float64 CPU solve (relative cost)."""
    from sfm_tpu_torch.config import PipelineConfig
    from sfm_tpu_torch.models import bundle_adjust as ba, turntable as tt
    from synthetic_ring import INJECTED_K, injected_ring

    frames, Rc, tc, _, _ = injected_ring()
    dump = tmp_path / "ba.npz"
    monkeypatch.setenv("SFM_TPU_TT_DUMP", str(dump))
    tt.reconstruct_turntable(_ring_feats(frames, dev), Rc, tc, INJECTED_K,
                             PipelineConfig(), pose_valid=np.ones(12, bool))
    R, t, X, problem, delta = tt.free_ba_problem(dump, dev)
    assert not bool(problem.fixed.any())

    def f64(a):
        return a.detach().cpu().double() if a.is_floating_point() else a.cpu()

    _, ref = ba.run_ba(f64(R), f64(t), f64(X), ba.BAProblem(*map(f64, problem)),
                       iters=30, huber_delta=delta, solver="dense")
    _, costs = ba.run_ba(R, t, X, problem, iters=30, huber_delta=delta, solver=solver)
    c, c_ref = float(costs[-1]), float(ref[-1])
    assert bool(torch.isfinite(costs).all()) and c < float(costs[0])
    assert abs(c - c_ref) / c_ref <= 1e-4, (solver, c, c_ref)


def test_dist_match_on_a_one_rank_mesh_equals_the_local_match(dev):
    """dist_match_top2 and dist_match on a one-rank NCCL mesh launch K6
    once each on the rank's block (all of the right set) and equal the
    local calls bit for bit: the one-rank all-gather is a copy, and the
    float64 it carries holds the f32 scores and the indices exactly."""
    from sfm_tpu_torch.config import MatchConfig
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.ops.match import match_top2
    from sfm_tpu_torch.parallel import dist_match, mesh as meshmod
    from sfm_tpu_torch.sift import match

    rng = np.random.default_rng(5)
    d1, d2 = (torch.nn.functional.normalize(torch.as_tensor(
        rng.normal(size=(n, 128)).astype(np.float32), device=dev), dim=1)
        for n in (1000, 2048))
    v2 = torch.as_tensor(rng.random(2048) > 0.1, device=dev)
    with meshmod.make_mesh(1, device=dev) as mesh:
        assert mesh.backend == "nccl" and mesh.device == dev
        _cuda.reset_launches()
        top2 = dist_match.dist_match_top2(d1, meshmod.put_sharded(mesh, d2), v2, mesh)
        m = dist_match.dist_match(d1, d2, None, v2, MatchConfig(), mesh=mesh)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["match_top2"] == 2
    for a, b in zip(top2, match_top2(d1, d2, v2)):
        assert torch.equal(a, b)
    for a, b in zip(m, match.match(d1, d2, None, v2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("solver", ["cg", "dense"])
def test_run_dist_ba_on_a_one_rank_mesh_equals_run_ba(dev, solver):
    """run_dist_ba on a one-rank NCCL mesh against run_ba on the card,
    both with deterministic algorithms (no float atomics in the segment
    sums): on the same inputs (the one-block partition) bit for bit,
    the one-rank all-reduce being a copy; on the problem as it came
    (the partition drops the masked slots, so the cost sums in another
    order) the costs to 1e-5 relative."""
    from sfm_tpu_torch.models import bundle_adjust as ba
    from sfm_tpu_torch.parallel import dist_ba, mesh as meshmod

    R0, t0, X0, *arrs = (torch.as_tensor(a, device=dev) for a in _ba_problem())
    prob = ba.BAProblem(*arrs)
    X_sh, prob_sh = dist_ba.partition_problem(prob, X0, 1)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with meshmod.make_mesh(1, device=dev) as mesh:
            out = dist_ba.run_dist_ba(R0, t0, X_sh, prob_sh, mesh, iters=10,
                                      solver=solver)
        same, c_same = ba.run_ba(R0, t0, X_sh, prob_sh, iters=10, solver=solver)
        _, c_came = ba.run_ba(R0, t0, X0, prob, iters=10, solver=solver)
    finally:
        torch.use_deterministic_algorithms(False)
    for a, b in zip(out, (same.R, same.t, same.X, c_same)):
        assert torch.equal(a, b)
    np.testing.assert_allclose(out[3].cpu().numpy(), c_came.cpu().numpy(), rtol=1e-5)


def test_two_ranks_sharing_the_card_over_gloo(dev):
    """Two processes on one card joined over gloo (collectives staged
    through host memory): K6 once per rank on its half of the right
    set, the merged top-2 equal to the local K6 match (the kernel's
    scores do not depend on the column range: indices and scores
    exactly); run_dist_ba (CG) on the 16-camera rig within 1e-3 of
    run_ba's cost on the card, the same on both ranks."""
    from ba_problems import rig_problem
    from sfm_tpu_torch.models import bundle_adjust as ba
    from sfm_tpu_torch.ops.match import match_top2
    from torch_dist_worker import run_ranks

    rng = np.random.default_rng(6)
    d1, d2 = (rng.normal(size=(n, 128)).astype(np.float32) for n in (1024, 2048))
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    v2 = np.ones(2048, bool)
    R0, t0, X0, cam, pt, uv, mask, fixed = rig_problem(M=8, P=1024, obs_per_cam=512)
    f32 = (lambda a: a.astype(np.float32))
    cases = {"match/a/d1": d1, "match/a/d2": d2, "match/a/v2": v2,
             "match/a/bf16": np.bool_(True),
             "ba/cg/R": f32(R0), "ba/cg/t": f32(t0), "ba/cg/X": f32(X0), "ba/cg/cam": cam,
             "ba/cg/pt": pt, "ba/cg/uv": f32(uv), "ba/cg/mask": mask, "ba/cg/fixed": fixed,
             "ba/cg/iters": np.int64(8), "ba/cg/solver": np.str_("cg"),
             "ba/cg/cg_iters": np.int64(32)}
    results, lines = run_ranks(cases, device=f"cuda:{dev.index}", world=2)
    best, second, idx = (a.cpu().numpy() for a in match_top2(
        *(torch.as_tensor(a, device=dev) for a in (d1, d2, v2))))
    for r in results:
        assert int(r["launches/match_top2"]) == 2      # dist_match_top2, dist_match
        np.testing.assert_array_equal(r["match/a/index"], idx)
        np.testing.assert_array_equal(r["match/a/best"], best)
        np.testing.assert_array_equal(r["match/a/second"], second)
    assert lines[0] == lines[1]
    prob = ba.BAProblem(*(torch.as_tensor(a, device=dev) for a in
                          (cam, pt, f32(uv), mask, fixed)))
    _, costs = ba.run_ba(*(torch.as_tensor(f32(a), device=dev) for a in (R0, t0, X0)),
                         prob, iters=8, solver="cg")
    c = results[0]["ba/cg/costs"]
    assert np.isfinite(c).all() and np.all(np.diff(c) <= 0)
    assert abs(c[-1] / float(costs[-1]) - 1) <= 1e-3


# ---- the XLA routes (fused_detect=False, use_pallas=False, the f32 matcher)

XLA_SIFT = dict(num_octaves=3, max_pts_per_octave=512, fused_detect=False,
                use_pallas=False)


def test_dense_dog_on_cuda_equals_cpu(dev, pair):
    """build_pyramid on the card: the chain's bases and the blur bank's
    DoG (explicit shifted f32 multiply-adds, no cuDNN) equal the CPU's
    bit for bit, with and without up_scale."""
    from sfm_tpu_torch.config import SiftConfig
    from sfm_tpu_torch.sift import pyramid

    for up_scale in (False, True):
        cfg = SiftConfig(**XLA_SIFT, up_scale=up_scale)
        img = torch.as_tensor(pair["img1"])
        for g, c in zip(pyramid.build_pyramid(img.to(dev), cfg),
                        pyramid.build_pyramid(img, cfg)):
            assert torch.equal(g.base.cpu(), c.base)
            assert torch.equal(g.dog.cpu(), c.dog)


@pytest.mark.parametrize("fused_detect,use_pallas", [(False, False), (False, True),
                                                     (True, False)])
def test_xla_route_extract_sift_on_cuda_matches_cpu(dev, pair, fused_detect,
                                                    use_pallas):
    """extract_sift on the card against the CPU for the routes with an
    XLA knob: equal counts and validity; on the dense route keypoints
    within 1e-3 px and descriptors corr > 0.999 slot by slot, on K3's
    maps 99% of the keypoints within 1e-3 px as a set; two-stage
    sampling launches the base chain, K8 and K5 once each and never K4
    or K9, and the dense route never K3."""
    from sfm_tpu_torch.config import SiftConfig
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.sift import frontend

    cfg = SiftConfig(**{**XLA_SIFT, "fused_detect": fused_detect,
                        "use_pallas": use_pallas})
    img = torch.as_tensor(pair["img1"])
    _cuda.reset_launches()
    g = frontend.extract_sift(img.to(dev), cfg)
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    c = frontend.extract_sift(img, cfg)
    gk, ck = g.keypoints, c.keypoints
    v = ck.valid
    assert int(v.sum()) > 500
    assert torch.equal(gk.valid.cpu(), v)
    if fused_detect:
        # K3's responses on the card and the CPU differ in the last bits,
        # so two near-equal ones may swap their slots: as sets.
        pg = torch.stack([gk.x.cpu(), gk.y.cpu()], -1)[v]
        pc = torch.stack([ck.x, ck.y], -1)[v]
        d = torch.cdist(pg, pc, compute_mode="donot_use_mm_for_euclid_dist")
        assert float((d.min(dim=1).values <= 1e-3).float().mean()) >= 0.99
    else:
        d = torch.hypot(gk.x.cpu() - ck.x, gk.y.cpu() - ck.y)[v]
        assert float(d.max()) <= 1e-3
        assert float((g.descriptors.cpu() * c.descriptors).sum(1)[v].min()) > 0.999
    assert launches["base_chain"] == 1
    assert launches["detect_maps"] == (1 if fused_detect else 0)
    if use_pallas is False:
        assert (launches["orientation_histogram_sample"], launches["descriptor_sample"],
                launches["fused_orient_descriptor"],
                launches["fused_orient_descriptor_win"]) == (1, 1, 0, 0)


@pytest.mark.parametrize("path", ["small", "bench", "up-scale"])
def test_xla_route_kernels_match_plain_at_its_shapes(dev, pair, path_scene, path):
    """K8 on the route's capped slots, K5 on its 2K compacted slots and
    K6 in its f32 mode on its descriptor sets, against their plain
    versions: K8 within 1e-6 of the largest bin, K5 to 1e-5 and corr >
    0.9999, K6 f32 scores within 1e-5 and the same index wherever the
    best leads the second by more than that; rows >= count zero.  On the
    small pair at ``XLA_SIFT``, and on the bench and up-scale paths'
    pairs and configs on the route (K6 at 5,120^2 and 23,552^2)."""
    from sfm_tpu_torch.config import SiftConfig
    from sfm_tpu_torch.ops import compact, match, sample
    from sfm_tpu_torch.sift import describe, frontend, orient
    from sfm_tpu_torch.utils.precision import f32_precision

    if path == "small":
        cfg = SiftConfig(**XLA_SIFT)
    else:
        pair, cfg = path_scene(path)
        cfg = dataclasses.replace(cfg, fused_detect=False, use_pallas=False)
    atlas, dets = frontend.detect_stage(torch.as_tensor(pair["img1"], device=dev), cfg)
    x, y, s, v, sh = (torch.cat([getattr(d, f) for d in dets])
                      for f in ("x", "y", "scale", "valid", "sharpness"))
    o = frontend._sample_order(v, sh, cfg.sample_cap, [d.x.shape[0] for d in dets])
    x, y, s, v = x[o], y[o], s[o], v[o]
    count = v.sum().to(torch.int32)
    hk = sample.orientation_histogram_sample(atlas, x, y, s, count)
    hp = sample.orientation_histogram_sample_plain(atlas, x, y, s, count)
    assert float((hk - hp).abs().max()) <= 1e-6 * float(hp.abs().max())
    assert not bool(hk[int(count):].any())
    o1, o2, v2 = orient.orientations_from_histograms(hp, v)
    valid2 = torch.cat([v, v2])
    oc = compact.compaction_order(valid2)
    args = [torch.cat([a, b])[oc] for a, b in ((x, x), (y, y), (s, s), (o1, o2))]
    c2 = valid2.sum().to(torch.int32)
    rk = sample.descriptor_sample(atlas, *args, c2)
    rp = sample.descriptor_sample_plain(atlas, *args, c2)
    assert float((rk - rp).abs().max()) <= 1e-5 * float(rp.abs().max())
    nk, np_ = describe.normalize_descriptors(rk), describe.normalize_descriptors(rp)
    assert float((nk * np_).sum(1)[:int(c2)].min()) > 0.9999
    assert not bool(rk[int(c2):].any())
    s1 = frontend.extract_sift(torch.as_tensor(pair["img1"], device=dev), cfg)
    s2 = frontend.extract_sift(torch.as_tensor(pair["img2"], device=dev), cfg)
    a, b, vb = s1.descriptors, s2.descriptors, s2.keypoints.valid
    bk, sk, ik = match.match_top2(a, b, vb, bf16=False)
    with f32_precision():
        bp, sp, ip = match.match_top2_plain(a, b, vb, bf16=False)
    assert float((bk - bp).abs().max()) <= 1e-5
    assert float((sk - sp).abs().max()) <= 1e-5
    assert not bool(((ik != ip) & ((bp - sp) > 1e-5)).any())


def test_match_use_pallas_false_launches_k6_f32(dev, monkeypatch):
    """MatchConfig(use_pallas=False) with bf16=True: one K6 launch in its
    f32 mode, the f32 top-2 exactly; dist_match on a one-rank mesh
    too."""
    from sfm_tpu_torch.config import MatchConfig
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.parallel import dist_match as dm, mesh as meshmod
    from sfm_tpu_torch.sift import match

    rng = np.random.default_rng(8)
    d1, d2 = (torch.nn.functional.normalize(torch.as_tensor(
        rng.normal(size=(n, 128)).astype(np.float32), device=dev), dim=1)
        for n in (1500, 2048))
    v2 = torch.as_tensor(rng.random(2048) > 0.1, device=dev)
    modes = []
    real = match.match_top2

    def spy(*args, bf16):
        modes.append(bf16)
        return real(*args, bf16=bf16)

    monkeypatch.setattr(match, "match_top2", spy)
    monkeypatch.setattr(dm, "match_top2", spy)
    cfg = MatchConfig(use_pallas=False, bf16=True)
    _cuda.reset_launches()
    m = match.match(d1, d2, None, v2, cfg)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["match_top2"] == 1 and modes == [False]
    best, _, idx = real(d1, d2, v2, bf16=False)
    assert torch.equal(m.index, idx.to(torch.int64)) and torch.equal(m.score, best)
    with meshmod.make_mesh(1, device=dev) as mesh:
        md = dm.dist_match(d1, d2, None, v2, cfg, mesh=mesh)
    assert modes == [False, False]
    assert torch.equal(md.index, m.index) and torch.equal(md.score, m.score)


def _profiled(fn):
    """``fn()`` under ``torch.profiler`` (CPU and CUDA) inside the
    benchmark's slice range: (fn's result, the slice's profile)."""
    from portbench.harness import trace

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.SLICE):
            out = fn()
            torch.cuda.synchronize()
    return out, trace.read_profile(prof, (), 1)


def test_host_syncs_count_each_planted_sync(dev):
    """Under the profiler, a span's ``host_syncs`` counts each blocking
    read back: three ``.item()`` calls and one boolean-mask index (its
    ``nonzero`` reads the count back) inside their spans, none for
    device-side work; the sync debug mode is restored after."""
    from sfm_tpu_torch.utils import timing

    x = torch.arange(64, device=dev, dtype=torch.float32)
    timing.reset()

    def planted():
        with timing.span("planted.outer"):
            with timing.span("planted.item"):
                for _ in range(3):
                    x.sum().item()
            with timing.span("planted.mask"):
                y = x[x > 40.0]
            with timing.span("planted.none"):
                z = (x * 2.0).cumsum(0)
        return y, z

    _profiled(planted)
    recs = {r.name: r for r in timing.records()}
    assert recs["planted.item"].host_syncs == 3
    assert recs["planted.mask"].host_syncs == 1
    assert recs["planted.none"].host_syncs == 0
    assert recs["planted.outer"].host_syncs == 4
    assert torch.cuda.get_sync_debug_mode() == 0


def test_k6_launch_falls_inside_match_top2(dev):
    """K6's launch (the runtime call the profiler ties to its kernel)
    falls inside the program's ``match.top2`` span, which counts its one
    launch."""
    from sfm_tpu_torch.config import MatchConfig
    from sfm_tpu_torch.sift import match
    from sfm_tpu_torch.utils import timing

    rng = np.random.default_rng(9)
    d1, d2 = (torch.nn.functional.normalize(torch.as_tensor(
        rng.normal(size=(n, 128)).astype(np.float32), device=dev), dim=1)
        for n in (1500, 2048))
    match.match(d1, d2, None, None, MatchConfig())
    timing.reset()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        match.match(d1, d2, None, None, MatchConfig())
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    k6 = {e.correlation_id() for e in events
          if e.device_type() == torch.autograd.DeviceType.CUDA and "match_tc_kernel" in e.name()}
    launches = [e.start_ns() for e in events
                if e.device_type() == torch.autograd.DeviceType.CPU
                and e.correlation_id() in k6 and e.name().startswith("cuda")]
    (top2,) = [r for r in timing.records() if r.name == "match.top2"]
    assert len(k6) == 1 and len(launches) == 1
    assert top2.t0_ns <= launches[0] <= top2.t1_ns
    assert top2.kernel_launches == 1


def _bench_refine_calls(path_scene, dev, monkeypatch):
    """The bench pair's first two K10 calls, captured from
    ``two_view_pipeline`` at bench.py's config with seed 0: the probe's
    (8 starts x 6 steps) and the first refine round's (1 x 10), each as
    (args, kwargs)."""
    from path_configs import slice_config
    from sfm_tpu_torch.geometry import refine
    from sfm_tpu_torch.models import two_view

    scene, _ = path_scene("bench")
    img1, img2, K = (torch.as_tensor(scene[k], device=dev) for k in ("img1", "img2", "K"))
    seen = []
    fn = refine.refine_relative_pose

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return fn(*args, **kwargs)

    monkeypatch.setattr(refine, "refine_relative_pose", spy)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    two_view.two_view_pipeline(img1, img2, K, gen, slice_config())
    monkeypatch.setattr(refine, "refine_relative_pose", fn)
    return seen[:2]


@pytest.mark.parametrize("B,n,iters,weights", [
    *(pytest.param(*c, id="-".join(map(str, c))) for c in itertools.product(
        [1, 8], [37, 2560, 9000], [1, 6, 10], ["bool [N]", "float [B, N]"])),
    pytest.param(8, 2560, 6, "bench pair", id="8-2560-6-bench pair"),
    pytest.param(1, 2560, 10, "bench pair", id="1-2560-10-bench pair")])
def test_refine_kernel_matches_plain(dev, path_scene, monkeypatch, B, n, iters, weights):
    """K10 against the plain route (``refine_relative_pose_plain``: five
    ``jvp`` columns, cuBLAS products, ``solve_ex``), both in float32 on
    the card, each measured against the plain route in float64: K10's
    error may pass the plain f32 route's own by 1e-4 relative in the
    costs, 1e-3 deg in R and t after one step and 2e-3 deg after more.
    The f32 floor sets that form: a residual of ~5e-4 evaluated by
    cancellation carries ~2e-7 of rounding, so a cost a step brings
    near its minimum is known to ~1e-4 relative, and once a start
    converges, a step taken or refused on that rounding moves the pose
    along the cost's flat valley; on these scenes the plain f32 route
    alone sits up to 7e-5 relative and 2e-3 deg from float64 (CPU
    runs).  On the bench pair's own calls (the probe and the first
    round, captured from ``two_view_pipeline``), whose narrow field
    lets both f32 routes drift ~2e-4 deg in R and ~1e-3 deg in t, K10
    may pass the plain route by 5e-4 deg in R and 1.5e-3 deg in t.
    LAUNCHES counts one launch per call."""
    from sfm_tpu_torch.geometry import refine
    from sfm_tpu_torch.ops import _cuda

    if weights == "bench pair":
        args, kw = _bench_refine_calls(path_scene, dev, monkeypatch)[B == 1]
        assert (args[0].reshape(-1, 9).shape[0], args[2].shape[0], kw["iters"]) == (B, n, iters)
        rot_tol, t_tol = 5e-4, 1.5e-3
    else:
        Rs, ts, x1, x2, w_bool, w_float = refine_problem(100 * B + n + iters, n, B)
        w = w_bool if weights == "bool [N]" else w_float
        args = [torch.as_tensor(a, device=dev) for a in (Rs, ts, x1, x2, w)]
        if B == 1:   # the unbatched form: R [3, 3], t [3], weights [N]
            args = [args[0][0], args[1][0], *args[2:4], args[4].reshape(n)]
        args, kw = args[:4], dict(weights=args[4], iters=iters)
        rot_tol = t_tol = 1e-3 if iters == 1 else 2e-3
    _cuda.reset_launches()
    k = refine.refine_relative_pose(*args, **kw)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["refine_relative_pose"] == 1
    p = refine.refine_relative_pose_plain(*args, **kw)
    p64 = refine.refine_relative_pose_plain(*(a.double() for a in args),
                                            **{**kw, "weights": kw["weights"].double()})
    assert _cuda.LAUNCHES["refine_relative_pose"] == 1
    for a, b in zip(k, p):
        assert a.shape == b.shape and a.dtype == torch.float32 and a.is_cuda
    assert bool(torch.isfinite(k.R).all() and torch.isfinite(k.t).all())
    assert torch.allclose(k.E, refine.essential_from_pose(k.R, k.t), atol=1e-6)
    for name in ("cost", "initial_cost"):
        exact = getattr(p64, name)
        err_k, err_p = ((getattr(r, name).double() - exact).abs() / exact.abs() for r in (k, p))
        assert bool((err_k <= err_p + 1e-4).all()), (name, err_k, err_p)
    host = lambda r: (r.R.cpu().numpy().reshape(-1, 3, 3), r.t.cpu().numpy().reshape(-1, 3))
    rot_k, t_k = pose_errors_deg(*host(k), *host(p64))
    rot_p, t_p = pose_errors_deg(*host(p), *host(p64))
    assert (rot_k <= rot_p + rot_tol).all(), (rot_k, rot_p)
    assert (t_k <= t_p + t_tol).all(), (t_k, t_p)


def test_refine_kernel_checks_its_inputs(dev):
    """K10's wrapper refuses what the kernel does not take; float64 on
    the card takes the plain route, without a launch."""
    from sfm_tpu_torch.geometry import refine
    from sfm_tpu_torch.ops import _cuda

    Rs, ts, x1, x2, w_bool, w_float = refine_problem(0, 50, 3)
    R, t, a, b = (torch.as_tensor(v, device=dev) for v in (Rs, ts, x1, x2))
    with pytest.raises(ValueError):
        refine.refine_relative_pose(R, t, a[:, :2].contiguous(), b[:, :2].contiguous())
    with pytest.raises(ValueError):
        refine.refine_relative_pose(R, t, a, b, weights=torch.ones((2, 50), device=dev))
    with pytest.raises(ValueError):
        refine.refine_relative_pose(R.double(), t, a, b)
    _cuda.reset_launches()
    out = refine.refine_relative_pose(R.double(), t.double(), a.double(), b.double(),
                                      weights=torch.as_tensor(w_float, device=dev), iters=2)
    assert out.R.dtype == torch.float64 and _cuda.LAUNCHES["refine_relative_pose"] == 0


def _lo_inputs(problem, dev, monkeypatch):
    """``ransac_pnp`` on the card with the problem's minimal sets and
    prior, the arguments its LO stage was handed, and its result."""
    from sfm_tpu_torch.geometry import pnp

    x, X, R_init, t_init, mask, sets = (torch.as_tensor(a, device=dev) for a in problem)
    seen = []
    lo = pnp.pnp_lo

    def spy(*args, **kwargs):
        seen.append((args, kwargs))
        return lo(*args, **kwargs)

    monkeypatch.setattr(pnp, "pnp_lo", spy)
    res = pnp.ransac_pnp(x, X, mask, minimal_sets=sets, n_hyps=sets.shape[0],
                         threshold=1.2e-5, R_init=R_init, t_init=t_init)
    monkeypatch.setattr(pnp, "pnp_lo", lo)
    (args, kwargs), = seen
    return args, kwargs, res


def _sequence_lo_call(dev, monkeypatch):
    """The LO inputs of the last frame ``run_incremental`` registers on
    the 12-frame 576 x 720 arc at the CLI's defaults with closure (0,
    11), and K11's output in that run: (args, kwargs, output)."""
    from sfm_tpu_torch.config import PipelineConfig, RansacConfig, SiftConfig
    from sfm_tpu_torch.geometry import pnp
    from sfm_tpu_torch.models import incremental
    from synthetic_sequence import synthetic_sequence

    seq = synthetic_sequence(576, 720, n_frames=12)
    seen = []
    lo = pnp.pnp_lo

    def spy(*args, **kwargs):
        out = lo(*args, **kwargs)
        seen.append((args, kwargs, out))
        return out

    monkeypatch.setattr(pnp, "pnp_lo", spy)
    cfg = PipelineConfig(sift=SiftConfig(max_pts_per_octave=1024),
                         ransac=RansacConfig(n_hyps=1024, threshold=3e-6))
    incremental.run_incremental([torch.as_tensor(im, device=dev) for im in seq["images"]],
                                seq["K"], cfg, seed=0, ba_iters=20, closure_pairs=[(0, 11)])
    monkeypatch.setattr(pnp, "pnp_lo", lo)
    assert len(seen) == 10   # frames 2-11
    return seen[-1]


@pytest.mark.parametrize("n,live,prior", [
    *(pytest.param(*c, id="-".join(map(str, c))) for c in itertools.product(
        [37, 2000, 15360], [0.0, 0.5, 1.0], ["wins", "loses"])),
    pytest.param(15360, None, "sequence frame 11", id="15360-sequence-frame 11")])
def test_pnp_lo_kernel_matches_plain(dev, n, live, prior, monkeypatch):
    """K11 against the plain route (``pnp_lo_plain``: ``refine_pose``,
    ``pnp_dlt``'s Jacobi SVDs, cuBLAS products, ``solve_ex``) on the LO
    inputs ``ransac_pnp`` hands it on the card, both in float32, each
    measured against the plain route in float64: K11's rotation error
    may pass the plain f32 route's own by 1e-4 deg and its translation's
    relative error the plain route's by 5e-6.  The two sum in other
    orders (K11 by rows, then warps, then blocks; the plain route by
    cuBLAS and reduction kernels), so a converged step's cost, ~1e-7
    relative apart, may be kept by one and refused by the other, which
    moves the pose along the cost's flat valley; on these scenes and
    the sequence's frames (H100) K11 sits up to 2.8e-5 deg and 5.4e-7
    from float64, the plain f32 route up to 1.5e-5 deg and 8.6e-7, K11
    past the plain route by at most 1.7e-5 deg and 4.1e-7.  A row's
    residual moves by far less than the gap between the strict gate
    (3.5e-3) and the rows near it, so the strict counts and inlier
    masks are equal.  On the sequence's last registered frame's own
    inputs (frame 11: 3 frames x 5,120 slots), where a row may sit at
    the strict gate, the counts agree within a row or 0.1%.  One launch
    a call, and a call repeats bit for bit."""
    from sfm_tpu_torch.geometry import pnp
    from sfm_tpu_torch.ops import _cuda

    if prior == "sequence frame 11":
        args, kwargs, first = _sequence_lo_call(dev, monkeypatch)
        assert args[0].shape[0] == n
        _cuda.reset_launches()
    else:
        problem = pnp_problem(n + int(10 * live) + (prior == "wins"), n, live, prior == "wins")
        _cuda.reset_launches()
        args, kwargs, res = _lo_inputs(problem, dev, monkeypatch)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES["pnp_lo"] == 1
        _cuda.reset_launches()
        first = (res.R, None, res.inliers, res.num_inliers)
        if live > 0:   # the prior took the LO start where it was to win
            won = bool(torch.equal(args[3], torch.as_tensor(problem[2], device=dev)))
            assert won == (prior == "wins")
    x, Xn, mask, R0, t0 = args
    k = pnp.pnp_lo(*args, **kwargs)
    assert _cuda.LAUNCHES["pnp_lo"] == 1
    assert all(b is None or torch.equal(a, b) for a, b in zip(k, first))
    p = pnp.pnp_lo_plain(*args, **kwargs)
    p64 = pnp.pnp_lo_plain(x.double(), Xn.double(), mask, R0.double(), t0.double(), **kwargs)
    assert _cuda.LAUNCHES["pnp_lo"] == 1
    for a, b in zip(k, p):
        assert a.shape == b.shape and a.dtype == b.dtype and a.is_cuda
    assert int(k[3]) == int(k[2].sum())
    if prior == "sequence frame 11":
        assert abs(int(k[3]) - int(p[3])) <= max(1, int(p[3]) // 1000)
    else:
        assert int(k[3]) == int(p[3])
        assert torch.equal(k[2], p[2])
    host = lambda r: (r[0].cpu().numpy(), r[1].cpu().numpy())
    rot_k, _ = pose_errors_deg(*host(k), *host(p64))
    rot_p, _ = pose_errors_deg(*host(p), *host(p64))
    t_err = lambda r: float((r[1].double() - p64[1]).norm() / p64[1].norm())
    assert rot_k <= rot_p + 1e-4, (rot_k, rot_p)
    assert t_err(k) <= t_err(p) + 5e-6, (t_err(k), t_err(p))


def test_pnp_lo_kernel_checks_its_inputs(dev):
    """K11's wrapper refuses what the kernel does not take; float64 on
    the card takes the plain route, without a launch."""
    from sfm_tpu_torch.geometry import pnp
    from sfm_tpu_torch.ops import _cuda

    x, X, R_init, t_init, mask, _ = (torch.as_tensor(a, device=dev)
                                     for a in pnp_problem(0, 50, 0.8, False))
    kw = dict(threshold=1.2e-5)
    with pytest.raises(ValueError):
        pnp.pnp_lo(x[:, :2].contiguous(), X[:, :2].contiguous(), mask, R_init, t_init, **kw)
    with pytest.raises(ValueError):
        pnp.pnp_lo(x, X, mask.float(), R_init, t_init, **kw)
    with pytest.raises(ValueError):
        pnp.pnp_lo(x, X, mask, R_init.double(), t_init, **kw)
    _cuda.reset_launches()
    out = pnp.pnp_lo(x.double(), X.double(), mask, R_init.double(), t_init.double(), **kw)
    assert out[0].dtype == torch.float64 and _cuda.LAUNCHES["pnp_lo"] == 0
