#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (``sfm_tpu_torch``).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each of which fails the run on any error:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the hand-written kernels (``sfm_tpu_torch/csrc``)
   with nvcc for sm_90a and loads them;
3. kernels at the bench path's shapes: each kernel against its plain
   PyTorch version on the same card tensors (K1 on a 576 x 720 image,
   K2 on its 4 octave descents plus an odd 575 x 719 image, K3 on the 5
   octave bases, K4 on the 2,560 capped slots, K5 on their duplicate
   subset, K6 at 5,120 x 5,120 x 128), with CUDA-event times for both;
4. the bench path: ``two_view_pipeline`` with bench.py's own config
   (``slice_config``) on a 720 x 576 synthetic textured pair
   (``tests/synthetic_pair.py``) over 8 RANSAC seeds, gated against the
   JAX package's numbers on the same pair and the rendered ground-truth
   pose; every kernel but K7 must have launched in that run;
5. the up-scale path: tools/bench_upscale.py's up_t2.0 config
   (``upscale_config``: a 1280 x 960 input up-scaled to a 2560 x 1920
   base) on the rotation-only synthetic pair (``rotation_pair``):
   extraction of both images, matching, then bench_upscale's H-fit
   (``ransac_homography`` + ``improve_homography`` + the 3 px count),
   gated against the JAX package's features, candidates and H-fit on
   the same pair and against the pair's exact homography; all seven
   kernels must have launched in that run.  Then every kernel against
   its plain version on that run's inputs, at its shapes (K7 on the two
   960 x 1280 images, K1 on the 1920 x 2560 base, K2 on its 4
   descents, K3 on its 5 octave bases, K4 on the 11,776 capped slots
   of the 4,200 x 2,560 atlas, K5 on their duplicates, K6 on the run's
   own 23,552 x 23,552 x 128 descriptor sets), with the tolerances of
   phase 3;
6. the dino pair, with bench.py's quality gates, when ``SFM_DINO_DIR``
   names a directory holding ``viff.000.ppm`` and ``viff.001.ppm``
   (bench.py's fixture); skipped, and said so, when it is unset or the
   files are absent.

The last lines of standard output are the kernels' JSON record (each
kernel's ``launches`` summed over the runs of phases 4 and 5, its
``max_abs_err`` the largest of phases 3 and 5, its times phase 3's, or
phase 5's for K7), the
card's name and power limit, and ``{"ok": true, "device": {...}}``.
A detailed JSON report goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))

# The JAX package on the same synthetic pair, bench config, 8 seeds,
# measured on CPU (the CPU auto route, its XLA path): median matches
# 1869, inliers 1729, valid points 1729, reprojection 0.1418 px; worst
# seed 0.047 deg rotation and 0.284 deg translation-direction error
# (PERF.md).  The port must reach 90% of each median; the pose bounds
# hold per seed with margin.
JAX_MEDIANS = {"matches": 1869.0, "inliers": 1729.0, "valid": 1729.0,
               "px": 0.1418}
MAX_ROT_DEG = 0.5
MAX_TDIR_DEG = 2.0

# The JAX package on the same rotation pair (rotation_pair(960, 1280,
# seed=0)), up_t2.0 + MatchConfig(), bench_upscale's H-fit with
# PRNGKey(0), measured on CPU through the CPU auto route (use_pallas,
# fused_detect and pyramid_pallas resolve off: XLA conv pyramid, XLA
# sampling, chunked XLA matcher): features 10,444 / 10,935, ratio-test
# matches 4,705, 296 H-fit candidates (5 of them > 3 px off H_gt),
# H-fit 6,597, and H within a median 0.1183 px / max 0.3123 px of H_gt
# on the 16 x 12 grid (PERF.md).  Features, candidates and H-fit must
# reach 90%; the H error gates are 3x the JAX package's, rounded down.
JAX_UPSCALE = {"n1": 10444, "n2": 10935, "candidates": 296, "numfit": 6597}
MAX_H_MEDIAN_PX = 0.35
MAX_H_MAX_PX = 0.93


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Gates:
    def __init__(self):
        self.failures = []

    def check(self, cond, msg):
        if not cond:
            self.failures.append(msg)
            log(f"GATE FAIL: {msg}")


def slice_config():
    """bench.py's configuration (bench.py:75-79)."""
    from sfm_tpu.config import PipelineConfig, RansacConfig, SiftConfig

    return PipelineConfig(
        sift=SiftConfig(max_pts_per_octave=1024),
        ransac=RansacConfig(n_hyps=1536, threshold=3e-6, chunk=256),
        tvote_rounds=0,
    )


def upscale_config():
    """tools/bench_upscale.py's up_t2.0 (``cfgf(2.0, True)``)."""
    from sfm_tpu.config import SiftConfig

    per = 4096
    return SiftConfig(num_octaves=5, max_pts_per_octave=per,
                      octave_caps=(per, per, per // 2, per // 4, per // 8),
                      sample_cap=16384, thresh=2.0, init_blur=1.0, up_scale=True)


KERNEL_SOURCES = {
    "blur9": ("sfm_tpu_torch/csrc/pyramid.cu", "sfm_tpu/ops/pallas_pyramid.py:147"),
    "scale_down": ("sfm_tpu_torch/csrc/pyramid.cu", "sfm_tpu/ops/pallas_pyramid.py:272"),
    "scale_up": ("sfm_tpu_torch/csrc/pyramid.cu", "sfm_tpu/ops/pallas_pyramid.py:241"),
    "detect_maps": ("sfm_tpu_torch/csrc/detect.cu", "sfm_tpu/ops/pallas_detect.py:259"),
    "fused_orient_descriptor": ("sfm_tpu_torch/csrc/sample.cu",
                                "sfm_tpu/ops/pallas_sample.py:788"),
    "descriptor_sample": ("sfm_tpu_torch/csrc/sample.cu", "sfm_tpu/ops/pallas_sample.py:414"),
    "match_top2": ("sfm_tpu_torch/csrc/match.cu", "sfm_tpu/ops/pallas_match.py:247"),
}


def hold_kernels(img1, img2, sc, gates, where, s1=None, s2=None):
    """Every kernel of a main path against its plain version on the
    card, at the shapes that path gives it: K7 (with ``up_scale``), K1
    and K2 on img1's base chain, K3 on its octave bases, K4 on its
    capped sample slots, K5 on their duplicate subset, and K6 on the
    descriptor sets ``s1`` x ``s2`` (the path's own extractions of img1
    and img2; extracted here when not given).  Launches made here are
    not the path's: callers read the launch counts before.  Returns
    {kernel name: record} with max |err|, CUDA-event ms for kernel and
    plain version, and the shapes."""
    import torch

    from sfm_tpu_torch.ops import compact, detect, match, sample
    from sfm_tpu_torch.ops import pyramid as pyr
    from sfm_tpu_torch.ops.image import gaussian_kernel
    from sfm_tpu_torch.sift import describe, frontend, pyramid

    rec = {}

    def add(name, err, k_fn, p_fn, shapes, plain_reps=20):
        src, replaces = KERNEL_SOURCES[name]
        rec[name] = {"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "max_abs_err": err,
                     "ms": cuda_ms(k_fn), "plain_ms": cuda_ms(p_fn, reps=plain_reps),
                     "shapes": shapes}

    def err(a, b):
        return float((a - b).abs().max())

    # K7 -> K1 -> 4x K2: the base chain.
    base0 = img1
    if sc.up_scale:
        base0 = pyr.scale_up(img1)
        e7 = max(err(base0, pyr.scale_up_plain(img1)),
                 err(pyr.scale_up(img2), pyr.scale_up_plain(img2)))
        gates.check(tuple(base0.shape) == (2 * img1.shape[0], 2 * img1.shape[1]),
                    f"{where}: K7 shape {tuple(base0.shape)}")
        gates.check(e7 <= 1e-4, f"{where}: K7 max err {e7}")
        add("scale_up", e7, lambda: pyr.scale_up(img1), lambda: pyr.scale_up_plain(img1),
            f"{tuple(img1.shape)} -> {tuple(base0.shape)} f32, both images")
    sigma = max(sc.init_blur, 1e-3)
    lp = gaussian_kernel(sc.lowpass_radius, sigma * sigma)
    sd = gaussian_kernel(2, 0.5)
    chain = [pyr.blur9(base0, lp)]
    e1 = err(chain[0], pyr.blur9_plain(base0, lp))
    e2 = 0.0
    for _ in range(sc.num_octaves - 1):
        chain.append(pyr.scale_down(chain[-1], sd))
        e2 = max(e2, err(chain[-1], pyr.scale_down_plain(chain[-2], sd)))
    H, W = base0.shape
    shapes = [tuple(b.shape) for b in chain]
    gates.check(shapes == [(H >> o, W >> o) for o in range(sc.num_octaves)],
                f"{where}: K2 octave shapes {shapes}")
    gates.check(e1 <= 1e-4, f"{where}: K1 max err {e1}")
    gates.check(e2 <= 1e-4, f"{where}: K2 max err {e2}")

    def descend(fn):
        b = chain[0]
        for _ in range(sc.num_octaves - 1):
            b = fn(b, sd)
        return b

    add("blur9", e1, lambda: pyr.blur9(base0, lp), lambda: pyr.blur9_plain(base0, lp),
        f"{H}x{W} f32, {lp.size} taps")
    add("scale_down", e2, lambda: descend(pyr.scale_down),
        lambda: descend(pyr.scale_down_plain),
        f"the {sc.num_octaves - 1} descents {shapes} (one image)")

    # K3 on the octave bases.
    bases = pyramid.base_chain(img1, sc)
    taps = [pyramid.octave_kernel_bank(sc, o) for o in range(sc.num_octaves)]
    mism, n_cand, e3 = 0, 0, 0.0
    for b, tp in zip(bases, taps):
        rk, ak = detect.detect_maps(b, tp, sc.thresh, sc.edge_limit)
        rp, ap = detect.detect_maps_plain(b, tp, sc.thresh, sc.edge_limit)
        ck, cp = rk > 0, rp > 0
        mism += int((ck != cp).sum())
        n_cand += int(cp.sum())
        both = ck & cp
        if both.any():
            e3 = max(e3, float((rk - rp)[both].abs().max()),
                     float((ak - ap)[:, both].abs().max()))
    gates.check(n_cand > 1000, f"{where}: K3 only {n_cand} candidates")
    gates.check(mism <= max(2, 0.001 * n_cand), f"{where}: K3 {mism} mismatched pixels")
    gates.check(e3 <= 1e-4, f"{where}: K3 max err {e3}")
    add("detect_maps", e3,
        lambda: [detect.detect_maps(b, tp, sc.thresh, sc.edge_limit)
                 for b, tp in zip(bases, taps)],
        lambda: [detect.detect_maps_plain(b, tp, sc.thresh, sc.edge_limit)
                 for b, tp in zip(bases, taps)],
        f"{len(bases)} octave bases of {H}x{W} (one image)", plain_reps=5)

    # K4 on the capped sample slots of the path's detect stage.
    atlas, dets = frontend.detect_stage(img1, sc)
    x = torch.cat([d.x for d in dets])
    y = torch.cat([d.y for d in dets])
    s = torch.cat([d.scale for d in dets])
    v = torch.cat([d.valid for d in dets])
    sharp = torch.cat([d.sharpness for d in dets])
    n_slots = min(sc.sample_cap, x.shape[0]) if sc.sample_cap else x.shape[0]
    order = frontend._sample_order(v, sharp, sc.sample_cap)
    x, y, s, v = x[order], y[order], s[order], v[order]
    count = v.sum().to(torch.int32)
    d1k, o1k, o2k, dk = sample.fused_orient_descriptor(atlas, x, y, s, count)
    d1p, o1p, o2p, dp = sample.fused_orient_descriptor_plain(atlas, x, y, s, count)
    n = int(count)
    row = (describe.normalize_descriptors(d1k) - describe.normalize_descriptors(d1p)
           ).abs().amax(dim=1)[:n]
    ori = ((o1k - o1p + 180.0) % 360.0 - 180.0).abs()[:n]
    frac = float(((row <= 1e-3) & (ori <= 0.01)).float().mean())
    e4 = float(row.max())
    dup_agree = float((dk == dp)[:n].float().mean())
    gates.check(x.shape[0] == n_slots, f"{where}: K4 {x.shape[0]} slots, not {n_slots}")
    gates.check(frac >= 0.995, f"{where}: K4 only {frac:.4f} of rows agree")
    gates.check(dup_agree >= 0.995, f"{where}: K4 dup agreement {dup_agree:.4f}")
    gates.check(not bool(d1k[n:].any()), f"{where}: K4 rows >= count not zero")
    add("fused_orient_descriptor", e4,
        lambda: sample.fused_orient_descriptor(atlas, x, y, s, count),
        lambda: sample.fused_orient_descriptor_plain(atlas, x, y, s, count),
        f"{x.shape[0]} slots, {n} live, atlas {tuple(atlas.shape)}", plain_reps=5)

    # K5 on the duplicate subset.
    v2 = dk & v
    od = compact.compaction_order(v2)
    xd, yd, sd2, od2 = x[od], y[od], s[od], o2k[od]
    c2 = v2.sum().to(torch.int32)
    rk5 = sample.descriptor_sample(atlas, xd, yd, sd2, od2, c2)
    rp5 = sample.descriptor_sample_plain(atlas, xd, yd, sd2, od2, c2)
    n2 = int(c2)
    e5 = float((describe.normalize_descriptors(rk5)
                - describe.normalize_descriptors(rp5)).abs().max())
    gates.check(n2 > 0, f"{where}: K5 no duplicates to sample")
    gates.check(e5 <= 1e-3, f"{where}: K5 max err {e5}")
    add("descriptor_sample", e5,
        lambda: sample.descriptor_sample(atlas, xd, yd, sd2, od2, c2),
        lambda: sample.descriptor_sample_plain(atlas, xd, yd, sd2, od2, c2),
        f"{x.shape[0]} slots, {n2} live", plain_reps=5)

    # K6 on the path's descriptor sets of both images.
    if s1 is None:
        s1, s2 = frontend.extract_sift(img1, sc), frontend.extract_sift(img2, sc)
    a, b = s1.descriptors, s2.descriptors
    va = s2.keypoints.valid
    bk, sk, ik = match.match_top2(a, b, va)
    bp, sp, ip = match.match_top2_plain(a, b, va)
    live = s1.keypoints.valid
    agree = float((ik == ip)[live].float().mean())
    e6 = max(float((bk - bp).abs().max()), float((sk - sp).abs().max()))
    gates.check(a.shape[0] == 2 * n_slots, f"{where}: K6 {a.shape[0]} rows")
    gates.check(agree >= 0.999, f"{where}: K6 argmax agreement {agree}")
    gates.check(e6 <= 1e-4, f"{where}: K6 max err {e6}")
    add("match_top2", e6, lambda: match.match_top2(a, b, va),
        lambda: match.match_top2_plain(a, b, va),
        f"{a.shape[0]}x{b.shape[0]}x128 bf16, {int(live.sum())} live rows")
    torch.cuda.synchronize()
    e7_txt = f"K7 {rec['scale_up']['max_abs_err']:.3g}, " if sc.up_scale else ""
    log(f"{where}, kernels against their plain versions: {e7_txt}K1 {H}x{W} "
        f"{e1:.3g}; K2 {shapes} {e2:.3g} (expected 0, tolerance 1e-4); K3 "
        f"candidates {n_cand}, mismatched pixels {mism}, max |err| {e3:.3g} "
        f"(tolerance <= max(2, 0.1%), 1e-4); K4 slots {x.shape[0]}, live {n}, "
        f"rows within 1e-3 and 0.01 deg {frac:.5f}, dup agreement {dup_agree:.5f}, "
        f"max |err| {e4:.3g} (>= 99.5%); K5 duplicates {n2}, max |err| {e5:.3g} "
        f"(1e-3); K6 {a.shape[0]} x {b.shape[0]} x 128, argmax agreement "
        f"{agree:.5f}, max |err| {e6:.3g} (>= 99.9%, 1e-4)")
    return rec


def check_odd_scale_down(img, gates):
    """K2 on an odd-sized image: [H, W] -> [H//2, W//2], equal to its
    plain version."""
    from sfm_tpu_torch.ops import pyramid as pyr
    from sfm_tpu_torch.ops.image import gaussian_kernel

    sd = gaussian_kernel(2, 0.5)
    odd = img[:-1, :-1].contiguous()
    k = pyr.scale_down(odd, sd)
    e = float((k - pyr.scale_down_plain(odd, sd)).abs().max())
    log(f"K2 on odd {tuple(odd.shape)} -> {tuple(k.shape)}, max |err| {e:.3g}")
    gates.check(tuple(k.shape) == (odd.shape[0] // 2, odd.shape[1] // 2),
                f"K2: odd shape {tuple(k.shape)}")
    gates.check(e <= 1e-4, f"K2: odd max err {e}")
    return e


def run_pairs(img1, img2, K, cfg, f, seeds, dev):
    """Drive the main path once per seed; per-seed quality and ms."""
    import torch

    from sfm_tpu_torch.models import two_view

    rows = []
    for seed in seeds:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = two_view.two_view_pipeline(img1, img2, K, gen, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows.append({
            "seed": seed, "ms": ms, "matches": int(r.num_matches),
            "inliers": int(r.num_inliers), "valid": int(r.point_valid.sum()),
            "px": math.sqrt(max(float(r.reproj_err), 0.0) / 2.0) * f,
            "R": r.R.cpu().numpy(), "t": r.t.cpu().numpy(),
            "finite": bool(torch.isfinite(r.points).all()),
        })
    return rows


def median(rows, key):
    vals = sorted(r[key] for r in rows)
    m = len(vals) // 2
    return vals[m] if len(vals) % 2 else 0.5 * (vals[m - 1] + vals[m])


def end_to_end(pair, cfg, gates, dev, card):
    """Phase 4: the port's bench path on the synthetic pair."""
    import torch

    from sfm_tpu_torch.ops import _cuda
    from synthetic_pair import pose_errors_deg

    img1 = torch.as_tensor(pair["img1"], device=dev)
    img2 = torch.as_tensor(pair["img2"], device=dev)
    K = torch.as_tensor(pair["K"], device=dev)
    f = float(pair["K"][0, 0])
    run_pairs(img1, img2, K, cfg, f, [0], dev)          # warm-up
    _cuda.reset_launches()
    rows = run_pairs(img1, img2, K, cfg, f, range(8), dev)
    launches = dict(_cuda.LAUNCHES)
    for r in rows:
        r["rot_deg"], r["tdir_deg"] = pose_errors_deg(r["R"], r["t"], pair["R"],
                                                      pair["t"])
        log(f"seed {r['seed']}: matches {r['matches']} inliers {r['inliers']} "
            f"valid {r['valid']} px {r['px']:.4f} rot {r['rot_deg']:.4f} deg "
            f"tdir {r['tdir_deg']:.4f} deg  {r['ms']:.1f} ms")
        gates.check(r["finite"], f"seed {r['seed']}: non-finite points")
        gates.check(r["rot_deg"] <= MAX_ROT_DEG,
                    f"seed {r['seed']}: rotation error {r['rot_deg']:.3f} deg")
        gates.check(r["tdir_deg"] <= MAX_TDIR_DEG,
                    f"seed {r['seed']}: translation error {r['tdir_deg']:.3f} deg")
    med = {k: median(rows, k) for k in ("matches", "inliers", "valid", "px", "ms",
                                        "rot_deg", "tdir_deg")}
    log(f"median: matches {med['matches']:.0f} inliers {med['inliers']:.0f} "
        f"valid {med['valid']:.0f} px {med['px']:.4f} rot {med['rot_deg']:.4f} "
        f"deg tdir {med['tdir_deg']:.4f} deg")
    log(f"ms/pair: median {med['ms']:.2f} (host clock around a synchronized "
        f"pair, 720x576, {card})")
    log(f"launches in the 8-pair run: {launches}")
    for k in ("matches", "inliers", "valid"):
        gates.check(med[k] >= 0.9 * JAX_MEDIANS[k],
                    f"median {k} {med[k]} < 90% of the JAX package's {JAX_MEDIANS[k]}")
    gates.check(med["px"] <= JAX_MEDIANS["px"] / 0.9,
                f"median px {med['px']:.4f} > JAX {JAX_MEDIANS['px']} / 0.9")
    for name, n in launches.items():
        if name != "scale_up":   # K7 runs only on the up-scale path
            gates.check(n > 0, f"kernel {name} was not launched on the bench path")
    for r in rows:
        r.pop("R"), r.pop("t")
    return launches, med, rows


class HFit(NamedTuple):
    H: "torch.Tensor"        # [3, 3], H[2, 2] = 1
    uv1: "torch.Tensor"      # [N, 2] keypoints of image 1
    uv2: "torch.Tensor"      # [N, 2] their argmax matches in image 2
    cand: "torch.Tensor"     # [N] bool: the fit's candidates
    numfit: int


def h_fit(s1, s2, m, generator, n_hyps: int = 8192) -> HFit:
    """tools/bench_upscale.py:116-134 on the port's extractions and
    matches: candidates with ambiguity < 0.8, ``ransac_homography`` at
    25 (px^2) over ``n_hyps`` hypotheses, 5 ``improve_homography``
    loops at 9, and numfit, the valid argmax matches within 3 px."""
    import torch

    from sfm_tpu_torch.geometry import homography

    kp1, kp2 = s1.keypoints, s2.keypoints
    uv1 = torch.stack([kp1.x, kp1.y], dim=-1)
    uv2 = torch.stack([kp2.x[m.index], kp2.y[m.index]], dim=-1)
    slot_ok = kp1.valid & kp2.valid[m.index]
    cand = slot_ok & (m.ambiguity < 0.80) & (m.score > 0.0)
    hres = homography.ransac_homography(uv1, uv2, cand, generator=generator,
                                        n_hyps=n_hyps, threshold=25.0,
                                        refit_iters=0)
    H = homography.improve_homography(hres.H, uv1, uv2, cand, loops=5,
                                      threshold=9.0)
    errs = homography.transfer_errors(H, uv1, uv2)
    return HFit(H, uv1, uv2, cand, int(((errs < 9.0) & slot_ok).sum()))


def upscale_path(rpair, gates, dev, card):
    """Phase 5: up_t2.0 extraction -> matching -> H-fit on the rotation
    pair, then every kernel of that run against its plain version at
    the run's shapes.  Returns (result, kernel records)."""
    import numpy as np
    import torch

    from sfm_tpu.config import MatchConfig
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.sift import frontend
    from sfm_tpu_torch.sift import match as match_mod
    from synthetic_pair import homography_grid_errors, transfer_px

    cfg = upscale_config()
    img1 = torch.as_tensor(rpair["img1"], device=dev)
    img2 = torch.as_tensor(rpair["img2"], device=dev)
    frontend.extract_sift(img1, cfg)                     # warm-up
    times = []
    for _ in range(3):
        for img in (img1, img2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frontend.extract_sift(img, cfg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    _cuda.reset_launches()
    torch.cuda.synchronize()
    t = [time.perf_counter()]
    s1 = frontend.extract_sift(img1, cfg)
    s2 = frontend.extract_sift(img2, cfg)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    m = match_mod.match(s1.descriptors, s2.descriptors, s1.keypoints.valid,
                        s2.keypoints.valid, MatchConfig())
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    fit = h_fit(s1, s2, m, gen)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    launches = dict(_cuda.LAUNCHES)
    H, numfit = fit.H, fit.numfit
    cand = fit.cand.cpu().numpy()
    n_cand = int(cand.sum())
    # Candidates that the exact homography places > 3 px from their match.
    true_err = transfer_px(rpair["H_gt"], fit.uv1.cpu().numpy(), fit.uv2.cpu().numpy())
    n_wrong = int((cand & (true_err > 3.0)).sum())
    n_match = int(m.valid.sum())
    stage_ms = {k: (b - a) * 1e3 for k, a, b in
                zip(("extract_x2", "match", "h_fit"), t, t[1:])}
    n1, n2 = int(s1.keypoints.valid.sum()), int(s2.keypoints.valid.sum())
    h, w = rpair["img1"].shape
    grid = homography_grid_errors(H.cpu().numpy(), rpair["H_gt"], h, w)
    res = {"n1": n1, "n2": n2, "matches": n_match, "candidates": n_cand,
           "wrong_candidates": n_wrong, "numfit": numfit,
           "h_median_px": float(np.median(grid)), "h_max_px": float(grid.max()),
           "extract_ms_per_image": float(np.median(times)),
           "stage_ms": stage_ms, "launches": launches,
           "finite": bool(torch.isfinite(H).all())}
    log(f"up-scale {w}x{h} -> {2 * w}x{2 * h}: features {n1} / {n2}, ratio-test "
        f"matches {n_match}, H-fit candidates {n_cand} ({n_wrong} > 3 px off "
        f"H_gt), H-fit {numfit}; H vs H_gt on a 16x12 grid: median "
        f"{res['h_median_px']:.4f} px, max {res['h_max_px']:.4f} px")
    log(f"up-scale extraction: {res['extract_ms_per_image']:.2f} ms/image "
        f"(median of 6, host clock around a synchronized call, {card}); "
        f"in the counted run: extract x2 {stage_ms['extract_x2']:.1f} ms, "
        f"match {stage_ms['match']:.1f} ms, H-fit {stage_ms['h_fit']:.1f} ms")
    log(f"launches in the up-scale run: {launches}")
    gates.check(res["finite"], "up-scale: non-finite H")
    for k in ("n1", "n2", "candidates", "numfit"):
        gates.check(res[k] >= 0.9 * JAX_UPSCALE[k],
                    f"up-scale {k} {res[k]} < 90% of the JAX package's "
                    f"{JAX_UPSCALE[k]}")
    gates.check(res["h_median_px"] <= MAX_H_MEDIAN_PX,
                f"up-scale H median error {res['h_median_px']:.4f} px")
    gates.check(res["h_max_px"] <= MAX_H_MAX_PX,
                f"up-scale H max error {res['h_max_px']:.4f} px")
    for name, n in launches.items():
        gates.check(n > 0, f"kernel {name} was not launched on the up-scale path")
    # The counted run's inputs at its own shapes, after the counts were read.
    kernels = hold_kernels(img1, img2, cfg, gates, "up-scale path", s1, s2)
    return res, kernels


def dino(cfg, gates, dev):
    """Phase 6: bench.py's gates on the dino pair, where present."""
    import torch

    d = os.environ.get("SFM_DINO_DIR")
    if not d:
        log("dino phase skipped: SFM_DINO_DIR is not set")
        return None
    p1, p2 = (os.path.join(d, f"viff.00{i}.ppm") for i in (0, 1))
    if not (os.path.exists(p1) and os.path.exists(p2)):
        log(f"dino fixture absent in {d}: phase skipped")
        return None
    from sfm_tpu.io.image_io import load_gray

    img1 = torch.as_tensor(load_gray(p1), device=dev)
    img2 = torch.as_tensor(load_gray(p2), device=dev)
    h, w = img1.shape
    K = torch.tensor([[2360.0, 0, w / 2], [0, 2360.0, h / 2], [0, 0, 1]],
                     device=dev)
    rows = run_pairs(img1, img2, K, cfg, 2360.0, range(8), dev)
    med = {k: median(rows, k) for k in ("matches", "inliers", "valid", "px", "ms")}
    log(f"dino median: {med}")
    gates.check(med["matches"] >= 1100, f"dino median matches {med['matches']}")
    gates.check(med["inliers"] >= 950, f"dino median inliers {med['inliers']}")
    gates.check(med["valid"] >= 950, f"dino median valid {med['valid']}")
    gates.check(med["px"] <= 0.7, f"dino median px {med['px']}")
    for r in rows:
        gates.check(r["valid"] >= 900, f"dino seed {r['seed']} valid {r['valid']}")
        gates.check(r["px"] <= 0.75, f"dino seed {r['seed']} px {r['px']}")
        r.pop("R"), r.pop("t")
    return {"median": med, "seeds": rows}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from sfm_tpu_torch.ops import _cuda
    from synthetic_pair import rotation_pair, synthetic_pair

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {card}")

    t0 = time.perf_counter()
    lib = _cuda.library()
    log(f"build: {lib.path.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())

    gates = Gates()
    cfg = slice_config()
    pair = synthetic_pair(576, 720, seed=0)
    t0 = time.perf_counter()
    rpair = rotation_pair(960, 1280, seed=0)
    log(f"rotation pair rendered in {time.perf_counter() - t0:.1f} s")
    img1 = torch.as_tensor(pair["img1"], device=dev)
    held = {"bench": hold_kernels(img1, torch.as_tensor(pair["img2"], device=dev),
                                  cfg.sift, gates, "bench path")}
    check_odd_scale_down(img1, gates)
    launches, med, rows = end_to_end(pair, cfg, gates, dev, card)
    up, held["upscale"] = upscale_path(rpair, gates, dev, card)
    # One record per kernel: the largest error over both paths' shapes;
    # times at the bench path's shapes (K7's at the up-scale path's).
    records = []
    for name in KERNEL_SOURCES:
        at = {p: h[name] for p, h in held.items() if name in h}
        rec = dict(at.get("bench", at["upscale"]))
        rec["max_abs_err"] = max(r["max_abs_err"] for r in at.values())
        rec["held_at"] = at
        rec["launches_by_path"] = {"bench": launches[name],
                                   "upscale": up["launches"][name]}
        rec["launches"] = sum(rec["launches_by_path"].values())
        records.append(rec)
    dino_res = dino(cfg, gates, dev)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "kernels": records, "median": med,
                   "seeds": rows, "upscale": up, "dino": dino_res,
                   "gate_failures": gates.failures}, fh, indent=1, default=float)
    if gates.failures:
        log(f"{len(gates.failures)} gate(s) failed")
        return 1
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms")} for r in records]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
