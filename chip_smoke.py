#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (``sfm_tpu_torch``).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each of which fails the run on any error:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the hand-written kernels (``sfm_tpu_torch/csrc``)
   with nvcc for sm_90a and loads them;
3. kernels: each kernel against its plain PyTorch version on the same
   card tensors at the main path's shapes (K3 on the 5 octave bases of
   a 576 x 720 image, K4 on the 2,560 capped slots, K5 on their
   duplicate subset, K6 at 5,120 x 5,120 x 128), with CUDA-event times
   for both;
4. end to end: ``two_view_pipeline`` with the slice config (the bench
   config with ``pyramid_pallas=False``) on a 720 x 576 synthetic
   textured pair (``tests/synthetic_pair.py``) over 8 RANSAC seeds,
   gated against the JAX package's numbers on the same pair and the
   rendered ground-truth pose; the four kernels' launch counters must
   all be > 0 for that run;
5. the dino pair, with bench.py's quality gates, when ``SFM_DINO_DIR``
   names a directory holding ``viff.000.ppm`` and ``viff.001.ppm``
   (bench.py's fixture); skipped, and said so, when it is unset or the
   files are absent.

The last lines of standard output are the kernels' JSON record, the
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

ROOT = os.path.dirname(os.path.abspath(__file__))

# The JAX package on the same synthetic pair, slice config, 8 seeds,
# measured on CPU (XLA path): median matches 1869, inliers 1729, valid
# points 1729, reprojection 0.1418 px; worst seed 0.047 deg rotation and
# 0.284 deg translation-direction error (PERF.md).  The port must reach
# 90% of each median; the pose bounds hold per seed with margin.
JAX_MEDIANS = {"matches": 1869.0, "inliers": 1729.0, "valid": 1729.0,
               "px": 0.1418}
MAX_ROT_DEG = 0.5
MAX_TDIR_DEG = 2.0


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
    from sfm_tpu.config import PipelineConfig, RansacConfig, SiftConfig

    return PipelineConfig(
        sift=SiftConfig(max_pts_per_octave=1024, pyramid_pallas=False,
                        blur_matmul=False),
        ransac=RansacConfig(n_hyps=1536, threshold=3e-6, chunk=256),
        tvote_rounds=0,
    )


def check_kernels(pair, cfg, gates, dev):
    """Phase 3: every kernel against its plain version on the card."""
    import torch

    from sfm_tpu_torch.ops import compact, detect, match, sample
    from sfm_tpu_torch.sift import describe, frontend, pyramid

    records = []
    img1 = torch.as_tensor(pair["img1"], device=dev)
    img2 = torch.as_tensor(pair["img2"], device=dev)
    sc = cfg.sift

    # K3 on the 5 octave bases.
    bases = pyramid.base_chain(img1, sc)
    taps = [pyramid.octave_kernel_bank(sc, o) for o in range(sc.num_octaves)]
    mism, n_cand, err = 0, 0, 0.0
    for b, tp in zip(bases, taps):
        rk, ak = detect.detect_maps(b, tp, sc.thresh, sc.edge_limit)
        rp, ap = detect.detect_maps_plain(b, tp, sc.thresh, sc.edge_limit)
        ck, cp = rk > 0, rp > 0
        mism += int((ck != cp).sum())
        n_cand += int(cp.sum())
        both = ck & cp
        err = max(err, float((rk - rp)[both].abs().max()) if both.any() else 0.0,
                  float((ak - ap)[:, both].abs().max()) if both.any() else 0.0)
    torch.cuda.synchronize()
    log(f"K3 detect_maps: candidates {n_cand}, mismatched pixels {mism}, "
        f"max |err| on shared candidates {err:.3g} (tolerance: <= max(2, 0.1%) "
        "mismatches, 1e-4)")
    gates.check(n_cand > 1000, f"K3: only {n_cand} candidates")
    gates.check(mism <= max(2, 0.001 * n_cand), f"K3: {mism} mismatched pixels")
    gates.check(err <= 1e-4, f"K3: max err {err}")
    k_ms = cuda_ms(lambda: [detect.detect_maps(b, tp, sc.thresh, sc.edge_limit)
                            for b, tp in zip(bases, taps)])
    p_ms = cuda_ms(lambda: [detect.detect_maps_plain(b, tp, sc.thresh, sc.edge_limit)
                            for b, tp in zip(bases, taps)], reps=5)
    records.append({"name": "detect_maps", "route": "cuda",
                    "source": "sfm_tpu_torch/csrc/detect.cu",
                    "replaces": "sfm_tpu/ops/pallas_detect.py:259",
                    "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                    "shapes": "5 octave bases of 576x720 (one image)"})

    # K4 on the capped sample slots of the real detect stage.
    atlas, dets = frontend.detect_stage(img1, sc)
    x = torch.cat([d.x for d in dets])
    y = torch.cat([d.y for d in dets])
    s = torch.cat([d.scale for d in dets])
    v = torch.cat([d.valid for d in dets])
    sharp = torch.cat([d.sharpness for d in dets])
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
    err4 = float(row.max())
    dup_agree = float((dk == dp)[:n].float().mean())
    log(f"K4 fused_orient_descriptor: slots {x.shape[0]}, live {n}, rows within "
        f"1e-3 and 0.01 deg {frac:.5f}, dup agreement {dup_agree:.5f}, max |err| "
        f"{err4:.3g} (tolerance: >= 99.5% of rows, a peak near a tie may swap)")
    gates.check(x.shape[0] == sc.sample_cap, f"K4: {x.shape[0]} slots")
    gates.check(frac >= 0.995, f"K4: only {frac:.4f} of rows agree")
    gates.check(dup_agree >= 0.995, f"K4: dup agreement {dup_agree:.4f}")
    gates.check(not bool(d1k[n:].any()), "K4: rows >= count not zero")
    k_ms = cuda_ms(lambda: sample.fused_orient_descriptor(atlas, x, y, s, count))
    p_ms = cuda_ms(lambda: sample.fused_orient_descriptor_plain(atlas, x, y, s, count),
                   reps=5)
    records.append({"name": "fused_orient_descriptor", "route": "cuda",
                    "source": "sfm_tpu_torch/csrc/sample.cu",
                    "replaces": "sfm_tpu/ops/pallas_sample.py:788",
                    "max_abs_err": err4, "ms": k_ms, "plain_ms": p_ms,
                    "shapes": f"{x.shape[0]} slots, atlas {tuple(atlas.shape)}"})

    # K5 on the duplicate subset.
    v2 = dk & v
    od = compact.compaction_order(v2)
    xd, yd, sd, od2 = x[od], y[od], s[od], o2k[od]
    c2 = v2.sum().to(torch.int32)
    rk5 = sample.descriptor_sample(atlas, xd, yd, sd, od2, c2)
    rp5 = sample.descriptor_sample_plain(atlas, xd, yd, sd, od2, c2)
    n2 = int(c2)
    err5 = float((describe.normalize_descriptors(rk5)
                  - describe.normalize_descriptors(rp5)).abs().max())
    log(f"K5 descriptor_sample: duplicates {n2}, max |err| {err5:.3g} "
        "(tolerance 1e-3 on normalized descriptors)")
    gates.check(n2 > 0, "K5: no duplicates to sample")
    gates.check(err5 <= 1e-3, f"K5: max err {err5}")
    k_ms = cuda_ms(lambda: sample.descriptor_sample(atlas, xd, yd, sd, od2, c2))
    p_ms = cuda_ms(lambda: sample.descriptor_sample_plain(atlas, xd, yd, sd, od2, c2),
                   reps=5)
    records.append({"name": "descriptor_sample", "route": "cuda",
                    "source": "sfm_tpu_torch/csrc/sample.cu",
                    "replaces": "sfm_tpu/ops/pallas_sample.py:414",
                    "max_abs_err": err5, "ms": k_ms, "plain_ms": p_ms,
                    "shapes": f"{x.shape[0]} slots, {n2} live"})

    # K6 on the real descriptor sets of both images.
    s1 = frontend.extract_sift(img1, sc)
    s2 = frontend.extract_sift(img2, sc)
    a, b = s1.descriptors, s2.descriptors
    va = s2.keypoints.valid
    bk, sk, ik = match.match_top2(a, b, va)
    bp, sp, ip = match.match_top2_plain(a, b, va)
    live = s1.keypoints.valid
    agree = float((ik == ip)[live].float().mean())
    err6 = max(float((bk - bp).abs().max()), float((sk - sp).abs().max()))
    log(f"K6 match_top2: {a.shape[0]} x {b.shape[0]} x 128, argmax agreement "
        f"{agree:.5f} on {int(live.sum())} live rows, max |err| {err6:.3g} "
        "(tolerance: >= 99.9%, 1e-4)")
    gates.check(a.shape[0] == 2 * sc.sample_cap, f"K6: {a.shape[0]} rows")
    gates.check(agree >= 0.999, f"K6: argmax agreement {agree}")
    gates.check(err6 <= 1e-4, f"K6: max err {err6}")
    k_ms = cuda_ms(lambda: match.match_top2(a, b, va))
    p_ms = cuda_ms(lambda: match.match_top2_plain(a, b, va))
    records.append({"name": "match_top2", "route": "cuda",
                    "source": "sfm_tpu_torch/csrc/match.cu",
                    "replaces": "sfm_tpu/ops/pallas_match.py:247",
                    "max_abs_err": err6, "ms": k_ms, "plain_ms": p_ms,
                    "shapes": f"{a.shape[0]}x{b.shape[0]}x128 bf16"})
    return records


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
    """Phase 4: the port's main path on the synthetic pair."""
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
        gates.check(n > 0, f"kernel {name} was not launched on the main path")
    for r in rows:
        r.pop("R"), r.pop("t")
    return launches, med, rows


def dino(cfg, gates, dev):
    """Phase 5: bench.py's gates on the dino pair, where present."""
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
    from synthetic_pair import synthetic_pair

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
    records = check_kernels(pair, cfg, gates, dev)
    launches, med, rows = end_to_end(pair, cfg, gates, dev, card)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    dino_res = dino(cfg, gates, dev)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "kernels": records, "median": med,
                   "seeds": rows, "dino": dino_res,
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
