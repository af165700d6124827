#!/usr/bin/env python3
"""Stage times and a device profile of the PyTorch + CUDA port's
two-view main path on one card.

Run from the repository root on a machine with an NVIDIA card:

    python3 profile_port.py [--pairs 5] [--tvote-rounds N]

Drives ``sfm_tpu_torch`` with ``chip_smoke.py``'s ``slice_config``
(bench.py's own config; ``--tvote-rounds`` sets its translation re-vote
rounds, 0 in the bench, 1 in the package default) on the 720 x 576
synthetic pair
(``tests/synthetic_pair.py``) and prints, per stage (per-image detect,
which includes the K1/K2 base chain, and sample, match, geometry), the
median host-clock milliseconds around synchronized calls; then
profiles one pair with ``torch.profiler`` and prints the device busy
share, the number of kernel launches per stage and the top operators
by device time; a JSON summary goes to
``chiprun_out/profile_port_tvote<N>.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

from chip_smoke import ROOT, card_line, slice_config


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--tvote-rounds", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from sfm_tpu_torch.models import two_view
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.sift import frontend
    from synthetic_pair import synthetic_pair

    card = card_line()
    cfg = dataclasses.replace(slice_config(), tvote_rounds=args.tvote_rounds)
    dev = torch.device("cuda", 0)
    pair = synthetic_pair(576, 720, seed=0)
    img1, img2, K = (torch.as_tensor(pair[k], device=dev)
                     for k in ("img1", "img2", "K"))
    _cuda.library()
    sc = cfg.sift
    offsets, subs = frontend.atlas_layout(tuple(img1.shape), sc)

    def one_pair(seed, times=None):
        def stage(name, fn):
            with torch.profiler.record_function(name):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
            if times is not None:
                times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            return out

        sifts = []
        for img in (img1, img2):
            atlas, dets = stage("detect", lambda: frontend.detect_stage(img, sc))
            sifts.append(stage("sample", lambda: frontend.sample_stage(
                atlas, offsets, subs, dets, sc)))
        uv1, uv2, mask = stage("match", lambda: two_view.match_stage(*sifts, cfg))
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return stage("geometry", lambda: two_view.two_view_geometry(
            uv1, uv2, mask, K, cfg, generator=gen))

    one_pair(0)
    times = {}
    walls = []
    for s in range(args.pairs):
        t0 = time.perf_counter()
        one_pair(s, times)
        walls.append((time.perf_counter() - t0) * 1e3)
    med = {k: statistics.median(v) for k, v in times.items()}
    med["detect"] *= 2   # two images per pair
    med["sample"] *= 2
    print(f"card: {card}; tvote_rounds={cfg.tvote_rounds}")
    print(f"pair wall (ms, median of {args.pairs}, stages synchronized): "
          f"{statistics.median(walls):.2f}")
    for k, v in med.items():
        print(f"  {k:9s} {v:9.2f} ms/pair")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_pair(1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    stages = ("detect", "sample", "match", "geometry")
    events = prof.events()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if e.name in stages
             and e.device_type == torch.autograd.DeviceType.CPU]
    # Device kernels: CUDA-side events other than the stage annotations
    # mirrored onto the device timeline and the profiler's own buffers.
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in stages and "Buffer" not in e.name]
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    by_stage = {name: [0, 0.0] for name in stages}
    by_stage["other"] = [0, 0.0]
    for e in kern:
        # Each stage ends in a synchronize, so its kernels run inside it.
        name = next((n for n, a, b in spans
                     if a <= e.time_range.start <= b), "other")
        by_stage[name][0] += 1
        by_stage[name][1] += e.time_range.elapsed_us() / 1e3
    print(f"profiled pair: wall {wall_us / 1e3:.2f} ms, device busy "
          f"{busy_us / 1e3:.2f} ms ({100 * busy_us / wall_us:.1f}%), "
          f"{len(kern)} kernels")
    for k, (n, ms) in by_stage.items():
        print(f"  {k:9s} {n:6d} kernels  {ms:8.3f} ms device")
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=25)
    print(table)
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    name = f"profile_port_tvote{cfg.tvote_rounds}.json"
    with open(os.path.join(out, name), "w") as fh:
        json.dump({"card": card, "tvote_rounds": cfg.tvote_rounds, "stage_ms": med,
                   "pair_wall_ms": statistics.median(walls),
                   "profiled_wall_ms": wall_us / 1e3,
                   "device_busy_ms": busy_us / 1e3,
                   "kernel_launches": len(kern),
                   "by_stage": by_stage}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
