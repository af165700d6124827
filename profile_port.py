#!/usr/bin/env python3
"""Stage times and a device profile of the PyTorch + CUDA port's
two-view main path, or of its multi-view path, on one card.

Run from the repository root on a machine with an NVIDIA card:

    python3 profile_port.py [--pairs 5] [--tvote-rounds N]
    python3 profile_port.py --sequence [--mesh 1]
    python3 profile_port.py --ring

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

``--sequence`` drives ``run_incremental`` instead, on
``chip_smoke.py``'s sequence phase (the 12-frame 576 x 720 arc,
``tests/synthetic_sequence.py``, the CLI's defaults, closure (0, 11)):
per registered frame, the host-clock ms of each stage (extract, match,
bootstrap, register = PnP registration, local_ba, closure, global_ba,
each ending in a synchronize), then one profiled run's kernel launches
and device ms per stage and per registered frame, and the same
run's ms per frame with ``torch.use_deterministic_algorithms(True)``;
a JSON summary goes to ``chiprun_out/profile_port_sequence.json``.
With ``--mesh N`` it runs the same sequence without a mesh and on a
mesh of N ranks (``sfm_tpu_torch.parallel``; one process holds one
rank, so N is 1 unless launched by torchrun), in turns (without, with,
with, without) after a warm-up of each, then profiles one run of each:
the ms, kernel launches and device ms per registered frame of each
stage, into ``chiprun_out/profile_port_sequence_mesh.json``.

``--ring`` drives the turntable driver (``python -m
sfm_tpu_torch.tools.reconstruct_dino --turntable``) on ``chip_smoke.py``'s
ring phase (36 frames of ``tests/synthetic_ring.py``): the host-clock
ms per frame of each stage (extract, the chain's stages, then tracks,
pinned_lm, free_ba, snap), twice; then ``reconstruct_turntable`` alone,
profiled on the captured chain and features: its kernel launches and
device ms per stage; a JSON summary goes to
``chiprun_out/profile_port_ring.json``.
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


def kernels_by_stage(prof, stages):
    """(device kernel events, {stage: [launches, device ms]}) of a
    profile whose stages are CPU-side ranges that end in a synchronize,
    so each stage's kernels run inside its range; kernels outside every
    range go to "other"."""
    import torch

    events = prof.events()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
             if e.name in stages
             and e.device_type == torch.autograd.DeviceType.CPU]
    # Device kernels: CUDA-side events other than the stage annotations
    # mirrored onto the device timeline and the profiler's own buffers.
    kern = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.name not in stages and "Buffer" not in e.name]
    by_stage = {name: [0, 0.0] for name in (*stages, "other")}
    for e in kern:
        name = next((n for n, a, b in spans
                     if a <= e.time_range.start <= b), "other")
        by_stage[name][0] += 1
        by_stage[name][1] += e.time_range.elapsed_us() / 1e3
    return kern, by_stage


SEQ_STAGES = ("extract", "match", "bootstrap", "register", "local_ba", "closure",
              "global_ba")


def sequence_runner():
    """run(timer, mesh=None) -> (result, wall ms): ``run_incremental`` on
    chip_smoke's sequence (12 frames of 576 x 720, the CLI's defaults,
    closure (0, 11)), synchronized before and after."""
    import torch

    from chip_smoke import SEQ_CLOSURES, SEQ_FRAMES
    from sfm_tpu_torch.config import PipelineConfig, RansacConfig, SiftConfig
    from sfm_tpu_torch.models import incremental
    from sfm_tpu_torch.ops import _cuda
    from synthetic_sequence import synthetic_sequence

    dev = torch.device("cuda", 0)
    seq = synthetic_sequence(576, 720, n_frames=SEQ_FRAMES)
    imgs = [torch.as_tensor(im, device=dev) for im in seq["images"]]
    cfg = PipelineConfig(sift=SiftConfig(max_pts_per_octave=1024),
                         ransac=RansacConfig(n_hyps=1024, threshold=3e-6))
    _cuda.library()

    def run(timer, mesh=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = incremental.run_incremental(imgs, seq["K"], cfg, seed=0, ba_iters=20,
                                          closure_pairs=SEQ_CLOSURES, timer=timer,
                                          mesh=mesh)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3
    return run


def sequence(card) -> int:
    """The multi-view path's stage times and device profile (module
    docstring)."""
    import torch

    from chip_smoke import SEQ_CLOSURES, SEQ_FRAMES
    from sfm_tpu_torch.utils.timing import StageTimer

    run = sequence_runner()
    run(None)                                       # warm-up
    timer = StageTimer()
    res, wall = run(timer)
    n = int(res.state.pose_valid.sum())
    per_frame = {k: v["total_ms"] / n for k, v in timer.summary().items()}
    print(f"card: {card}; {SEQ_FRAMES} frames, {n} registered, closure {SEQ_CLOSURES}")
    print(f"run wall (ms, stages synchronized): {wall:.1f} = {wall / n:.2f} per frame")
    for k, v in per_frame.items():
        print(f"  {k:10s} {v:9.2f} ms per registered frame")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, prof_wall = run(StageTimer())
    kern, by_stage = kernels_by_stage(prof, SEQ_STAGES)
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    print(f"profiled run: wall {prof_wall:.1f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / prof_wall:.1f}%), {len(kern)} kernels")
    for k, (cnt, ms) in by_stage.items():
        print(f"  {k:10s} {cnt:7d} kernels ({cnt / n:8.1f} per frame)  {ms:9.3f} ms "
              f"device ({ms / n:7.3f} per frame)")
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=20))

    # The same run with deterministic algorithms (index_add_ without float
    # atomics): ms per frame, and whether the result changes.
    torch.use_deterministic_algorithms(True)
    try:
        det_timer = StageTimer()
        det_res, det_wall = run(det_timer)
    finally:
        torch.use_deterministic_algorithms(False)
    det_per_frame = {k: v["total_ms"] / n for k, v in det_timer.summary().items()}
    print(f"deterministic algorithms: wall {det_wall:.1f} ms = {det_wall / n:.2f} per "
          f"frame (default {wall / n:.2f}); points {int(det_res.state.X_valid.sum())} "
          f"(default {int(res.state.X_valid.sum())})")
    for k, v in det_per_frame.items():
        print(f"  {k:10s} {v:9.2f} ms per registered frame (default {per_frame[k]:.2f})")
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "profile_port_sequence.json"), "w") as fh:
        json.dump({"card": card, "frames": SEQ_FRAMES, "registered": n,
                   "wall_ms": wall, "stage_ms_per_frame": per_frame,
                   "profiled_wall_ms": prof_wall, "device_busy_ms": busy,
                   "kernel_launches": len(kern), "by_stage": by_stage,
                   "deterministic": {"wall_ms": det_wall,
                                     "stage_ms_per_frame": det_per_frame,
                                     "points": int(det_res.state.X_valid.sum())}},
                  fh, indent=1)
    return 0


def sequence_mesh(card, n) -> int:
    """The sequence's stages without a mesh and on a mesh of ``n``
    ranks, in one process (module docstring)."""
    import torch

    from chip_smoke import SEQ_CLOSURES, SEQ_FRAMES
    from sfm_tpu_torch.parallel import mesh as meshmod
    from sfm_tpu_torch.utils.timing import StageTimer

    run_seq = sequence_runner()
    out = {"card": card, "frames": SEQ_FRAMES, "closure": SEQ_CLOSURES}
    with meshmod.make_mesh(n) as mesh:
        meshes = {"without": None, f"mesh_{mesh.size}": mesh}

        def run(name, timer):
            return run_seq(timer, meshes[name])

        names = list(meshes)
        for name in names:
            run(name, None)                          # warm-up
        for name in (names[0], names[1], names[1], names[0]):
            timer = StageTimer()
            res, wall = run(name, timer)
            k = int(res.state.pose_valid.sum())
            per_frame = {s: v["total_ms"] / k for s, v in timer.summary().items()}
            out.setdefault(name, {"runs": []})["runs"].append(
                {"wall_ms": wall, "registered": k, "points": int(res.state.X_valid.sum()),
                 "stage_ms_per_frame": per_frame})
            print(f"card: {card}; {name}: wall {wall:.1f} ms = {wall / k:.2f} per frame, "
                  f"{k} registered, {int(res.state.X_valid.sum())} points; per frame: "
                  + ", ".join(f"{s} {v:.2f}" for s, v in per_frame.items()))
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        for name in names:
            with torch.profiler.profile(activities=acts) as prof:
                res, prof_wall = run(name, StageTimer())
            kern, by_stage = kernels_by_stage(prof, SEQ_STAGES)
            k = int(res.state.pose_valid.sum())
            busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
            out[name]["profiled"] = {"wall_ms": prof_wall, "device_busy_ms": busy,
                                     "kernel_launches": len(kern), "by_stage": by_stage}
            print(f"{name} profiled: wall {prof_wall:.1f} ms, device busy {busy:.2f} ms, "
                  f"{len(kern)} kernels")
            for s, (cnt, ms) in by_stage.items():
                print(f"  {s:10s} {cnt / k:8.1f} kernels and {ms / k:7.3f} ms device "
                      f"per frame")
    path = os.path.join(ROOT, "chiprun_out")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "profile_port_sequence_mesh.json"), "w") as fh:
        json.dump(out, fh, indent=1, default=float)
    return 0


def ring(card) -> int:
    """The turntable path's stage times and the turntable stages' device
    profile (module docstring)."""
    import tempfile

    import numpy as np
    import torch

    from chip_smoke import RING_FRAMES, run_turntable_driver, spy
    from sfm_tpu_torch.models import turntable
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.utils.timing import StageTimer
    from synthetic_ring import synthetic_ring

    _cuda.library()
    runs = []
    with tempfile.TemporaryDirectory() as d:
        synthetic_ring(576, 720, n_frames=RING_FRAMES, directory=d)
        for _ in range(2):
            timer = StageTimer()
            with spy(turntable, "reconstruct_turntable") as calls:
                rc, m, _, _, _, wall = run_turntable_driver(d, os.path.join(d, "r"),
                                                            timer=timer)
            per_frame = {k: v["total_ms"] / RING_FRAMES
                         for k, v in timer.summary().items()}
            runs.append({"rc": rc, "wall_ms": wall, "stage_ms_per_frame": per_frame,
                         "step_deg_mean": m["tt_step_deg_mean"], "rms_px": m["tt_rms_px"]})
            print(f"card: {card}; ring run: rc {rc}, {wall:.0f} ms = "
                  f"{wall / RING_FRAMES:.1f} per frame, step {m['tt_step_deg_mean']:.4f} "
                  f"+- {m['tt_step_deg_std']:.4f} deg, {m['tt_rms_px']} px")
            for k, v in per_frame.items():
                print(f"  {k:10s} {v:9.2f} ms per frame")
    args, kwargs = calls[0][0], calls[0][1]
    stages = ("tracks", "pinned_lm", "free_ba", "snap")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        turntable.reconstruct_turntable(*args, **{**kwargs, "timer": StageTimer()})
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    kern, by_stage = kernels_by_stage(prof, stages)
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    print(f"profiled reconstruct_turntable: wall {prof_wall:.1f} ms, device busy "
          f"{busy:.2f} ms ({100 * busy / prof_wall:.1f}%), {len(kern)} kernels")
    for k, (cnt, ms) in by_stage.items():
        print(f"  {k:10s} {cnt:7d} kernels ({cnt / RING_FRAMES:8.1f} per frame)  "
              f"{ms:9.3f} ms device ({ms / RING_FRAMES:7.3f} per frame)")
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15))
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "profile_port_ring.json"), "w") as fh:
        json.dump({"card": card, "frames": RING_FRAMES, "runs": runs,
                   "turntable_profiled_wall_ms": prof_wall, "device_busy_ms": busy,
                   "kernel_launches": len(kern), "by_stage": by_stage},
                  fh, indent=1, default=float)
    return 0 if all(r["rc"] == 0 for r in runs) and np.isfinite(busy) else 1


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--tvote-rounds", type=int, default=0)
    ap.add_argument("--sequence", action="store_true",
                    help="profile run_incremental on the 12-frame sequence")
    ap.add_argument("--ring", action="store_true",
                    help="profile the turntable driver on the 36-frame ring")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="with --sequence: also on a mesh of N ranks, in turns")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    if args.sequence and args.mesh:
        return sequence_mesh(card_line(), args.mesh)
    if args.sequence:
        return sequence(card_line())
    if args.ring:
        return ring(card_line())
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
    kern, by_stage = kernels_by_stage(prof, ("detect", "sample", "match", "geometry"))
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
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
