#!/usr/bin/env python3
"""Where the PyTorch + CUDA port's time goes on one card, by the
program's own spans (``sfm_tpu_torch/utils/timing.py``).

Run from the repository root on a machine with an NVIDIA card:

    python3 profile_port.py [--pairs 5] [--tvote-rounds N]
    python3 profile_port.py --sequence [--mesh 1]
    python3 profile_port.py --ring
    python3 profile_port.py --cell <workload> --seed <n> [--seconds 51]
    python3 profile_port.py --watch TREE [TREE ...] [--first SEED] [--seeds 12]
        [--requests 12] [--rehearse]

Every mode profiles one run with ``torch.profiler`` and gives each
device operation and each idle gap to the innermost program span
holding its start (``portbench/harness/program_spans.py``); it prints
per span name the launches, device ms, host ms (inflated by the
profiler), idle ms and host syncs, the longest idle gaps, and the
device busy share (the union of the operations' intervals); ``by_stage``
in its JSON summary is {span: [launches, device ms]}, "other" outside
every span.

The pair mode drives ``two_view_pipeline`` with ``tests/path_configs.py``'s
``slice_config`` (bench.py's own config; ``--tvote-rounds`` sets its
translation re-vote rounds, 0 in the bench, 1 in the package default)
on the 720 x 576 synthetic pair (``tests/synthetic_pair.py``): first
the median host ms per pair of each span over ``--pairs`` pairs with
tracing on, then the profile; into
``chiprun_out/profile_port_tvote<N>.json``.

``--sequence`` drives ``run_incremental`` on ``chip_smoke.py``'s
sequence phase (the 12-frame 576 x 720 arc,
``tests/synthetic_sequence.py``, the CLI's defaults, closure (0, 11)):
per registered frame, the ms of each stage (extract, match, bootstrap,
register = PnP registration, local_ba, closure, global_ba, each
synchronized: ``timing.span(name, timer=...)``), then the profile, then
the ms per frame with ``torch.use_deterministic_algorithms(True)``;
a JSON summary goes to ``chiprun_out/profile_port_sequence.json``.
With ``--mesh N`` it runs the sequence without a mesh and on a mesh of
N ranks (``sfm_tpu_torch.parallel``; one process holds one rank, so N
is 1 unless launched by torchrun), in turns (without, with, with,
without) after a warm-up of each, then profiles one run of each by
stage, into ``chiprun_out/profile_port_sequence_mesh.json``.

``--ring`` drives the turntable driver (``python -m
sfm_tpu_torch.tools.reconstruct_dino --turntable``) on ``chip_smoke.py``'s
ring phase (36 frames of ``tests/synthetic_ring.py``): the ms per frame
of each stage (extract, the chain's stages, then tracks, pinned_lm,
free_ba, snap), twice; then ``reconstruct_turntable`` alone, profiled
on the captured chain and features; into
``chiprun_out/profile_port_ring.json``.

``--cell`` runs one traced run of a benchmark cell in this process
(``portbench/run.py --workload <cell> --seed <n> --trace 1``, its
result line on standard output) and profiles its slice by program span
as above, per request, with the share of the device operations in each
of the benchmark's own spans that fall inside a program span's child;
into ``profile_port_<cell>_<seed>.json`` beside the others.

``--watch TREE [TREE ...]`` is the pair cell's pose watch (ROADMAP
§1): the pose of ``dino_720x576.pair``, request by request, against its
float64 reference, for one or more checkouts (``.`` for this one).
For each of the seeds ``--first`` .. ``--first + --seeds - 1``,
requests 0 .. ``--requests - 1`` are what a benchmark run with that
seed sends first (``portbench/entries/two_view_pair.py``: its pool, its
order and each request's RANSAC draws; a run judges 7 of the first 10).
Each tree computes their poses in a process of its own (the package has
one name), after the cell's warm-up; then this process computes each
request's float64 reference once (``Entry.reference``) and measures
every tree's rotation and translation-direction angle to it
(``harness/compare.py``).  Prints, per tree, how many requests read
over 2e-3 deg in rotation and the largest angles, and writes every
angle to ``chiprun_out/pose_watch.json``; ``--rehearse`` runs the
control flow on the CPU at the files' rehearsal sizes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import statistics
import sys
import time

from chip_smoke import ROOT  # puts tests/ on the path
from path_configs import card_line, slice_config  # noqa: E402


def profiled(fn):
    """``fn()`` under ``torch.profiler`` inside the benchmark's slice
    range: (its result, wall ms, the slice's profile, its attribution to
    the program's spans)."""
    import torch

    from portbench.harness import program_spans, trace

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.SLICE):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    p = trace.read_profile(prof, (), 1)
    return out, wall, p, program_spans.attribute(p)


def report(label, wall, p, a, per=1, unit="") -> dict:
    """Print the profile by program span (``per`` runs) and return its
    summary."""
    from portbench.harness import program_spans

    rows = program_spans.table(a)
    busy = p.busy_s() * 1e3
    print(f"{label}: wall {wall:.1f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall:.1f}%), {len(p.ops)} device operations")
    for k, v in sorted(rows.items(), key=lambda kv: -kv[1]["launches"]):
        print(f"  {k or 'other':22s} {v['launches'] / per:9.1f} launches "
              f"{v['device_ms'] / per:8.3f} ms device {v['host_ms'] / per:9.2f} ms host "
              f"{v['idle_ms'] / per:8.2f} ms idle {v['host_syncs'] / per:6.1f} syncs{unit}")
    gaps = program_spans.longest_gaps(a)
    print("  longest idle gaps (ms): " + ", ".join(f"{n or 'other'} {ms:.3f}" for n, ms in gaps))
    tops = program_spans.top_ops(a)
    for k, ops in tops.items():
        print(f"  top in {k or 'other'}: " + "; ".join(f"{n[:70]} {ms / per:.3f}" for n, ms in ops))
    return {"profiled_wall_ms": wall, "device_busy_ms": busy, "kernel_launches": len(p.ops),
            "by_stage": {k or "other": [v["launches"], v["device_ms"]] for k, v in rows.items()},
            "spans": rows, "idle_gaps": gaps, "top_ops": tops}


def _dump(name, summary):
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, name), "w") as fh:
        json.dump(summary, fh, indent=1, default=float)


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
    """The multi-view path's stage times and profile (module docstring)."""
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
    _, prof_wall, p, a = profiled(lambda: run(StageTimer()))
    prof = report("profiled run", prof_wall, p, a, n, " per frame")

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
    _dump("profile_port_sequence.json", {
        "card": card, "frames": SEQ_FRAMES, "registered": n, "wall_ms": wall,
        "stage_ms_per_frame": per_frame, **prof,
        "deterministic": {"wall_ms": det_wall, "stage_ms_per_frame": det_per_frame,
                          "points": int(det_res.state.X_valid.sum())}})
    return 0


def sequence_mesh(card, n) -> int:
    """The sequence's stages without a mesh and on a mesh of ``n``
    ranks, in one process (module docstring)."""
    from chip_smoke import SEQ_CLOSURES, SEQ_FRAMES
    from sfm_tpu_torch.parallel import mesh as meshmod
    from sfm_tpu_torch.utils.timing import StageTimer

    run_seq = sequence_runner()
    out = {"card": card, "frames": SEQ_FRAMES, "closure": SEQ_CLOSURES}
    with meshmod.make_mesh(n) as mesh:
        meshes = {"without": None, f"mesh_{mesh.size}": mesh}
        names = list(meshes)
        for name in names:
            run_seq(None, meshes[name])              # warm-up
        for name in (names[0], names[1], names[1], names[0]):
            timer = StageTimer()
            res, wall = run_seq(timer, meshes[name])
            k = int(res.state.pose_valid.sum())
            per_frame = {s: v["total_ms"] / k for s, v in timer.summary().items()}
            out.setdefault(name, {"runs": []})["runs"].append(
                {"wall_ms": wall, "registered": k, "points": int(res.state.X_valid.sum()),
                 "stage_ms_per_frame": per_frame})
            print(f"card: {card}; {name}: wall {wall:.1f} ms = {wall / k:.2f} per frame, "
                  f"{k} registered, {int(res.state.X_valid.sum())} points; per frame: "
                  + ", ".join(f"{s} {v:.2f}" for s, v in per_frame.items()))
        for name in names:
            (res, _), prof_wall, p, a = profiled(
                lambda: run_seq(StageTimer(), meshes[name]))
            k = int(res.state.pose_valid.sum())
            prof = report(f"{name} profiled", prof_wall, p, a, k, " per frame")
            prof["wall_ms"] = prof.pop("profiled_wall_ms")
            out[name]["profiled"] = prof
    _dump("profile_port_sequence_mesh.json", out)
    return 0


def ring(card) -> int:
    """The turntable path's stage times and the turntable stages'
    profile (module docstring)."""
    import tempfile

    import numpy as np
    import torch

    from chip_smoke import RING_FRAMES, run_turntable_driver, spy
    from sfm_tpu_torch.models import turntable
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.sift import frontend
    from sfm_tpu_torch.utils import timing
    from sfm_tpu_torch.utils.timing import StageTimer
    from synthetic_ring import synthetic_ring

    _cuda.library()
    extract_sift = frontend.extract_sift
    runs = []
    with tempfile.TemporaryDirectory() as d:
        synthetic_ring(576, 720, n_frames=RING_FRAMES, directory=d)
        for _ in range(2):
            timer = StageTimer()

            def extract(*args, **kwargs):   # the driver extracts before the chain
                with timing.span("extract", timer=timer):
                    return extract_sift(*args, **kwargs)

            frontend.extract_sift = extract
            try:
                with spy(turntable, "reconstruct_turntable") as calls:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    rc, m, *_ = run_turntable_driver(d, os.path.join(d, "r"), timer=timer)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
            finally:
                frontend.extract_sift = extract_sift
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
    _, prof_wall, p, a = profiled(lambda: turntable.reconstruct_turntable(
        *args, **{**kwargs, "timer": StageTimer()}))
    prof = report("profiled reconstruct_turntable", prof_wall, p, a, RING_FRAMES,
                  " per frame")
    prof["turntable_profiled_wall_ms"] = prof.pop("profiled_wall_ms")
    _dump("profile_port_ring.json", {"card": card, "frames": RING_FRAMES, "runs": runs,
                                     **prof})
    return 0 if all(r["rc"] == 0 for r in runs) and np.isfinite(prof["device_busy_ms"]) else 1


def pair(card, n_pairs, tvote_rounds) -> int:
    """The two-view main path by program span (module docstring)."""
    import torch

    from sfm_tpu_torch.models import two_view
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.utils import timing
    from synthetic_pair import synthetic_pair

    cfg = dataclasses.replace(slice_config(), tvote_rounds=tvote_rounds)
    dev = torch.device("cuda", 0)
    p = synthetic_pair(576, 720, seed=0)
    img1, img2, K = (torch.as_tensor(p[k], device=dev) for k in ("img1", "img2", "K"))
    _cuda.library()

    def one_pair(seed):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return two_view.two_view_pipeline(img1, img2, K, gen, cfg)

    one_pair(0)
    timing.reset()
    timing.enable()
    walls = []
    for s in range(n_pairs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with timing.request(s):
            one_pair(s)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    timing.disable()
    per_pair: dict = {}
    for r in timing.records():
        ms = per_pair.setdefault(r.name, [0.0] * n_pairs)
        ms[r.request] += (r.t1_ns - r.t0_ns) * 1e-6
    med = {k: statistics.median(v) for k, v in per_pair.items()}
    print(f"card: {card}; tvote_rounds={cfg.tvote_rounds}")
    print(f"pair wall (ms, median of {n_pairs}): {statistics.median(walls):.2f}; host ms "
          "per pair in each span (not synchronized):")
    for k, v in med.items():
        print(f"  {k:22s} {v:9.2f}")
    timing.reset()
    _, wall, prof, a = profiled(lambda: one_pair(1))
    _dump(f"profile_port_tvote{cfg.tvote_rounds}.json", {
        "card": card, "tvote_rounds": cfg.tvote_rounds, "stage_ms": med,
        "pair_wall_ms": statistics.median(walls), **report("profiled pair", wall, prof, a)})
    return 0


def cell(card, workload, seed, seconds) -> int:
    """One traced run of a benchmark cell by program span (module
    docstring)."""
    from portbench.harness import bench, program_spans, trace

    slices, read = [], trace.read_profile
    trace.read_profile = lambda *a: slices.append(read(*a)) or slices[-1]
    rc = bench.main(["--workload", workload, "--seed", str(seed), "--seconds",
                     str(seconds), "--trace", "1"], pathlib.Path(ROOT), time.time())
    trace.read_profile = read
    if rc or not slices:
        return rc or 1
    p = slices[0]
    a = program_spans.attribute(p)
    print(f"card: {card}; {workload} seed {seed}: {p.requests} profiled requests",
          file=sys.stderr)
    sys.stdout, stdout = sys.stderr, sys.stdout      # the result line stays last
    try:
        out = report(f"profiled slice of {p.requests} requests (rows per request)",
                     p.wall_s * 1e3, p, a, p.requests)
        indices = {r.index for r, _, _ in a.records}
        held = [k >= 0 and a.records[k][0].parent in indices for k in a.op_span]
        cover = {}
        for name in sorted({o[3] for o in p.ops if o[3]}):
            mine = [h for o, h in zip(p.ops, held) if o[3] == name]
            cover[name] = sum(mine) / len(mine)
            print(f"  benchmark span {name}: {len(mine) / p.requests:.1f} device operations "
                  f"a request, {100 * cover[name]:.2f}% inside a program span's child")
        first = program_spans.first_calls()
        print("  first calls (s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(first.items(), key=lambda kv: -kv[1])))
    finally:
        sys.stdout = stdout
    _dump(f"profile_port_{workload}_{seed}.json", {
        "card": card, "workload": workload, "seed": seed, "requests": p.requests,
        "child_coverage": cover, "first_calls": first, **out})
    return 0


_WATCH = r'''
import json, pathlib, sys
import numpy as np, torch
sys.path.insert(0, str(pathlib.Path.cwd()))
from portbench.harness import bench
spec = bench.load_cell(pathlib.Path.cwd(), sys.argv[1])
dev = torch.device(sys.argv[2])
if dev.type == "cpu":   # the control flow at the files' rehearsal sizes
    from portbench.harness.pipeline import sizes
    spec["config"], spec["traffic"] = sizes(spec["config"], spec["traffic"], True)
out = {}
for seed in map(int, sys.argv[4].split(",")):
    entry = bench.load_entry(spec, seed, dev)
    entry.warm()
    for r in range(int(sys.argv[3])):
        entry.prepare(r)
        got = entry.request(r, None, keep=True)
        out[f"{seed}/{r}"] = {"R": np.asarray(got["R"]).tolist(), "t": np.asarray(got["t"]).tolist()}
    entry.release()
print(json.dumps(out))
'''


def watch(trees, first, n_seeds, n_requests, rehearse) -> int:
    """The pair cell's pose watch (module docstring)."""
    import subprocess

    import torch

    from portbench.harness import bench, compare as cmp, device as devmod
    from portbench.harness.pipeline import sizes

    cell_name, watch_deg = "dino_720x576.pair", 2e-3
    dev = torch.device("cpu") if rehearse else devmod.require_cards(1)
    seeds = [first + i for i in range(n_seeds)]
    poses = {}
    for tree in dict.fromkeys(trees):
        proc = subprocess.run(
            [sys.executable, "-c", _WATCH, cell_name, str(dev), str(n_requests),
             ",".join(map(str, seeds))], cwd=os.path.abspath(tree),
            capture_output=True, text=True, timeout=3000)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        poses[tree] = json.loads(proc.stdout.strip().splitlines()[-1])
    spec = bench.load_cell(pathlib.Path(ROOT), cell_name)
    spec["config"], spec["traffic"] = sizes(spec["config"], spec["traffic"], rehearse)
    gaps = {tree: {} for tree in poses}
    for seed in seeds:
        entry = bench.load_entry(spec, seed, dev)
        for r in range(n_requests):
            ref = entry.reference(r)
            for tree, got in poses.items():
                g = got[f"{seed}/{r}"]
                gaps[tree][f"{seed}/{r}"] = (cmp.rotation_gap_deg(g["R"], ref["R"]),
                                             cmp.direction_gap_deg(g["t"], ref["t"]))
    card = "cpu (rehearsal)" if rehearse else devmod.card_line()
    summary = {}
    for tree, g in gaps.items():
        rot = [v[0] for v in g.values()]
        over = sorted(k for k, v in g.items() if v[0] > watch_deg)
        summary[tree] = {"requests": len(rot), "over_2e-3_deg": len(over), "over": over,
                         "max_rot_deg": max(rot), "max_t_deg": max(v[1] for v in g.values())}
        print(json.dumps({"tree": tree, "card": card} | summary[tree]), flush=True)
    _dump("pose_watch.json", {"card": card, "seeds": seeds, "requests": n_requests,
                              "summary": summary, "gaps_deg": gaps})
    return 0


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--tvote-rounds", type=int, default=0)
    ap.add_argument("--sequence", action="store_true",
                    help="profile run_incremental on the 12-frame sequence")
    ap.add_argument("--ring", action="store_true",
                    help="profile the turntable driver on the 36-frame ring")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="with --sequence: also on a mesh of N ranks, in turns")
    ap.add_argument("--cell", metavar="WORKLOAD",
                    help="one traced run of a benchmark cell, by program span")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--watch", nargs="+", metavar="TREE",
                    help="the pair cell's pose against its float64 reference, per tree")
    ap.add_argument("--first", type=int, default=5600000001)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--rehearse", action="store_true",
                    help="with --watch: the control flow on the CPU at the rehearsal sizes")
    args = ap.parse_args()
    if args.watch:
        return watch(args.watch, args.first, args.seeds, args.requests, args.rehearse)
    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    if args.cell:
        return cell(card_line(), args.cell, args.seed, args.seconds)
    if args.sequence and args.mesh:
        return sequence_mesh(card_line(), args.mesh)
    if args.sequence:
        return sequence(card_line())
    if args.ring:
        return ring(card_line())
    return pair(card_line(), args.pairs, args.tvote_rounds)


if __name__ == "__main__":
    sys.exit(main())
