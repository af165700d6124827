"""One run of one cell: set-up, the measured window, the check of the
window's results against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, entry,
metric or cell's limits is a file under ``portbench/`` found by the
name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration (image size, SIFT and
  matcher settings), with its ``source``, ``assumed`` and ``reduced``;
- ``traffic/<traffic>.json``: the mix: the ``entry`` it drives, the
  loop, the pool of inputs and the request's parameters;
- ``entries/<entry>.py``: the code that drives the port for a request,
  its plain reference and the comparison of the two;
- ``metrics/<metric>.py``: ``read(run)``, a metric from the run's
  window, spans and profile (None where it finds nothing to read);
- ``limits/<workload>.json``: each compared number's limit, and the
  readings it was set from.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import pathlib
import random
import statistics
import sys
import time

import torch

from portbench.harness import device as devmod
from portbench.harness import draws, trace as tr
from portbench.harness.pipeline import sizes


def _load_module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: pathlib.Path):
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str, e2e_cells: dict) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return cell in e2e_cells.get(metric["moves"], ())
    return True


def load_cell(root: pathlib.Path, workload: str) -> dict:
    """The cell's entry of ``BENCHMARK.json`` with its configuration,
    traffic, limits and the metrics it reports."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    base = root / "portbench"
    names = list(cells)
    e2e_cells = {m["name"]: [n for n in names if _applies(m, n, {})]
                 for m in bench["end_to_end"]}
    return {
        "cell": cell,
        "config": _json(root / configs[cell["config"]]["file"]),
        "traffic": _json(base / "traffic" / f"{cell['traffic']}.json"),
        "limits": _json(base / "limits" / f"{workload}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if workload in e2e_cells[m["name"]]],
        "per_layer": [m for m in bench["per_layer"] if _applies(m, workload, e2e_cells)],
        "base": base,
    }


def load_entry(spec: dict, seed: int, dev):
    entry = spec["traffic"]["entry"]
    mod = _load_module(spec["base"] / "entries" / f"{entry}.py", f"portbench_entry_{entry}")
    return mod.Entry(spec["config"], spec["traffic"], seed, dev)


def read_metrics(spec: dict, kind: str, run: tr.Trace) -> dict:
    out = {}
    for m in spec[kind]:
        mod = _load_module(spec["base"] / "metrics" / f"{m['name']}.py",
                           "portbench_metric_" + m["name"].replace(".", "_"))
        value = mod.read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_window(entry, dev, seconds: float, spans, profile_requests: int, judged):
    """The closed loop: requests back to back from the first until
    ``seconds`` have passed and the judged requests (and in a traced
    run the profiled slice and as many requests after it) are done; the
    window ends when the last finishes.
    Returns (requests [(r, t0, t1)], window_s, outputs of ``judged``,
    work per request, profile or None, failed)."""
    requests, outputs, work, failed = [], {}, {}, 0
    prof = None
    need = max(max(judged, default=-1) + 1, 2 * profile_requests)
    start = time.perf_counter()
    r = 0
    while True:
        if spans is not None:
            spans.request = r
            if r == 0 and profile_requests:
                prof = tr.profiler(dev)
                prof.start()
                slice_range = torch.profiler.record_function(tr.SLICE)
                slice_range.__enter__()
        entry.prepare(r)
        t0 = time.perf_counter()
        try:
            out = entry.request(r, spans, keep=r in judged)
        except (RuntimeError, ValueError) as e:   # a failed request, not a failed run
            print(f"request {r} failed: {e!r}", file=sys.stderr)
            out = None
            failed += 1
        t1 = time.perf_counter()
        requests.append((r, t0, t1))
        if out is not None:
            work[r] = entry.work(out)
            if r in judged:
                outputs[r] = out
        r += 1
        if prof is not None and r == profile_requests:
            _sync(dev)
            slice_range.__exit__(None, None, None)
            prof.stop()
        if t1 - start >= seconds and r >= need:
            break
    window_s = requests[-1][2] - requests[0][1]
    profile = None
    if prof is not None:
        profile = tr.read_profile(prof, entry.span_names, min(r, profile_requests))
    return requests, window_s, outputs, work, profile, failed


def judge(entry, outputs: dict, limits: dict, control: bool = False):
    """The numbers compared, each the worst over the judged requests (the
    median for the entry's ``by_median`` numbers), against the cell's
    limits: (checks {name: {value, limit}}, correct)."""
    values: dict = {}
    for r, out in sorted(outputs.items()):
        ref = entry.reference(r)
        got = entry.reference(r, control=True) if control else out
        for name, v in entry.compare(got, ref).items():
            values.setdefault(name, []).append(math.inf if math.isnan(v) else float(v))
    by_median = getattr(entry, "by_median", ())
    worst = {n: statistics.median(v) if n in by_median else max(v) for n, v in values.items()}
    # Strict JSON has no infinity: a number with nothing to compare (no
    # judged request) reads the largest float.
    checks = {n: {"value": min(worst.get(n, math.inf), sys.float_info.max),
                  "limit": limits[n]["limit"]} for n in entry.compared}
    ok = bool(outputs) and all(c["value"] <= c["limit"] for c in checks.values())
    return checks, ok


def pick_judged(seed: int, traffic: dict) -> set:
    """Requests whose results the check compares, drawn from the seed
    among the first ``judge_from`` of the window."""
    rng = random.Random(draws.derive(seed, "judge"))
    return set(rng.sample(range(traffic["judge_from"]), traffic["judge_requests"]))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="the control flow on the CPU at the files' rehearsal sizes; "
                        "no device metric")
    return p.parse_args(argv)


def main(argv, root: pathlib.Path, started: float) -> int:
    args = parse(argv)
    started = devmod.process_start(started)
    spec = load_cell(root, args.workload)
    chips = spec["cell"]["chips"]
    if args.rehearse:
        dev = torch.device("cpu")
    else:
        try:
            dev = devmod.require_cards(chips)
        except devmod.NoCard as e:
            print(f"portbench: {e}", file=sys.stderr)
            return 2
        print(f"card: {devmod.card_line()}", file=sys.stderr)
    torch.set_num_threads(4)
    spec["config"], spec["traffic"] = sizes(spec["config"], spec["traffic"], args.rehearse)
    traffic = spec["traffic"]
    t_entry = time.time()
    entry = load_entry(spec, args.seed, dev)
    _sync(dev)
    t_inputs = time.time()
    entry.warm()
    _sync(dev)
    print(f"set-up: {t_entry - started:.3f} s to the entry, {t_inputs - t_entry:.3f} s "
          f"inputs, {time.time() - t_inputs:.3f} s kernels and warm requests",
          file=sys.stderr)
    judged = pick_judged(args.seed, traffic)
    spans = tr.Spans(dev) if args.trace else None
    profile_requests = traffic["profile_requests"] if args.trace and not args.rehearse else 0
    setup_s = time.time() - started
    requests, window_s, outputs, work, profile, failed = run_window(
        entry, dev, args.seconds, spans, profile_requests, judged)
    info = None if args.rehearse else devmod.describe(dev, chips)
    run = tr.Trace(spec["cell"], spec["config"], requests, window_s, entry.units_per_request,
                   spans.items if spans else [], profile, work, setup_s)
    if args.trace:
        metrics = read_metrics(spec, "per_layer", run)
    else:
        metrics = read_metrics(spec, "end_to_end", run)
    lat = sorted((t1 - t0) * 1e3 for _, t0, t1 in requests)
    print(f"window: {len(requests)} requests in {window_s:.3f} s; latency ms min "
          f"{lat[0]:.3f} median {lat[len(lat) // 2]:.3f} max {lat[-1]:.3f}; first "
          f"{[round((t1 - t0) * 1e3, 3) for _, t0, t1 in requests[:6]]}", file=sys.stderr)
    if profile is not None:
        info["busy_s"] = profile.busy_s()
        info["window_s"] = profile.wall_s
        print(f"profiled slice: {profile.requests} requests, {len(profile.ops)} device "
              f"operations, {profile.wall_s:.6f} s", file=sys.stderr)
    # The program's state goes before the reference runs on the card.
    entry.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if len(outputs) < len(judged):
        print(f"judged {sorted(outputs)} of {sorted(judged)}: the window finished "
              f"{len(requests)} requests, {failed} failed", file=sys.stderr)
    checks, correct = judge(entry, outputs, spec["limits"])
    correct = correct and failed == 0
    bad = devmod.forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 1
    result = {"correct": correct, "attempted": len(requests), "failed": failed,
              "metrics": {} if args.rehearse else metrics}
    if args.rehearse:   # which readers ran; a CPU run's numbers are not the card's
        result["read"] = sorted(metrics)
    if info is not None:
        result["device"] = info
    if profile is not None:
        result["breakdown"] = tr.breakdown(profile)
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
