#!/usr/bin/env python3
"""The readings a cell's limits are set from (``portbench/limits``), for
many seeds in one process: per seed, the cell's inputs and the
requests a run with that seed would judge, compared as a run compares
them.

    python3 portbench/readings.py --workload <cell> --seeds <n> [<n> ...] [--control] [--rehearse]

Without ``--control``: the port computes the judged requests (the
lower readings).  With ``--control``: the control, the reference put
in the port's place one precision below what the configuration states
(the frozen frontend with TF32 for its f32 matmuls and bf16 for the f32
octave bases, the matcher's bf16 products in fp8 e4m3, the pair's
float64 geometry in float32 with TF32 operands); it has to come out as
not correct, and its readings set the upper ends.  The benchmark's runs
never run it.  Prints one JSON line per seed.
"""

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv) -> int:
    import argparse

    import torch

    from portbench.harness import bench, device as devmod
    from portbench.harness.pipeline import sizes

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)
    spec = bench.load_cell(ROOT, args.workload)
    if args.rehearse:
        dev = torch.device("cpu")
    else:
        try:
            dev = devmod.require_cards(spec["cell"]["chips"])
        except devmod.NoCard as e:
            print(f"readings: {e}", file=sys.stderr)
            return 2
        print(f"card: {devmod.card_line()}", file=sys.stderr)
    spec["config"], spec["traffic"] = sizes(spec["config"], spec["traffic"], args.rehearse)
    for seed in args.seeds:
        entry = bench.load_entry(spec, seed, dev)
        judged = bench.pick_judged(seed, spec["traffic"])
        outputs = dict.fromkeys(judged)
        if not args.control:
            entry.warm()
            for r in sorted(judged):
                entry.prepare(r)
                outputs[r] = entry.request(r, None, keep=True)
            entry.release()
        checks, correct = bench.judge(entry, outputs, spec["limits"], control=args.control)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": correct, "checks": checks}), flush=True)
        del entry
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main(sys.argv[1:]))
