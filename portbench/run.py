#!/usr/bin/env python3
"""Run one cell of the benchmark of ``sfm_tpu_torch`` (the PyTorch + CUDA
port) once, on the card of the machine it runs on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell is an entry of ``workloads``
in ``BENCHMARK.json``; its configuration, traffic mix, limits and
metric readers are files under ``portbench/`` found by name.  It
renders its inputs on the card from ``--seed``, warms up, runs a closed
loop of requests for ``--seconds``, checks a sample of the window's
results against the plain reference (``portbench/reference``) and
prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; the numbers compared come last there under ``checks``
and as the last lines of standard error.  Without a card (or with
fewer than the cell asks for) it exits 2 and prints no result.
``--rehearse`` runs the same control flow on the CPU at the small sizes
the configuration and traffic files give, and prints no device metric.
"""

import os
import pathlib
import sys
import time

STARTED = time.time()
ROOT = pathlib.Path(__file__).resolve().parent.parent

if __name__ == "__main__":
    # Build and kernel caches stay inside the checkout, at fixed paths.
    cache = ROOT / "portbench" / "_cache"
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    sys.path.insert(0, str(ROOT))
    from portbench.harness import bench

    sys.exit(bench.main(sys.argv[1:], ROOT, STARTED))
