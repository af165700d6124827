#!/usr/bin/env python3
"""The JAX package's command-line driver on the synthetic pair: the
reference numbers that ``chip_smoke.py``'s CLI phase gates the port's
``python -m sfm_tpu_torch reconstruct`` (and ``run_two_view`` at
``PipelineConfig()``) against.

Run from the repository root (on the CPU; JAX's CPU route):

    JAX_PLATFORMS=cpu python3 tests/jax_cli_reference.py [--seeds 8]

Writes ``synthetic_pair(576, 720, seed=0)`` as 8-bit PGMs
(``synthetic_pair.write_pgm``, the same files the CLI phase writes),
runs ``sfm_tpu.cli.main(["--platform", "cpu", "reconstruct", a, b,
"--focal", "792", "--seed", s, ...])`` in-process once per seed (the
CLI's defaults otherwise: 1024 points per octave, 1024 hypotheses,
threshold 3e-6, ``tvote_rounds=1``), and prints each seed's metrics,
its rotation and translation-direction errors against the rendered
pose, and the medians as one JSON line; then ``run_two_view`` at
``PipelineConfig()`` as it stands (seed 0) on the float pair, as one
JSON line.  ``--seeds 0`` runs only the latter.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

from synthetic_pair import pose_errors_deg, synthetic_pair, write_pgm  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args()
    from sfm_tpu import cli

    pair = synthetic_pair(576, 720, seed=0)
    rows = []
    with tempfile.TemporaryDirectory() as d:
        a, b = os.path.join(d, "a.pgm"), os.path.join(d, "b.pgm")
        write_pgm(a, pair["img1"])
        write_pgm(b, pair["img2"])
        for seed in range(args.seeds):
            js = os.path.join(d, f"m{seed}.json")
            cli.main(["--platform", "cpu", "reconstruct", a, b, "--focal", "792",
                      "--out", os.path.join(d, "c.ply"), "--metrics", js,
                      "--seed", str(seed)])
            with open(js) as fh:
                m = json.load(fh)
            rot, tdir = pose_errors_deg(np.array(m["R"]), np.array(m["t"]),
                                        pair["R"], pair["t"])
            rows.append({"seed": seed, "matches": m["num_matches"],
                         "inliers": m["num_inliers"], "valid": m["num_points"],
                         "px": m["mean_reproj_px"], "rot_deg": rot,
                         "tdir_deg": tdir})
            print(json.dumps(rows[-1]), flush=True)
    if rows:
        med = {k: statistics.median(r[k] for r in rows)
               for k in ("matches", "inliers", "valid", "px", "rot_deg", "tdir_deg")}
        med["worst_rot_deg"] = max(r["rot_deg"] for r in rows)
        med["worst_tdir_deg"] = max(r["tdir_deg"] for r in rows)
        print(json.dumps({"jax_cli_medians": med}))

    import jax.numpy as jnp

    from sfm_tpu.config import PipelineConfig
    from sfm_tpu.models import two_view

    r = two_view.run_two_view(*(jnp.asarray(pair[k]) for k in ("img1", "img2", "K")),
                              PipelineConfig(), seed=0)
    rot, tdir = pose_errors_deg(np.array(r.R), np.array(r.t), pair["R"], pair["t"])
    print(json.dumps({"jax_pipeline_config_default": {
        "matches": int(r.num_matches), "inliers": int(r.num_inliers),
        "valid": int(np.array(r.point_valid).sum()),
        "px": float(np.sqrt(float(r.reproj_err) / 2) * pair["K"][0, 0]),
        "rot_deg": rot, "tdir_deg": tdir}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
