"""The harness takes data: a copy of the benchmark gains a configuration,
a traffic mix, a metric reader, a cell's limits and the cell's
``BENCHMARK.json`` entries, with no file that was there edited, and
runs the new cell (rehearsed on the CPU) with the new reader."""

import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _digests(base):
    return {str(p.relative_to(base)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((base / "portbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts and "_cache" not in p.parts}


def test_a_new_cell_from_files_alone(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "_work"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)
    pb = tmp_path / "portbench"
    (pb / "configs" / "small_pair.json").write_text(json.dumps({
        "name": "small_pair", "source": "a test's own sizes", "height": 144, "width": 176,
        "sift": {"num_octaves": 3, "max_pts_per_octave": 192}, "match": {},
        "assumed": [], "reduced": []}))
    (pb / "traffic" / "pair_few_hyps.json").write_text(json.dumps({
        "entry": "two_view_pair", "loop": "closed", "clients": 1, "pool": 1, "scene_seed": 2,
        "ransac": {"n_hyps": 128, "threshold": 3e-6}, "pipeline": {"tvote_rounds": 0},
        "warm_requests": 1, "judge_requests": 1, "judge_from": 1, "profile_requests": 1}))
    (pb / "metrics" / "inliers.small.py").write_text(
        '"""inliers.small: mean RANSAC inliers per pair of the window."""\n\n\n'
        "def read(run):\n"
        "    n = [w['inliers'] for w in run.work.values()]\n"
        "    return sum(n) / len(n) if n else None\n")
    (pb / "limits" / "small_pair.pair_few_hyps.json").write_text(json.dumps(
        {"corr_miss": {"limit": 0.0}, "rot_gap_deg": {"limit": 0.05},
         "t_gap_deg": {"limit": 0.5}, "inlier_flip": {"limit": 0.01},
         "point_gap": {"limit": 1e-4}}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "small_pair", "source": "a test",
                             "file": "portbench/configs/small_pair.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "small_pair.pair_few_hyps", "config": "small_pair",
                               "traffic": "pair_few_hyps", "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("small_pair.pair_few_hyps")
    bench["per_layer"].append({"name": "inliers.small", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "geometry",
                               "moves": "pair_ms", "workloads": ["small_pair.pair_few_hyps"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tmp_path)
    assert {k: v for k, v in before.items() if after.get(k) != v} == {}
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "small_pair.pair_few_hyps",
         "--seed", "8", "--seconds", "0.1", "--trace", "1", "--rehearse"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "inliers.small" in res["read"]
    assert res["correct"] is True
    assert set(res["checks"]) == {"corr_miss", "rot_gap_deg", "t_gap_deg", "inlier_flip",
                                  "point_gap"}


def test_without_the_port_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/ a run
    exits non-zero and prints no result."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "_work"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for extra in ([], ["--rehearse"]):
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", "dino_720x576.pair",
             "--seed", "8", "--seconds", "0.1", "--trace", "0", *extra],
            cwd=tmp_path, capture_output=True, text=True, timeout=600, env=env)
        assert out.returncode != 0
        assert out.stdout.strip() == ""
