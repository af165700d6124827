"""Nothing the benchmark runs imports the JAX package or JAX (top-level
names compared whole: ``sfm_tpu_torch`` is the port and passes,
``sfm_tpu`` does not), and the reference imports nothing of the port."""

import ast
import json
import os
import pathlib
import subprocess
import sys

from portbench.harness import device

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _sources(base):
    return [p for p in base.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts
            and not p.relative_to(BENCH).parts[0].startswith("_")]


def test_no_jax_in_the_harness():
    bad = {str(p): sorted(set(_imports(p)) & set(device.FORBIDDEN))
           for p in _sources(BENCH)}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_imports_nothing_of_the_port():
    files = _sources(BENCH / "reference")
    assert len(files) > 20
    bad = {str(p): sorted(set(_imports(p)) & {"sfm_tpu_torch", *device.FORBIDDEN})
           for p in files}
    assert not {k: v for k, v in bad.items() if v}


def test_forbidden_names_are_whole_top_level_names():
    mods = {"sfm_tpu_torch": 0, "sfm_tpu_torch.ops": 0, "jaxtyping": 0,
            "sfm_tpu.geometry": 0, "jaxlib.xla": 0, "flax": 0, "portbench": 0}
    assert device.forbidden_modules(mods) == ["flax", "jaxlib.xla", "sfm_tpu.geometry"]


def test_a_run_loads_no_jax():
    """A whole run (rehearsed on the CPU) ends with its own sys.modules
    check and prints a result; a reference run in the same process
    loads nothing forbidden either."""
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "dino_720x576.pair", "--seed",
         "3", "--seconds", "0.1", "--trace", "0", "--rehearse"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True


def test_no_card_no_result():
    """Without a card a run exits non-zero and prints nothing on stdout."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "dino_720x576.pair", "--seed",
         "3", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
