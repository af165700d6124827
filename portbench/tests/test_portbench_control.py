"""The control of each cell's check (``portbench/readings.py --control``: the
reference one precision below the configuration's, in the port's
place) comes out as not correct against the cell's limits, here at the
rehearsal sizes on the CPU: the matcher's products in fp8 (the CPU has
no TF32 for the frontend's f32 matmuls) and the pair's geometry in
float32 with TF32 operands.  ``PERF.md`` gives its readings on the card
at the cells' own sizes."""

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("workload", ["dino_720x576.pair",
                                      "cudasift_1280x960_up2.extract_match"])
def test_control_is_not_correct(workload, capsys):
    sys.path.insert(0, str(ROOT / "portbench"))
    try:
        import readings
    finally:
        sys.path.pop(0)
    assert readings.main(["--workload", workload, "--seeds", "3", "--control",
                          "--rehearse"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["control"] is True
    assert res["correct"] is False
