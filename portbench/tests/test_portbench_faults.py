"""A whole run (rehearsed on the CPU: no look for a card) with the timed
path broken underneath comes out not correct: for each cell, an answer
altered where the port produces it.  (The cells have no batch whose
mean could drop half, no training state and no exchange between
chips.)"""

import json
import math
import time

import pytest
import torch

from portbench.harness import bench
ROOT = __import__("pathlib").Path(__file__).resolve().parents[2]


def _rot_deg(R, deg):
    a = math.radians(deg)
    Rz = torch.tensor([[math.cos(a), -math.sin(a), 0.0], [math.sin(a), math.cos(a), 0.0],
                       [0.0, 0.0, 1.0]], dtype=R.dtype, device=R.device)
    return Rz @ R


def _run(workload, capsys):
    rc = bench.main(["--workload", workload, "--seed", "5", "--seconds", "0.1",
                     "--trace", "0", "--rehearse"], ROOT, time.time())
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _pair_fault(monkeypatch):
    from sfm_tpu_torch.models import two_view

    real = two_view.two_view_geometry

    def broken(*a, **k):
        res = real(*a, **k)
        return res._replace(R=_rot_deg(res.R, 1.0))

    monkeypatch.setattr(two_view, "two_view_geometry", broken)


def _sift_fault(monkeypatch):
    from sfm_tpu_torch.sift import match

    real = match.match

    def broken(*a, **k):
        m = real(*a, **k)
        return m._replace(index=(m.index + 1) % a[1].shape[0])

    monkeypatch.setattr(match, "match", broken)


@pytest.mark.parametrize("workload,fault", [
    ("dino_720x576.pair", _pair_fault),
    ("cudasift_1280x960_up2.extract_match", _sift_fault),
])
def test_an_altered_answer_is_not_correct(workload, fault, monkeypatch, capsys):
    assert _run(workload, capsys)["correct"] is True
    fault(monkeypatch)
    assert _run(workload, capsys)["correct"] is False
