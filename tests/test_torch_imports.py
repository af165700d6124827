"""The port imports no jax, and rejects the knobs it does not implement."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sfm_tpu.config import PipelineConfig, SiftConfig
from sfm_tpu_torch.models import two_view
from sfm_tpu_torch.ops import _cuda
from sfm_tpu_torch.sift import frontend

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import sfm_tpu_torch
import sfm_tpu_torch.models.two_view
for m in pkgutil.walk_packages(sfm_tpu_torch.__path__, "sfm_tpu_torch."):
    importlib.import_module(m.name)
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m.startswith("jaxlib")]
shared = sorted(m for m in sys.modules if m.startswith("sfm_tpu."))
print(bad, shared)
assert not bad, bad
assert all(m == "sfm_tpu.config" or m.startswith("sfm_tpu.io") for m in shared), shared
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _ROOT
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=_ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("knob", [
    dict(select="approx"), dict(select="compact"),
    dict(sample_window=True), dict(sample_window="vmem"),
    dict(sample_phases=4),
])
def test_unsupported_sift_knobs_raise(knob):
    img = torch.zeros((64, 64))
    with pytest.raises(NotImplementedError):
        frontend.extract_sift(img, dataclasses.replace(SiftConfig(), **knob))


def test_tvote_rounds_raise():
    img = torch.zeros((64, 64))
    with pytest.raises(NotImplementedError):
        two_view.frontend_stage(img, img, PipelineConfig(tvote_rounds=1))


def test_kernel_argument_checks_reject_cpu_tensors():
    # A wrapper dispatches CPU tensors to the plain version; the checks
    # that guard the CUDA launch refuse anything else.
    with pytest.raises(ValueError):
        _cuda.require(torch.zeros(3), "x", torch.float32, (3,))
    assert set(_cuda.LAUNCHES) == {"blur9", "scale_down", "scale_up",
                                   "detect_maps", "fused_orient_descriptor",
                                   "descriptor_sample", "match_top2"}


def test_zero_images_give_no_matches_and_finite_pose():
    cfg = PipelineConfig(sift=SiftConfig(num_octaves=3, max_pts_per_octave=64),
                         tvote_rounds=0)
    img = torch.zeros((96, 128))
    K = torch.tensor(np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]],
                              np.float32))
    res = two_view.run_two_view(img, img, K, cfg, seed=0)
    assert int(res.num_matches) == 0
    assert torch.isfinite(res.R).all() and torch.isfinite(res.t).all()
    assert torch.isfinite(res.points).all()
