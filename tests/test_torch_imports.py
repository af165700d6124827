"""The port and the card's harnesses (``chip_smoke.py``, ``kernel_ab.py``,
``profile_port.py``) import no jax and nothing of the JAX package (every
module walked, the XLA routes' modules among them), and the port
rejects the knobs it does not implement."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sfm_tpu_torch.config import PipelineConfig, SiftConfig
from sfm_tpu_torch.models import two_view
from sfm_tpu_torch.ops import _cuda
from sfm_tpu_torch.sift import frontend
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
bad = sorted(m for m in sys.modules if m in ("jax", "jaxlib", "sfm_tpu")
             or m.startswith(("jax.", "jaxlib.", "sfm_tpu.")))
print(bad)
assert not bad, bad
"""
_PROBE = """
import importlib, pkgutil, sys
import sfm_tpu_torch
import sfm_tpu_torch.models.two_view
for m in pkgutil.walk_packages(sfm_tpu_torch.__path__, "sfm_tpu_torch."):
    importlib.import_module(m.name)
walked = {"sfm_tpu_torch.models.tracks", "sfm_tpu_torch.models.turntable",
          "sfm_tpu_torch.models.calibrate", "sfm_tpu_torch.tools.reconstruct_dino",
          "sfm_tpu_torch.parallel.mesh", "sfm_tpu_torch.parallel.dist_match",
          "sfm_tpu_torch.parallel.dist_ba", "sfm_tpu_torch.ops.image",
          "sfm_tpu_torch.sift.pyramid", "sfm_tpu_torch.sift.detect",
          "sfm_tpu_torch.sift.orient", "sfm_tpu_torch.sift.match",
          "sfm_tpu_torch.ops.linalg", "sfm_tpu_torch.geometry.epipolar",
          "sfm_tpu_torch.geometry.camera", "sfm_tpu_torch.io.native",
          "sfm_tpu_torch.utils.timing"}
assert walked <= set(sys.modules), walked - set(sys.modules)
""" + _CHECK
# The card's harnesses imported as modules: main() does not run.
_PROBE_SMOKE, _PROBE_KERNEL_AB, _PROBE_PROFILE = ("import sys\nimport %s\n" % m + _CHECK
                                                  for m in ("chip_smoke", "kernel_ab",
                                                            "profile_port"))


@pytest.mark.parametrize("probe", [_PROBE, _PROBE_SMOKE, _PROBE_KERNEL_AB, _PROBE_PROFILE],
                         ids=["port", "chip_smoke", "kernel_ab", "profile_port"])
def test_port_imports_no_jax(probe):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _ROOT
    proc = subprocess.run([sys.executable, "-c", probe], cwd=_ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("knob", [dict(sample_phases=4)])
def test_unsupported_sift_knobs_raise(knob):
    img = torch.zeros((64, 64))
    with pytest.raises(NotImplementedError):
        frontend.extract_sift(img, dataclasses.replace(SiftConfig(), **knob))


def test_kernel_argument_checks_reject_cpu_tensors():
    # A wrapper dispatches CPU tensors to the plain version; the checks
    # that guard the CUDA launch refuse anything else.
    with pytest.raises(ValueError):
        _cuda.require(torch.zeros(3), "x", torch.float32, (3,))
    assert set(_cuda.LAUNCHES) == {"base_chain", "scale_up",
                                   "detect_maps", "fused_orient_descriptor",
                                   "descriptor_sample", "match_top2",
                                   "orientation_histogram_sample",
                                   "fused_orient_descriptor_win",
                                   "refine_relative_pose", "pnp_lo"}


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
