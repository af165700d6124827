"""The main paths' configurations and the card's line, shared by the
card's harnesses (``chip_smoke.py``, ``kernel_ab.py``,
``profile_port.py``) and the port's tests: bench.py's configuration,
tools/bench_upscale.py's up_t2.0 and its H-fit, the turntable driver's, and the card's name and
power limit as ``nvidia-smi`` reads them.  Imports nothing of the port
at module level."""

from __future__ import annotations

import subprocess
from typing import NamedTuple


def slice_config():
    """bench.py's configuration (bench.py:75-79)."""
    from sfm_tpu_torch.config import PipelineConfig, RansacConfig, SiftConfig

    return PipelineConfig(
        sift=SiftConfig(max_pts_per_octave=1024),
        ransac=RansacConfig(n_hyps=1536, threshold=3e-6, chunk=256),
        tvote_rounds=0,
    )


def ring_config():
    """``sfm_tpu_torch/tools/reconstruct_dino.py``'s configuration at its
    defaults (``--pts-per-octave 512``)."""
    from sfm_tpu_torch.config import PipelineConfig, RansacConfig, SiftConfig

    return PipelineConfig(sift=SiftConfig(max_pts_per_octave=512),
                          ransac=RansacConfig(n_hyps=1024, threshold=3e-6, chunk=256))


def upscale_config():
    """tools/bench_upscale.py's up_t2.0 (``cfgf(2.0, True)``)."""
    from sfm_tpu_torch.config import SiftConfig

    per = 4096
    return SiftConfig(num_octaves=5, max_pts_per_octave=per,
                      octave_caps=(per, per, per // 2, per // 4, per // 8),
                      sample_cap=16384, thresh=2.0, init_blur=1.0, up_scale=True)


class HFit(NamedTuple):
    H: "torch.Tensor"        # [3, 3], H[2, 2] = 1
    uv1: "torch.Tensor"      # [N, 2] keypoints of image 1
    uv2: "torch.Tensor"      # [N, 2] their argmax matches in image 2
    cand: "torch.Tensor"     # [N] bool: the fit's candidates
    numfit: int


def h_fit(s1, s2, m, generator, n_hyps: int = 8192) -> HFit:
    """tools/bench_upscale.py:116-134 on the port's extractions and
    matches: candidates with ambiguity < 0.8, ``ransac_homography`` at
    25 (px^2) over ``n_hyps`` hypotheses, 5 ``improve_homography``
    loops at 9, and numfit, the valid argmax matches within 3 px."""
    import torch

    from sfm_tpu_torch.geometry import homography

    kp1, kp2 = s1.keypoints, s2.keypoints
    uv1 = torch.stack([kp1.x, kp1.y], dim=-1)
    uv2 = torch.stack([kp2.x[m.index], kp2.y[m.index]], dim=-1)
    slot_ok = kp1.valid & kp2.valid[m.index]
    cand = slot_ok & (m.ambiguity < 0.80) & (m.score > 0.0)
    hres = homography.ransac_homography(uv1, uv2, cand, generator=generator,
                                        n_hyps=n_hyps, threshold=25.0,
                                        refit_iters=0)
    H = homography.improve_homography(hres.H, uv1, uv2, cand, loops=5,
                                      threshold=9.0)
    errs = homography.transfer_errors(H, uv1, uv2)
    return HFit(H, uv1, uv2, cand, int(((errs < 9.0) & slot_ok).sum()))


def card_line() -> str:
    """The card's name and power limit, to write beside every number."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
