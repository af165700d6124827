"""Octave bases and per-octave blur taps (counterpart of
``sfm_tpu/sift/pyramid.py``: ``octave_base_blurs``,
``octave_kernel_bank``, ``lowpass`` and ``base_chain_pallas``).

The base chain always takes the JAX package's Pallas route: K7
``scale_up`` when ``up_scale``, K1 ``blur9`` (the ``init_blur``
prefilter), then K2 ``scale_down`` once per further octave
(``sfm_tpu_torch/ops/pyramid.py``).  ``pyramid_pallas`` and
``blur_matmul`` are TPU dispatch knobs: CUDA tensors always go through
the kernels, CPU tensors through their plain versions.  Octave o has
shape ``[H_0 // 2**o, W_0 // 2**o]`` (floor at every step), which is
what ``frontend.atlas_layout`` assumes.
"""

from __future__ import annotations

import math

import numpy as np

from sfm_tpu_torch.config import SiftConfig
from sfm_tpu_torch.ops import image as imops
from sfm_tpu_torch.ops import pyramid as pyr


def octave_base_blurs(num_octaves: int) -> list:
    """Accumulated base blur per octave: b_{k+1} = sqrt(b_k^2 + 0.25)/2."""
    blurs = [0.0]
    for _ in range(num_octaves - 1):
        b = blurs[-1]
        blurs.append(math.sqrt(b * b + 0.25) / 2.0)
    return blurs


def octave_kernel_bank(cfg: SiftConfig, octave_index: int) -> np.ndarray:
    """[S+3, 2r+1] blur taps for one octave (host-side constants)."""
    S = cfg.num_scales
    base_blur = octave_base_blurs(cfg.num_octaves)[octave_index]
    taps = []
    for i in range(S + 3):
        scale = 2.0 ** ((i - 1) / S)
        var = scale * scale - base_blur * base_blur
        taps.append(imops.gaussian_kernel(cfg.laplace_radius, max(var, 0.0)))
    return np.stack(taps)


def lowpass(img, cfg: SiftConfig):
    """Prefilter with sigma = init_blur (K1)."""
    sigma = max(cfg.init_blur, 1e-3)
    return pyr.blur9(img, imops.gaussian_kernel(cfg.lowpass_radius, sigma * sigma))


def base_chain(img, cfg: SiftConfig) -> list:
    """Octave base images: [K7 2x upsample,] K1 prefilter, then
    ``num_octaves - 1`` K2 blur + decimate steps."""
    if cfg.up_scale:
        img = pyr.scale_up(img)
    base = lowpass(img, cfg)
    bases = [base]
    sd = imops.gaussian_kernel(2, 0.5)
    for _ in range(cfg.num_octaves - 1):
        base = pyr.scale_down(base, sd)
        bases.append(base)
    return bases
