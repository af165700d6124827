"""Octave bases and per-octave blur taps (counterpart of
``sfm_tpu/sift/pyramid.py``: ``octave_base_blurs``,
``octave_kernel_bank``, ``lowpass`` and the conv path of ``base_chain``).

The base chain stays plain PyTorch in this port, as the JAX package
leaves it to XLA when ``pyramid_pallas=False``; its Pallas kernels
(``blur9``, ``scale_down``) are not ported yet.
"""

from __future__ import annotations

import math

import numpy as np

from sfm_tpu.config import SiftConfig
from sfm_tpu_torch.ops import image as imops


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
    """Prefilter with sigma = init_blur."""
    sigma = max(cfg.init_blur, 1e-3)
    return imops.blur(img, imops.gaussian_kernel(cfg.lowpass_radius, sigma * sigma))


def base_chain(img, cfg: SiftConfig) -> list:
    """Octave base images: lowpass prefilter, then the scale-down descent."""
    if cfg.up_scale:
        raise NotImplementedError(
            "up_scale=True needs the 2x upsample kernel (scale_up), which is "
            "not ported yet")
    base = lowpass(img, cfg)
    bases = [base]
    for _ in range(cfg.num_octaves - 1):
        base = imops.scale_down(base, 0.5)
        bases.append(base)
    return bases
