"""Octave bases, per-octave blur taps and the dense DoG pyramid
(counterpart of ``sfm_tpu/sift/pyramid.py``: ``octave_base_blurs``,
``octave_kernel_bank``, ``lowpass``, ``base_chain_pallas``, ``Octave``,
``build_octave`` and ``build_pyramid``).

The base chain always takes the JAX package's Pallas route: K7
``scale_up`` when ``up_scale``, then K1 (the ``init_blur`` prefilter)
and ``num_octaves - 1`` K2 descents, which the port computes in one
kernel launch per image (``sfm_tpu_torch/ops/pyramid.py:base_chain``).
``pyramid_pallas`` and ``blur_matmul`` are TPU dispatch knobs: CUDA
tensors always go through the kernels, CPU tensors through their plain
versions.  Octave o has shape ``[H_0 // 2**o, W_0 // 2**o]`` (floor at
every step), which is what ``frontend.atlas_layout`` assumes.

The dense route (``SiftConfig.fused_detect=False``) takes its octave
bases from the same chain, which computes the JAX package's XLA
``lowpass`` and ``scale_down`` descent, and builds each octave's
``[S+3]`` blur bank (``ops.image.blur_bank``) and its ``[S+2]`` DoG
volume in plain PyTorch.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.sfm.config import SiftConfig
from portbench.reference.sfm.ops import image as imops
from portbench.reference.sfm.ops import pyramid as pyr


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


@functools.lru_cache(maxsize=16)
def chain_taps(lowpass_radius: int, init_blur: float) -> tuple:
    """(prefilter taps with sigma = init_blur, the 5 descent taps) as
    tuples of f32 values, built once per configuration."""
    sigma = max(init_blur, 1e-3)
    return tuple(tuple(float(t) for t in imops.gaussian_kernel(r, var))
                 for r, var in ((lowpass_radius, sigma * sigma), (2, 0.5)))


def lowpass(img, cfg: SiftConfig):
    """Prefilter with sigma = init_blur (K1)."""
    return pyr.blur9(img, chain_taps(cfg.lowpass_radius, cfg.init_blur)[0])


def base_chain(img, cfg: SiftConfig) -> list:
    """Octave base images: [K7 2x upsample,] then the K1 prefilter and
    ``num_octaves - 1`` K2 blur + decimate steps in one launch."""
    if cfg.up_scale:
        img = pyr.scale_up(img)
    lp, sd = chain_taps(cfg.lowpass_radius, cfg.init_blur)
    return pyr.base_chain(img, lp, sd, cfg.num_octaves)


class Octave(NamedTuple):
    base: torch.Tensor   # [H, W] octave base image (for gradients)
    dog: torch.Tensor    # [S+2, H, W] difference-of-Gaussian planes
    subsampling: float   # coordinate scale back to input pixels


def build_octave(base, cfg: SiftConfig, octave_index: int,
                 subsampling: float) -> Octave:
    """The octave's [S+3] blur bank of ``base`` and its DoG volume
    ``bank[1:] - bank[:-1]``."""
    bank = imops.blur_bank(base, octave_kernel_bank(cfg, octave_index))
    return Octave(base=base, dog=bank[1:] - bank[:-1], subsampling=subsampling)


def build_pyramid(img, cfg: SiftConfig) -> list:
    """Every octave of ``img``, finest (subsampling 1) first: the base
    chain ([K7,] K1 + K2 in one launch), then each octave's blur bank
    and DoG.  The JAX package's banded-matrix argument is a TPU
    representation of the same blurs and has no counterpart.  Each DoG
    volume is [S+2, H_o, W_o] f32: the frontend builds and detects one
    octave at a time instead of holding them all."""
    bases = base_chain(img, cfg)
    return [build_octave(b, cfg, o, float(2 ** o)) for o, b in enumerate(bases)]
