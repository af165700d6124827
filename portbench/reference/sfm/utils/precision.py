"""Full-f32 precision for the reference's matmuls (frozen copy of
``sfm_tpu_torch/utils/precision.py``), and the benchmark's control.
"""

from __future__ import annotations

import contextlib
import functools

import torch


class _Mode:
    """The benchmark's control: the reference one precision below what
    the configuration states (TF32 for the f32 matmuls, fp8 for the
    bf16 products of the matcher, bf16 for the f32 octave bases)."""

    lower = False


@contextlib.contextmanager
def control():
    """Run the reference inside the block as the benchmark's control."""
    prev, _Mode.lower = _Mode.lower, True
    try:
        yield
    finally:
        _Mode.lower = prev


def lower_precision() -> bool:
    return _Mode.lower


@contextlib.contextmanager
def f32_precision():
    """Pin TF32 off for matmuls and cuDNN convolutions inside the block
    (on under :func:`control`)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = _Mode.lower
    torch.backends.cudnn.allow_tf32 = _Mode.lower
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def f32_matmul(fn):
    """Decorator: run ``fn`` with TF32 off (see :func:`f32_precision`)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with f32_precision():
            return fn(*args, **kwargs)

    return wrapped
