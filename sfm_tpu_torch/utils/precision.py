"""Full-f32 precision for the port's matmuls and convolutions.

Counterpart of ``sfm_tpu/utils/precision.py:f32_matmul``.  On the card
a float32 matmul already runs in full f32 by default, but a float32
convolution goes through cuDNN in TF32 (``torch.backends.cudnn.
allow_tf32`` defaults to True), which keeps about three decimal
digits.  The base-chain convolutions feed the DoG threshold, where
reduced precision created phantom detections in the JAX package, and
reduced-precision geometry corrupted its poses; so both flags are
pinned off around every entry point that computes either.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def f32_precision():
    """Pin TF32 off for matmuls and cuDNN convolutions inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
