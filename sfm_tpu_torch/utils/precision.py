"""Full-f32 precision for the port's matmuls and convolutions.

Counterpart of ``sfm_tpu/utils/precision.py:f32_matmul``.  On the card
a float32 matmul runs in full f32 by default, but any process may turn
TF32 on (``torch.backends.cuda.matmul.allow_tf32`` or
``torch.set_float32_matmul_precision("high")``), and a float32
convolution goes through cuDNN in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True), which keeps about three
decimal digits.  Reduced-precision geometry corrupted the JAX
package's poses, so both flags are pinned off around every entry point
that computes matmuls.

What still needs the pin on the main path: the geometry stage's
matmuls and einsums (RANSAC banks, polish, refinement, triangulation)
and the homography fit.  The frontend no longer does: the base chain
(K1, K2, K7) and detection (K3) are explicit f32 multiply-adds in the
kernels and in their plain versions, and no convolution is left on
the path; the cuDNN flag stays pinned so that none can slip in at
TF32 later.
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
