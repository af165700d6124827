"""sfm_tpu_torch — the PyTorch + CUDA port of sfm_tpu.

The package mirrors ``sfm_tpu``'s layout (``ops``, ``sift``,
``geometry``, ``models``, ``utils``) so each module's counterpart is
easy to find.  It imports ``torch`` and never ``jax``, and nothing of
the JAX package: it keeps its own copies of the configuration
dataclasses (``config.py``) and the numpy image I/O (``io/``).

Every Pallas kernel on the ported path has a hand-written CUDA kernel
for Hopper (``csrc/``) beside a plain PyTorch version of the same
function.  A wrapper runs the plain version for CPU tensors and the
CUDA kernel for CUDA tensors; it never falls back from one to the
other.
"""

__version__ = "0.1.0"
