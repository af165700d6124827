"""The scenes that the card's path gates were set on, pinned by SHA-256.

``chip_smoke.py``'s JAX reference numbers (``JAX_MEDIANS``,
``JAX_UPSCALE``, ``JAX_SEQUENCE``, ``JAX_RING`` ...) and
``tests/jax_cli_reference.py``'s inputs were computed on these scenes,
rendered by ``portbench/gen/scene_np.py`` through
``tests/synthetic_pair.py``, ``tests/synthetic_sequence.py`` and
``tests/synthetic_ring.py``.  A change to the renderer that moves a
pixel fails here, instead of silently moving the scenes under those
gates; such a change must re-derive them."""

import hashlib

import numpy as np
import pytest

from synthetic_pair import rotation_pair, synthetic_pair
from synthetic_ring import synthetic_ring
from synthetic_sequence import synthetic_sequence

# The gated seeds and sizes: the bench and CLI pair, the up-scale pair,
# the sequence phase's 12 frames, the ring phase's 36.
SCENES = {
    "synthetic_pair 576x720 seed 0": (
        lambda: synthetic_pair(576, 720, seed=0),
        "1f112ef34b28fcabed30d9d5249c759a75d54eee147ea3169d3a62a526e6fa8c"),
    "rotation_pair 960x1280 seed 0": (
        lambda: rotation_pair(960, 1280, seed=0),
        "abaa0137b00e2762a4ec7837ea90b4dc211f56dc816a7e20b6d6d73dce2630bc"),
    "synthetic_sequence 576x720 x12": (
        lambda: synthetic_sequence(576, 720, n_frames=12),
        "465c2c8299bfdf4ca0f35493a1d6be2cc506926daadd65f29a9329774e71609f"),
    "synthetic_ring 576x720 x36": (
        lambda: synthetic_ring(576, 720, n_frames=36),
        "a9e37b8309242ce58b060250e9c50f15db8624a0f163891815cc149eba1042b2"),
}


def digest(scene: dict) -> str:
    """SHA-256 over every array of the scene in key order: its name,
    dtype, shape and bytes."""
    h = hashlib.sha256()
    for k in sorted(scene):
        a = np.ascontiguousarray(scene[k])
        h.update(f"{k} {a.dtype} {a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", list(SCENES))
def test_gated_scenes_are_unchanged(name):
    render, want = SCENES[name]
    assert digest(render()) == want
