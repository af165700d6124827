"""The card's renderer (``gen/scene.py``, torch) against the frozen numpy
copy (``gen/scene_np.py``) on the same draws, at a small size.

Tolerance: both compute in float64 and round to float32 at the end, so
they agree to float32 rounding of values in 0..255; 1e-3 of a grey
level leaves room for another FFT or libm and still catches any change
of the scene, texture or noise (each moves pixels by whole levels)."""

import numpy as np
import pytest

from portbench.gen import scene, scene_np

TOL = 1e-3


@pytest.mark.parametrize("name,size", [("synthetic_pair", (48, 64)),
                                       ("rotation_pair", (72, 96))])
def test_pairs_agree(name, size):
    a = getattr(scene_np, name)(*size, seed=5)
    b = getattr(scene, name)(*size, scene=scene.NumpyDraws(5), noise=scene.NumpyDraws(6),
                             device="cpu")
    for k in ("img1", "img2"):
        assert b[k].dtype == __import__("torch").float32
        assert np.abs(a[k] - b[k].numpy()).max() <= TOL
    for k in ("K", "R"):
        np.testing.assert_array_equal(a[k], b[k])


def test_seed_changes_the_scene():
    a = scene.synthetic_pair(48, 64, scene=scene.TorchDraws(1, "cpu"),
                             noise=scene.TorchDraws(2, "cpu"), device="cpu")
    b = scene.synthetic_pair(48, 64, scene=scene.TorchDraws(1, "cpu"),
                             noise=scene.TorchDraws(2, "cpu"), device="cpu")
    c = scene.synthetic_pair(48, 64, scene=scene.TorchDraws(3, "cpu"),
                             noise=scene.TorchDraws(2, "cpu"), device="cpu")
    assert (a["img1"] == b["img1"]).all()
    assert np.abs((a["img1"] - c["img1"]).numpy()).max() > 1.0
