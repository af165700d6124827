"""The sequence cell's renderer on the card (``portbench/gen/sequence.py``,
torch) against its frozen numpy copy (``portbench/gen/sequence_np.py``)
and the repository's arc sequence (``tests/synthetic_sequence.py``), on
the same draws, at a small size on the CPU.

Tolerance: the numpy copy is the tests' renderer frozen, so the two
agree exactly; the torch renderer computes in float64 and rounds to
float32 at the end, as ``portbench/tests/test_portbench_gen.py`` holds
the pair's, so 1e-3 of a grey level leaves room for another FFT or libm
and still catches any change of the scene, the poses or the noise
(each moves pixels by whole levels)."""

import numpy as np
import torch

from portbench.gen import scene, sequence, sequence_np
from synthetic_sequence import STEP_DEG, synthetic_sequence

TOL = 1e-3


def test_the_three_renderers_agree():
    tests = synthetic_sequence(48, 64, n_frames=3, seed=5)
    frozen = sequence_np.synthetic_sequence(48, 64, 3, STEP_DEG, seed=5)
    card = sequence.synthetic_sequence(48, 64, 3, STEP_DEG, scene=scene.NumpyDraws(5),
                                       noise=scene.NumpyDraws(6), device="cpu")
    np.testing.assert_array_equal(frozen["images"], tests["images"])
    assert card["images"].dtype == torch.float32
    assert np.abs(card["images"].numpy() - tests["images"]).max() <= TOL
    for k in ("K", "R", "t"):
        np.testing.assert_array_equal(frozen[k], tests[k])
        np.testing.assert_array_equal(card[k], tests[k])
