"""CPU tests of the benchmark harness (``python -m pytest portbench/tests -q``).

They import neither jax nor the JAX package, and run the harness on the
CPU at the small sizes of its files' ``rehearse`` overrides."""

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
