"""Stage timing (counterpart of ``sfm_tpu/utils/timing.py``).

PyTorch returns from a CUDA call before the card has finished, so a
host clock measures only the enqueue unless it waits for the device.
``sync`` waits with ``torch.cuda.synchronize`` on the devices of the
tensors it is given; ``StageTimer`` accumulates host-clock stage times
of synchronized work into a metrics dict; ``measure_rtt`` gives the
host's round trip to a device, which a chained timing of several
dispatches subtracts once.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def sync(x):
    """Wait until the devices holding the tensors of ``x`` (a tensor, or
    a tuple, list, NamedTuple or dict of them) have finished their work.
    CPU tensors need no wait.  Returns ``x``."""
    for dev in {t.device for t in _tensors(x) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return x


def measure_rtt(n: int = 5, device="cuda") -> float:
    """Round-trip latency to ``device`` in milliseconds: one warm-up,
    then the least over ``n`` round trips of a trivial dispatch and its
    read back to the host."""
    one = torch.ones((), device=device)
    float(one)
    rtt = float("inf")
    for i in range(n):
        t0 = time.perf_counter()
        float(one + i)
        rtt = min(rtt, (time.perf_counter() - t0) * 1e3)
    return rtt


class StageTimer:
    """Accumulating per-stage wall-clock timer."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    def record(self, name, seconds):
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self):
        return {
            name: {
                "total_ms": round(self.totals[name] * 1e3, 3),
                "count": self.counts[name],
                "mean_ms": round(self.totals[name] / max(self.counts[name], 1) * 1e3, 3),
            }
            for name in self.totals
        }
