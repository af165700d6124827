"""Stage timing (counterpart of ``sfm_tpu/utils/timing.py``) and the
program's own spans and counters.

PyTorch returns from a CUDA call before the card has finished, so a
host clock measures only the enqueue unless it waits for the device.
``sync`` waits with ``torch.cuda.synchronize`` on the devices of the
tensors it is given; ``StageTimer`` accumulates host-clock stage times
of synchronized work into a metrics dict; ``measure_rtt`` gives the
host's round trip to a device, which a chained timing of several
dispatches subtracts once.

:func:`span` marks a stage of the program (``two_view.geometry``,
``geometry.bank``, ``sift.select``, ...).  Tracing is off unless
:func:`enable` was called or a ``torch.profiler`` is recording; off, a
span is one shared null context and costs a flag check, a profiler
check and a set lookup: it never synchronizes, allocates or enters a
profiler range.  On, it opens a profiler range of its name (the C++
form of ``torch.profiler.record_function``, which opens and closes
within microseconds of the clock readings) and keeps a :class:`Record`
in a bounded ring: its
enclosing span, its request, its interval on ``time.time_ns()`` (the
profiler's own clock) and the deltas of the counters over it:

- ``host_syncs``: blocking device-to-host synchronizations, counted
  through ``torch.cuda.set_sync_debug_mode("warn")`` while an outermost
  span is open on a CUDA process, plus the program's own
  :func:`sync` calls and ``timer=`` spans (syncs inside libraries such
  as MAGMA or cuSOLVER are not seen);
- ``kernel_launches``: the hand-written kernels' launches, counted
  where ``ops/_cuda.launched`` adds them to ``ops/_cuda.LAUNCHES``.

The first call of each span name in the process is recorded whatever
the state, with its host seconds (:func:`first_calls`): that is where
a process's cold start sits.  A span given a ``StageTimer`` also
synchronizes on entry and exit and records its time there, for the
CLI's ``stage_times``.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from collections import defaultdict, deque
from typing import NamedTuple

import torch

RING = 16384                  # records kept; the oldest go first
_SYNC_WARNING = "called a synchronizing CUDA operation"


class Record(NamedTuple):
    """One closed span.  ``index`` numbers the spans in the order they
    opened; ``parent`` is the enclosing span's index (-1: outermost)."""

    index: int
    name: str
    parent: int
    request: int
    t0_ns: int
    t1_ns: int
    host_syncs: int
    kernel_launches: int


class _State:
    def __init__(self):
        self.ring = deque(maxlen=RING)
        self.first: dict = {}
        self.open: list = []          # the open traced spans, innermost last
        self.next_index = 0
        self.next_request = 0
        self.pinned = None            # the request of timing.request(r)
        self.host_syncs = 0
        self.kernel_launches = 0


_S = _State()
_on = False                   # the flag the off path checks
_seen: set = set()            # the names called so far (the cold check)
_NULL = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast


def enable():
    """Trace every span from now on."""
    global _on
    _on = True


def disable():
    """Trace spans only while a ``torch.profiler`` records."""
    global _on
    _on = False


def reset():
    """Forget the records and the first calls: the next call of each
    name is cold again."""
    _S.ring.clear()
    _seen.clear()
    _S.first.clear()
    _S.next_index = 0
    _S.next_request = 0


def records() -> list:
    """The ring's :class:`Record` s, in the order the spans closed."""
    return list(_S.ring)


def first_calls() -> dict:
    """Span name -> host seconds of its first call in the process."""
    return dict(_S.first)


@contextlib.contextmanager
def request(r: int):
    """Outermost spans opened inside take request id ``r``."""
    prev, _S.pinned = _S.pinned, r
    try:
        yield
    finally:
        _S.pinned = prev


def count_launch():
    """Count one launch of a hand-written kernel (``ops/_cuda.launched``)."""
    _S.kernel_launches += 1


def _counters() -> tuple:
    """(host_syncs, kernel_launches) so far."""
    return _S.host_syncs, _S.kernel_launches


def _synchronize():
    if torch.cuda.is_initialized():
        _S.host_syncs += 1
        torch.cuda.synchronize()


class _SyncCount:
    """``set_sync_debug_mode("warn")`` with its warnings counted (every
    occurrence) instead of shown, undone on exit."""

    def __enter__(self):
        self.mode = torch.cuda.get_sync_debug_mode()
        self.warnings = warnings.catch_warnings()
        self.warnings.__enter__()
        warnings.filterwarnings("always", message=_SYNC_WARNING)
        warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if str(message).startswith(_SYNC_WARNING):
                _S.host_syncs += 1
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(self.mode)
        self.warnings.__exit__(*exc)


class _Span:
    __slots__ = ("name", "timer", "cold", "traced", "t_host", "range", "syncs",
                 "index", "parent", "request", "t0_ns", "c0")

    def __init__(self, name, timer, traced):
        self.name, self.timer, self.traced = name, timer, traced

    def __enter__(self):
        self.cold = self.name not in _seen
        if self.cold:
            _seen.add(self.name)
        if self.timer is not None:
            _synchronize()
        if self.traced:
            self.range = _range(self.name)
            self.range.__enter__()
            self.t0_ns = time.time_ns()
            outer = not _S.open
            self.syncs = _SyncCount() if outer and torch.cuda.is_initialized() else None
            if self.syncs is not None:
                self.syncs.__enter__()
            if outer:
                if _S.pinned is not None:
                    self.request = _S.pinned
                else:
                    self.request = _S.next_request
                    _S.next_request += 1
                self.parent = -1
            else:
                self.request, self.parent = _S.open[-1].request, _S.open[-1].index
            self.index = _S.next_index
            _S.next_index += 1
            _S.open.append(self)
            self.c0 = _counters()
        self.t_host = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t_host
        if self.traced:
            c1 = _counters()
            _S.open.pop()
            if self.syncs is not None:
                self.syncs.__exit__(*exc)
            t1_ns = time.time_ns()
            self.range.__exit__(*exc)
            _S.ring.append(Record(self.index, self.name, self.parent, self.request,
                                  self.t0_ns, t1_ns, c1[0] - self.c0[0],
                                  c1[1] - self.c0[1]))
        if self.timer is not None:
            _synchronize()
            self.timer.record(self.name, time.perf_counter() - self.t_host)
        if self.cold:
            _S.first[self.name] = seconds
        return False


def span(name: str, timer=None):
    """The stage ``name`` (module docstring); with a ``StageTimer``,
    synchronized and recorded there under ``name``."""
    traced = _on or _profiler_enabled()
    if not traced and timer is None and name in _seen:
        return _NULL
    return _Span(name, timer, traced)


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
        _S.host_syncs += 1
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
