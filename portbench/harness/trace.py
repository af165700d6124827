"""Spans around the port's calls, the profiled slice of a traced window,
and what the per-layer metric readers read.

A span synchronizes the card on entry and exit, so its host-clock time
is the work inside it, and it opens a ``torch.profiler`` range of its
name, so the device operations it launched fall inside its interval
in the profile.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch


class Span(NamedTuple):
    name: str
    request: int
    t0: float      # host perf_counter seconds
    t1: float


class Spans:
    """Synchronized spans of one traced window."""

    def __init__(self, dev):
        self.dev = dev
        self.items: list[Span] = []
        self.request = -1

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    @contextlib.contextmanager
    def span(self, name):
        with torch.profiler.record_function(name):
            self._sync()
            t0 = time.perf_counter()
            yield
            self._sync()
            self.items.append(Span(name, self.request, t0, time.perf_counter()))


def _ns(ev, which):
    if hasattr(ev, which + "_ns"):
        return getattr(ev, which + "_ns")()
    if which == "duration":
        return ev.duration_us() * 1000
    return ev.start_us() * 1000


class Profile(NamedTuple):
    """The profiled slice: device operations [(name, start_s, end_s,
    span name or "")], the spans' intervals in the profile's clock
    [(name, start_s, end_s)], its wall interval and requests covered."""

    ops: list
    ranges: list
    start_s: float
    end_s: float
    requests: int

    @property
    def wall_s(self) -> float:
        return self.end_s - self.start_s

    def busy_s(self) -> float:
        """Seconds in which any device operation ran (their union)."""
        busy, end = 0.0, -float("inf")
        for _, s, e, _ in sorted(self.ops, key=lambda o: o[1]):
            if e > end:
                busy += e - max(s, end)
                end = e
        return busy

    def in_span(self, name) -> list:
        return [o for o in self.ops if o[3] == name]


SLICE = "portbench.slice"


def read_profile(prof, span_names, requests: int) -> Profile:
    """The device operations of a finished ``torch.profiler`` run, each
    named by the innermost span (of ``span_names``) whose range holds
    its start; the slice is the range named :data:`SLICE`."""
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    names = set(span_names) | {SLICE}
    ranges, ops, wall = [], [], None
    for ev in events:
        start = _ns(ev, "start")
        dur = _ns(ev, "duration")
        if ev.device_type() == cuda:
            # The ranges' mirrors on the device's timeline are no work.
            annotation = getattr(ev, "is_user_annotation", lambda: False)()
            if dur > 0 and not annotation and ev.name() not in names:
                ops.append([ev.name(), start * 1e-9, (start + dur) * 1e-9, ""])
        elif ev.name() in span_names:
            ranges.append((ev.name(), start * 1e-9, (start + dur) * 1e-9))
        elif ev.name() == SLICE:
            wall = (start * 1e-9, (start + dur) * 1e-9)
    ranges.sort(key=lambda r: r[1])
    ops.sort(key=lambda o: o[1])
    j = 0
    for op in ops:
        while j < len(ranges) and ranges[j][2] < op[1]:
            j += 1
        for k in range(j, len(ranges)):
            if ranges[k][1] > op[1]:
                break
            if ranges[k][1] <= op[1] <= ranges[k][2]:
                op[3] = ranges[k][0]
    if wall is None:
        raise RuntimeError(f"the profile holds no {SLICE} range")
    ops = [tuple(o) for o in ops if wall[0] <= o[1] <= wall[1]]
    return Profile(ops, ranges, wall[0], wall[1], requests)


def breakdown(p: Profile, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the slice named by the span the host was in."""
    by_name: dict = {}
    for name, s, e, _ in p.ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps, end = [], p.start_s
    for _, s, e, _ in p.ops:
        if s > end:
            gaps.append((end, s - end))
        end = max(end, e)
    if p.end_s > end:
        gaps.append((end, p.end_s - end))

    def where(t):
        inside = [r for r in p.ranges if r[1] <= t <= r[2]]
        return min(inside, key=lambda r: r[2] - r[1])[0] if inside else "between spans"

    gaps = sorted(gaps, key=lambda g: -g[1])[:top]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[where(t), s] for t, s in gaps]}


class Trace(NamedTuple):
    """What a per-layer metric reader gets from a traced run."""

    cell: dict
    config: dict          # the configuration as run
    requests: list        # [(request, t0, t1)] of the window
    window_s: float
    units_per_request: int
    spans: list           # [Span]
    profile: Profile | None
    work: dict            # request -> the entry's counts of live work
    setup_s: float        # process start to the first timed request

    def first_unprofiled(self) -> int:
        return self.profile.requests if self.profile is not None else 0

    def host_spans(self, name) -> list:
        """Spans of ``name`` in the requests after the profiled slice
        (the profiler slows the host; host-clock metrics skip it)."""
        first = self.first_unprofiled()
        return [s for s in self.spans if s.name == name and s.request >= first]

    def idle_pct(self):
        """One minus the device's busy seconds per request in the
        profiled slice over the mean latency of the traced window's
        requests after it (%): the profiler slows the host about twice
        over, so the slice's own wall time would overstate the idle
        share."""
        p = self.profile
        first = self.first_unprofiled()
        after = [t1 - t0 for r, t0, t1 in self.requests if r >= first]
        if p is None or not p.requests or not p.ops or not after:
            return None
        return 100.0 * (1.0 - (p.busy_s() / p.requests) / (sum(after) / len(after)))

    def units(self) -> int:
        return len(self.requests) * self.units_per_request


def profiler(dev):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)

