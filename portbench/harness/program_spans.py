"""The program's own spans (``sfm_tpu_torch/utils/timing.py``) over the
profiled slice of a traced run.

The program records each span it opens while a profiler records
(``timing.records()``: name, enclosing span, request, host interval on
``time.time_ns()``, the clock of the profiler's events, and the deltas
of its counters).  :func:`attribute` keeps the records whose interval
lies in the slice and gives each device operation and each idle gap of
the slice to the innermost of them whose interval holds its start.  An
operation that the host launched at the end of one span and that the
card starts after it closed goes to the span the host is in by then.

A program without these spans, or a slice that holds none of them,
reads None.
"""

from __future__ import annotations

from typing import NamedTuple


def _timing():
    try:
        from sfm_tpu_torch.utils import timing
    except ImportError:
        return None
    return timing


def program_records() -> list:
    """``timing.records()`` of the program in this process ([] where the
    program has none)."""
    read = getattr(_timing(), "records", None)
    return list(read()) if read is not None else []


def first_calls() -> dict:
    """``timing.first_calls()``: span name -> host seconds of its first
    call in the process ({} where the program has none)."""
    read = getattr(_timing(), "first_calls", None)
    return dict(read()) if read is not None else {}


def _innermost(recs, times) -> list:
    """For each of the sorted ``times`` (s), the position in ``recs``
    (nested intervals sorted by start) of the innermost one holding it,
    or -1."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(recs) and recs[j][1] <= t:
            while stack and recs[stack[-1]][2] < recs[j][1]:
                stack.pop()
            stack.append(j)
            j += 1
        while stack and recs[stack[-1]][2] < t:
            stack.pop()
        out.append(stack[-1] if stack else -1)
    return out


class Attribution(NamedTuple):
    """The slice's program records (``records``: Record, start_s, end_s,
    by start), each device operation's innermost record (``op_span``,
    a position in ``records`` or -1, in the order of ``profile.ops``)
    and each idle gap's (``gaps``: [(start_s, length_s, position)])."""

    profile: object
    records: list
    op_span: list
    gaps: list

    def named(self, names) -> list:
        return [r for r, _, _ in self.records if r.name in names]

    def below(self, names) -> set:
        """Positions of the records named in ``names`` and of every
        record inside one of them."""
        pos = {r.index: i for i, (r, _, _) in enumerate(self.records)}
        inside = set()
        for i, (r, _, _) in enumerate(self.records):
            k = i
            while k is not None:
                rk = self.records[k][0]
                if rk.name in names:
                    inside.add(i)
                    break
                k = pos.get(rk.parent)
        return inside

    def ops_in(self, names) -> list:
        """The device operations of the spans named in ``names``, their
        children's included."""
        inside = self.below(names)
        return [op for op, k in zip(self.profile.ops, self.op_span) if k in inside]

    def outermost(self) -> list:
        """The slice's records that no other of its records holds."""
        held = {r.index for r, _, _ in self.records}
        return [r for r, _, _ in self.records if r.parent not in held]


def attribute(profile, records=None):
    """The :class:`Attribution` of ``profile`` (``harness/trace.Profile``)
    to ``records`` (default: the program's), or None where the profile
    or its slice's program records are missing."""
    if profile is None or not profile.requests:
        return None
    recs = program_records() if records is None else records
    recs = sorted(((r, r.t0_ns * 1e-9, r.t1_ns * 1e-9) for r in recs
                   if profile.start_s <= r.t0_ns * 1e-9 and r.t1_ns * 1e-9 <= profile.end_s),
                  key=lambda x: (x[1], -x[2]))
    if not recs:
        return None
    op_span = _innermost(recs, [s for _, s, _, _ in profile.ops])
    gaps, end = [], profile.start_s
    for _, s, e, _ in profile.ops:
        if s > end:
            gaps.append((end, s - end))
        end = max(end, e)
    if profile.end_s > end:
        gaps.append((end, profile.end_s - end))
    where = _innermost(recs, [t for t, _ in gaps])
    return Attribution(profile, recs, op_span,
                       [(t, n, k) for (t, n), k in zip(gaps, where)])


def launches(run, names):
    """Device operations per request inside the spans named in ``names``
    (their children's included), or None where the slice has none of
    those spans."""
    a = attribute(run.profile)
    if a is None or not a.named(names):
        return None
    return len(a.ops_in(names)) / run.profile.requests


def host_syncs(run):
    """``host_syncs`` deltas of the slice's outermost program spans, per
    request."""
    a = attribute(run.profile)
    if a is None:
        return None
    return sum(r.host_syncs for r in a.outermost()) / run.profile.requests


def table(a: Attribution) -> dict:
    """Per span name of the slice (``""``: outside every program span):
    ``spans`` (records), ``launches`` and ``device_ms`` (the operations
    whose innermost span it is), ``host_ms`` (the records' host
    intervals), ``idle_ms`` (the idle gaps whose innermost span it is)
    and ``host_syncs`` (the records' own, less their children's)."""
    out: dict = {}

    def row(name):
        return out.setdefault(name, {"spans": 0, "launches": 0, "device_ms": 0.0,
                                     "host_ms": 0.0, "idle_ms": 0.0, "host_syncs": 0})

    held = {r.index: r for r, _, _ in a.records}
    for r, s, e in a.records:
        row(r.name)["spans"] += 1
        row(r.name)["host_ms"] += (e - s) * 1e3
        row(r.name)["host_syncs"] += r.host_syncs
        if r.parent in held:
            row(held[r.parent].name)["host_syncs"] -= r.host_syncs
    for (_, s, e, _), k in zip(a.profile.ops, a.op_span):
        x = row(a.records[k][0].name if k >= 0 else "")
        x["launches"] += 1
        x["device_ms"] += (e - s) * 1e3
    for _, n, k in a.gaps:
        row(a.records[k][0].name if k >= 0 else "")["idle_ms"] += n * 1e3
    return out


def longest_gaps(a: Attribution, top: int = 10) -> list:
    """The ``top`` longest idle gaps: [(innermost span or "", ms)]."""
    gaps = sorted(a.gaps, key=lambda g: -g[1])[:top]
    return [(a.records[k][0].name if k >= 0 else "", n * 1e3) for _, n, k in gaps]


def top_ops(a: Attribution, top: int = 3) -> dict:
    """Per span name, its ``top`` device operations by device ms:
    {span: [(operation, ms)]}."""
    by: dict = {}
    for (name, s, e, _), k in zip(a.profile.ops, a.op_span):
        ops = by.setdefault(a.records[k][0].name if k >= 0 else "", {})
        ops[name] = ops.get(name, 0.0) + (e - s) * 1e3
    return {span: sorted(ops.items(), key=lambda kv: -kv[1])[:top]
            for span, ops in by.items()}
