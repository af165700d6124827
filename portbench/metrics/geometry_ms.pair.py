"""geometry_ms.pair: mean host-clock ms per pair of the benchmark's
synchronized span around ``two_view_geometry``, over the traced
window's requests after the profiled slice."""


def read(run):
    spans = run.host_spans("geometry")
    return sum(s.t1 - s.t0 for s in spans) / len(spans) * 1e3 if spans else None
