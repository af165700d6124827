"""match_ms.sift: host-clock ms per pair of the benchmark's synchronized
span around ``sift/match.match`` (the top-2 search and its ratio
test), over the traced window's requests after the profiled slice."""


def read(run):
    spans = run.host_spans("match")
    return sum(s.t1 - s.t0 for s in spans) / len(spans) * 1e3 if spans else None
