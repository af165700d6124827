"""extract_ms.sift: host-clock ms per pair of the benchmark's
synchronized spans around ``frontend.extract_sift`` (two per pair),
over the traced window's requests after the profiled slice."""


def read(run):
    spans = run.host_spans("extract")
    pairs = len({s.request for s in spans})
    return sum(s.t1 - s.t0 for s in spans) / pairs * 1e3 if pairs else None
