"""ba_ms.seq: host-clock ms per frame of the synchronized ``local_ba``
(the windowed local BA after each frame and the point-only pass) and
``global_ba`` stages that ``run_incremental`` records through the
entry's timer, over the traced window's requests after the profiled
slice."""


def read(run):
    spans = run.host_spans("local_ba") + run.host_spans("global_ba")
    requests = {s.request for s in run.host_spans("sequence")}
    if not spans or not requests:
        return None
    return sum(s.t1 - s.t0 for s in spans) / (len(requests) * run.units_per_request) * 1e3
