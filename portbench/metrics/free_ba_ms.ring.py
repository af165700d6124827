"""free_ba_ms.ring: host-clock ms per frame of the synchronized
``free_ba`` and ``snap`` stages of ``reconstruct_turntable`` (the
annealed free-gauge BA, the fit and snap to the ring and the BA after
it), recorded through the entry's timer, over the traced window's
requests after the profiled slice."""


def read(run):
    spans = run.host_spans("free_ba") + run.host_spans("snap")
    requests = {s.request for s in spans}
    if not spans:
        return None
    return sum(s.t1 - s.t0 for s in spans) / (len(requests) * run.units_per_request) * 1e3
