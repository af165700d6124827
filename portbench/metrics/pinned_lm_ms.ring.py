"""pinned_lm_ms.ring: host-clock ms per frame of the synchronized
``pinned_lm`` stage of ``reconstruct_turntable`` (the anneal over both
phase directions and the self-calibrating round), recorded through the
entry's timer, over the traced window's requests after the profiled
slice."""


def read(run):
    spans = run.host_spans("pinned_lm")
    requests = {s.request for s in spans}
    if not spans:
        return None
    return sum(s.t1 - s.t0 for s in spans) / (len(requests) * run.units_per_request) * 1e3
