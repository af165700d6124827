"""chain_ms.ring: host-clock ms per frame of the ring's chain, the
synchronized stages that ``reconstruct_ring`` records through the
entry's timer before the turntable's (``extract``, ``match``,
``bootstrap``, ``register``, ``local_ba``, ``global_ba``), over the
traced window's requests after the profiled slice."""

STAGES = ("extract", "match", "bootstrap", "register", "local_ba", "closure", "global_ba")


def read(run):
    spans = [s for name in STAGES for s in run.host_spans(name)]
    requests = {s.request for s in run.host_spans("ring")} & {s.request for s in spans}
    if not spans or not requests:
        return None
    return sum(s.t1 - s.t0 for s in spans) / (len(requests) * run.units_per_request) * 1e3
