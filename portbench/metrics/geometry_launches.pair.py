"""geometry_launches.pair: device operations (kernels, copies, fills)
inside the ``geometry`` spans of the profiled slice, per pair."""


def read(run):
    p = run.profile
    if p is None or not p.requests:
        return None
    n = len(p.in_span("geometry"))
    return n / p.requests if n else None
