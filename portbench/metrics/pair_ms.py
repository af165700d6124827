"""pair_ms: the whole window over the two-view reconstructions completed in it (ms)."""


def read(run):
    return run.window_s / run.units() * 1e3 if run.requests else None
