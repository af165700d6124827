"""sift_pair_ms: the whole window over the extract+match pairs completed in it (ms)."""


def read(run):
    return run.window_s / run.units() * 1e3 if run.requests else None
