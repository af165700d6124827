"""sift_pair_p95_ms: the 95th percentile, over every pair of the window,
of each pair's latency from its start to its result on the host (ms);
the nearest-rank percentile of all of them."""

import math


def read(run):
    lat = sorted(t1 - t0 for _, t0, t1 in run.requests)
    if not lat:
        return None
    return lat[max(math.ceil(0.95 * len(lat)) - 1, 0)] * 1e3
