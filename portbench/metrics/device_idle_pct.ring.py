"""device_idle_pct: one minus the device's busy seconds per request in
the profiled slice (the union of its operations' intervals) over the
mean latency of the traced window's requests after the slice (%)."""


def read(run):
    return run.idle_pct()
