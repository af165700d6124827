"""register_launches.seq: device operations (kernels, copies, fills)
inside the program's ``register`` spans and their children
(``pnp.bank``, ``pnp.lo``, ``register.tracks``) in the profiled slice,
per frame of the sequence (``harness/program_spans.py``)."""

from portbench.harness import program_spans


def read(run):
    n = program_spans.launches(run, ("register",))
    return None if n is None else n / run.units_per_request
