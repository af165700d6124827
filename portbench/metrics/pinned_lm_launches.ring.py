"""pinned_lm_launches.ring: device operations (kernels, copies, fills)
inside the program's ``pinned_lm`` spans and their children
(``pinned_lm.triangulate``, ``pinned_lm.jacobian``, ``pinned_lm.solve``)
in the profiled slice, per ring (``harness/program_spans.py``)."""

from portbench.harness import program_spans


def read(run):
    return program_spans.launches(run, ("pinned_lm",))
