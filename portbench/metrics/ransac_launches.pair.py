"""ransac_launches.pair: device operations (kernels, copies, fills) inside
the program's ``geometry.bank``, ``geometry.score`` and
``geometry.refit`` spans (``geometry/ransac.py``: the 8-point bank, its
chunked scoring and the LO refit) in the profiled slice, per pair
(``harness/program_spans.py``)."""

from portbench.harness import program_spans

STAGES = ("geometry.bank", "geometry.score", "geometry.refit")


def read(run):
    return program_spans.launches(run, STAGES)
