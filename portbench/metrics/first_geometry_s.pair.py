"""first_geometry_s.pair: host seconds of the process's first call of
``two_view.geometry`` (the warm request's, in set-up), from the
program's record of each span name's first call
(``sfm_tpu_torch/utils/timing.first_calls``)."""

from portbench.harness import program_spans


def read(run):
    return program_spans.first_calls().get("two_view.geometry")
