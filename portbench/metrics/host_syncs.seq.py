"""host_syncs.seq: blocking device-to-host synchronizations the program
caused inside its outermost spans of the profiled slice
(``incremental.run``), per sequence: the ``host_syncs`` counter of
``sfm_tpu_torch/utils/timing.py`` (PyTorch's sync debug mode and the
program's own synchronize calls; syncs inside libraries such as MAGMA
are not seen).  The profiled request runs without the entry's timer,
so none of these are the timer's."""

from portbench.harness import program_spans


def read(run):
    return program_spans.host_syncs(run)
