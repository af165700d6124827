"""host_syncs.pair: blocking device-to-host synchronizations the program
caused inside its outermost spans of the profiled slice
(``two_view.frontend``, ``two_view.geometry``), per pair: the
``host_syncs`` counter of ``sfm_tpu_torch/utils/timing.py`` (PyTorch's
sync debug mode and the program's own synchronize calls; syncs inside
libraries such as MAGMA are not seen)."""

from portbench.harness import program_spans


def read(run):
    return program_spans.host_syncs(run)
