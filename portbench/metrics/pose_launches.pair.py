"""pose_launches.pair: device operations inside the program's
``geometry.multistart``, ``geometry.probe``, ``geometry.refine``,
``geometry.tvote`` and ``geometry.final`` spans (``models/two_view.py``:
the pose candidates and their scores, the probe refinement, the refine
rounds, the translation re-votes, the final pose and triangulation) in
the profiled slice, per pair (``harness/program_spans.py``)."""

from portbench.harness import program_spans

STAGES = ("geometry.multistart", "geometry.probe", "geometry.refine",
          "geometry.tvote", "geometry.final")


def read(run):
    return program_spans.launches(run, STAGES)
