"""ba_launches.seq: device operations inside the program's ``ba.system``,
``ba.solve`` and ``ba.step`` spans (``models/bundle_adjust.run_ba``: each
LM iteration's system, Schur solve and step, in every local and global
BA) and ``global_ba.prune`` (the pruning and its re-triangulation) in
the profiled slice, per frame of the sequence
(``harness/program_spans.py``)."""

from portbench.harness import program_spans

STAGES = ("ba.system", "ba.solve", "ba.step", "global_ba.prune")


def read(run):
    n = program_spans.launches(run, STAGES)
    return None if n is None else n / run.units_per_request
