"""select_ms.sift: device ms per pair of the operations inside the
program's ``sift.select`` spans (every octave's selection from K3's
maps, ``sift/detect.select_from_maps``: PyTorch's top-k and its glue)
in the profiled slice (``harness/program_spans.py``)."""

from portbench.harness import program_spans


def read(run):
    a = program_spans.attribute(run.profile)
    if a is None or not a.named(("sift.select",)):
        return None
    device_s = sum(e - s for _, s, e, _ in a.ops_in(("sift.select",)))
    return device_s / run.profile.requests * 1e3
