"""glue_launches.sift: device operations inside the program's
``sift.extract`` spans of the profiled slice less those spans'
``kernel_launches`` (the hand-written kernels K1-K9 they launched,
``ops/_cuda.LAUNCHES``), per pair: PyTorch's operations around the
kernels (``harness/program_spans.py``)."""

from portbench.harness import program_spans


def read(run):
    a = program_spans.attribute(run.profile)
    spans = a.named(("sift.extract",)) if a is not None else []
    if not spans:
        return None
    glue = len(a.ops_in(("sift.extract",))) - sum(r.kernel_launches for r in spans)
    return glue / run.profile.requests
