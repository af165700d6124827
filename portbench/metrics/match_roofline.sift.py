"""match_roofline.sift: the top-2 search's least time on the card
(``harness/roofline.match_work`` over the live descriptors of both
images: bf16 products at 989 TFLOP/s or 3.35 TB/s, whichever bounds)
over the device time of every operation inside the ``match`` spans of
the profiled slice (%)."""

from portbench.harness import roofline


def read(run):
    p = run.profile
    if p is None or not p.requests:
        return None
    device_s = sum(e - s for _, s, e, _ in p.in_span("match"))
    least = sum(roofline.least_s(*roofline.match_work(*run.work[r]["live"]),
                                 roofline.BF16_FLOPS) for r in range(p.requests))
    return 100.0 * least / device_s if device_s > 0 else None
