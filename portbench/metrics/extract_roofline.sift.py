"""extract_roofline.sift: the extraction's least time on the card
(``harness/roofline.extract_work``: the image read once, the live
keypoints and descriptors written once, the pyramid's blurs at 67
TFLOP/s f32 or 3.35 TB/s, whichever bounds) over the device time of
every operation inside the ``extract`` spans of the profiled slice (%)."""

from portbench.harness import roofline


def read(run):
    p = run.profile
    if p is None or not p.requests:
        return None
    ops = p.in_span("extract")
    device_s = sum(e - s for _, s, e, _ in ops)
    cfg = run.config
    least = 0.0
    for r in range(p.requests):
        for live in run.work[r]["live"]:
            least += roofline.least_s(*roofline.extract_work(
                cfg["height"], cfg["width"], cfg["sift"], live), roofline.F32_FLOPS)
    return 100.0 * least / device_s if device_s > 0 else None
