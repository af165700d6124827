"""The least time a stage could take on one H100, counted from what the
stage's function needs, whatever kernels implement it: its inputs read
once, its outputs written once, and its arithmetic, from the cell's
shapes and the request's live keypoints and descriptors (never the
padded slots, never the maps or scratch one implementation writes).

Peaks: NVIDIA's H100 SXM data sheet, dense (the port's ``chip_smoke.py``
uses the same): HBM 3.35 TB/s, float32 on the CUDA cores 67 TFLOP/s,
bf16 on the tensor cores 989 TFLOP/s; all at the 700 W limit.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

DESC = 128
KP_FIELDS = 8          # x, y, scale, sharpness, edgeness, orientation, octave, valid


def least_s(flops: float, nbytes: float, peak: float) -> float:
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def extract_work(height: int, width: int, sift: dict, live: int):
    """(flops, bytes) of SIFT extraction of one [height, width] f32
    image giving ``live`` keypoints.

    Counted: the image read once (4 B/px); each live keypoint's
    descriptor (128 f32) and its 8 scalar fields written once; the 2x
    upsample (2 flops per output pixel) where ``up_scale``; the
    prefilter and each octave plane's separable 9-tap blur (2 passes x
    9 taps x 2 flops per pixel of the octave), the descents' separable
    5-tap blur (2 x 5 x 2 per output pixel) and the DoG differences (1
    per pixel per plane pair).  Not counted, so the count stays under
    any implementation's: extremum tests, refinement, orientation and
    descriptor sampling, selection and compaction.
    """
    H, W = (2 * height, 2 * width) if sift.get("up_scale") else (height, width)
    flops = 2.0 * H * W if sift.get("up_scale") else 0.0
    flops += 36.0 * H * W                        # the prefilter
    planes = sift.get("num_scales", 5) + 3
    for o in range(sift.get("num_octaves", 5)):
        px = (H >> o) * (W >> o)
        if o:
            flops += 20.0 * px                   # the descent to this octave
        flops += 36.0 * planes * px + (planes - 1) * px
    nbytes = 4.0 * height * width + live * 4.0 * (DESC + KP_FIELDS)
    return flops, nbytes


def match_work(n1: int, n2: int):
    """(flops, bytes) of the top-2 search of n1 live descriptors against
    n2: 2 * n1 * n2 * 128 products-and-adds, both sets read once as
    f32, and (best, second, index) written once per row."""
    return 2.0 * n1 * n2 * DESC, 4.0 * DESC * (n1 + n2) + 12.0 * n1
