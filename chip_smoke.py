#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (``sfm_tpu_torch``).

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each of which fails the run on any error:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the hand-written kernels (``sfm_tpu_torch/csrc``)
   with nvcc for sm_90a and loads them;
3. kernels at the bench path's shapes: each kernel against its plain
   PyTorch version on the same card tensors (the base chain, K1 + K2 in
   one launch, on a 576 x 720 image's 5 levels, on its 9 levels and on
   an odd 575 x 719 image, bit for bit, and the standalone K1 and K2 on
   them; K3 on the 5
   octave bases in one launch, which must equal its per-octave launches
   bit for bit, K3's gated mode (``lowest_scale > 0``) at the gates of
   ``lowest_scale=1.0`` and at gate 0, K3 on 9 octaves at 11
   planes, whose two launches must equal the per-octave ones, and K3 at
   14 and 19 planes (its run-time-plane route) in both modes, bit for
   bit; K4, K8 and K9 on the 2,560 capped slots, K9 also
   against K4's own output, K5 on their duplicate subset and, at K4's
   own orientations, against K4's descriptors bit for bit, K6 at
   5,120 x 5,120 x 128), with CUDA-event times for both (and the
   kernel's device time alone, its calls queued behind a spin kernel so
   the host's enqueue is hidden), each kernel's bound on the card, and,
   where one PyTorch call computes the same function, that call's time
   (for K6 also the two-call ``torch.topk(a @ b.T, 2)``, in the JSON
   report only);
4. the bench path: ``two_view_pipeline`` with bench.py's own config
   (``slice_config``) on a 720 x 576 synthetic textured pair
   (``tests/synthetic_pair.py``) over 8 RANSAC seeds, gated against the
   JAX package's numbers on the same pair and the rendered ground-truth
   pose; then K10 (``refine_relative_pose``) on the inputs one pair of
   that path hands it, the probe's 8 starts x 6 steps and the first
   round's 1 start x 10 steps at 2,560 correspondences, against the
   plain route in float32 and float64 (as ``tests/test_torch_cuda.py``
   holds it), with K10's device ms, the plain route's device ms and
   launches (from a profile) and host ms beside it, and digests of
   K10's outputs;
5. the up-scale path: tools/bench_upscale.py's up_t2.0 config
   (``upscale_config``: a 1280 x 960 input up-scaled to a 2560 x 1920
   base) on the rotation-only synthetic pair (``rotation_pair``):
   extraction of both images, matching, then bench_upscale's H-fit
   (``ransac_homography`` + ``improve_homography`` + the 3 px count),
   gated against the JAX package's features, candidates and H-fit on
   the same pair and against the pair's exact homography.  Then every
   kernel against its plain version on that run's inputs, at its shapes
   (K7 on the two 960 x 1280 images, the base chain on the 1920 x 2560
   base's 5 levels, K3 in both modes on its 5 octave bases, K4, K8 and K9 on the
   11,776 capped slots of the 4,200 x 2,560 atlas, K5 on their
   duplicates, K6 on the run's own 23,552 x 23,552 x 128 descriptor
   sets), with the tolerances of phase 3.  Then the same path with
   ``lowest_scale=1.0`` (K3's gated mode), gated against the JAX
   package's numbers at that configuration, with fewer features than
   the ungated run;
6. the module API at the bench path's width: ``assign_orientations``
   (K8) and ``extract_descriptors(valid=...)`` (K5) on the atlas and
   every detection slot of a real ``detect_stage`` of the 576 x 720
   image, gated against K4's (and K5's) output on the same keypoints;
   then K8 and K5 against their plain versions on the 5,120 compacted
   slots this phase gave them, with the tolerances of phase 3;
7. the up-scale path again with ``sample_window=True`` (K9 in place of
   K4): features, matches, H-fit and H error must equal phase 5's;
8. the command-line driver: the synthetic pair written as PGMs and
   ``sfm_tpu_torch.cli.main(["reconstruct", ...])`` in-process at the
   CLI's defaults (the translation re-vote on) over 8 seeds, gated
   against the JAX CLI's numbers on the same PGMs
   (``tests/jax_cli_reference.py``) and the rendered pose; then
   ``sift --up-scale --homography`` on the rotation pair's PGMs, and
   ``sift --max-pts 4096 --up-scale`` (20,480 detection slots) and
   ``sift --octaves 9`` (two K3 launches per image), both with
   ``--homography`` and gated against the JAX CLI; then
   ``run_two_view`` at ``PipelineConfig()`` as it stands;
9. multi-view SfM on a 12-frame 576 x 720 sequence rendered on an arc
   (``tests/synthetic_sequence.py``) at the CLI's defaults: (a)
   ``reconstruct`` of its 12 PGMs through the CLI with ``--checkpoint``
   (PLY vertices = ``num_points``, the checkpoint equal to the run's
   map), (b) ``run_incremental`` on the float frames with the closure
   pair (0, 11), each gated against the JAX package's run on the same
   frames (poses registered, points, px, and ATE and rotation errors
   against the rendered poses); ms per registered frame by stage; K11
   (``pnp_lo``) on the LO inputs of (b)'s last registered frame against
   the plain route in float32 and float64 (as ``tests/test_torch_cuda.py``
   holds it), with K11's device ms, the plain route's host and device
   ms and launches, and a digest of K11's outputs; then
   ``run_ba``'s dense LU and CG on (b)'s global BA problem, with camera
   0 fixed and with none fixed, and on a free 36-camera ring, against
   a float64 CPU solve (final cost, gap, ms per LM iteration; the
   solver ``run_ba``'s "auto" picks must end within 1e-3 of float64).  Its
   kernels run at the bench path's shapes (the same image size and
   SIFT configuration), where phase 3 holds them;
10. the turntable ring: ``tests/synthetic_ring.py``'s 36 frames of 576
   x 720 (a textured box on a turning disc, 10 degrees per frame,
   radial distortion k1 = -0.45) written as ``viff.000.ppm`` ...
   ``viff.036.ppm``, and the driver users run, ``python -m
   sfm_tpu_torch.tools.reconstruct_dino --dir DIR --turntable`` (its
   ``main`` in-process), at its defaults: 512 points per octave, 1,024
   hypotheses, 30 BA iterations; gated on r5's bar against the rendered
   ring (mean step within 0.2 degrees of 10, std <= 0.3, 360 +- 2
   degrees in all, <= 1.5 px) and against the JAX package's run on the
   same files (px, tracks, kept observations, f, k1's sign, rotation
   errors against the rendered poses), its PLY against its metrics,
   K1-K5 once per frame and K6 once per chain pair and ring pair; ms per
   frame by stage; then ``run_ba``'s dense LU and CG on the run's own
   free-BA stage (dumped by ``SFM_TPU_TT_DUMP``, no camera fixed)
   against a float64 CPU solve;
11. the distributed layer (``sfm_tpu_torch/parallel/``): (a) on a
   one-rank NCCL mesh in this process, phase 9's 12 PGMs through
   ``reconstruct ... --mesh 1 --checkpoint`` (K6 once per matched pair
   through ``dist_match``, the global BA through ``run_dist_ba``), gated
   as phase 9 (a), with ms per frame by stage beside phase 9's; then
   ``dist_match_top2`` at ``__graft_entry__.py``'s dry-run shape (4,096
   x 4,096) equal to the local K6 bit for bit, ``run_dist_ba`` (CG and
   dense) on that run's global BA problem against ``run_ba`` with the
   same solver (within 1e-6, deterministic algorithms on both), and on
   the dry run's 16-camera rig (``tests/ba_problems.py:rig_problem``,
   16,384 observations), with ms per LM iteration; ``make_mesh(2)``
   must refuse, naming the one card; (b) two processes sharing the
   card over gloo (``tests/torch_dist_worker.py``): K6 on each rank's
   2,048 rows, the merged top-2 equal to (a)'s, the rig's BA within
   1e-3 of (a)'s cost, the same on both ranks;
12. the XLA routes (``SiftConfig(fused_detect=False, use_pallas=False)``
   and ``MatchConfig(use_pallas=False)``: the dense DoG detector,
   two-stage sampling and the f32 matcher): (a) the bench path of phase
   4 on that route over 8 seeds, gated against the JAX package's run of
   the same configuration (``tests/jax_cli_reference.py --parts xla``)
   and the rendered pose, with ms per pair and per stage beside the
   fused route's; (b) the up-scale path of phase 5 on that route at
   ``lowest_scale`` 0 and 1.0, features and ratio-test matches at 98-102%
   of the JAX package's (its numbers are its XLA route's), the H error
   bars of phase 5, the gated run with fewer features; (c)
   ``build_pyramid`` + ``detect`` on the 576 x 720 image against the
   fused route's ``detect_stage`` (counts within 1%, shared keypoints
   within 0.2 px); (d) the route's kernels against their plain versions
   at its shapes: K6 in its f32 mode at 5,120^2 and at the up-scale
   run's 23,552^2 (with the f32 ``torch.topk(a @ b.T, 2)`` as its
   library call, and as its bound the least time of an f32-accurate
   product: three TF32 passes at 495 TFLOP/s), K8 on each image's
   capped slots and K5 on the 2K compacted slots; (e) ``svd3x3(method="analytic")`` against
   ``"jacobi"`` on phase 4's 1,536-hypothesis 8-point bank and
   ``triangulate(solver="adj")`` against ``"jacobi"`` on its 2,560
   compacted correspondences, with ms and launches of each.  The route
   launches the base chain, K8 and K5 once per image, K6 once per pair,
   K7 once per up-scale image, and K3, K4 and K9 never;
13. the dino pair, with bench.py's quality gates, when ``SFM_DINO_DIR``
   names a directory holding ``viff.000.ppm`` and ``viff.001.ppm``
   (bench.py's fixture), and the driver's ``--turntable`` run on r5's
   bar where it holds the 36 ring frames; skipped, and said so, when it
   is unset or the files are absent.

Each of the main paths (phases 4 to 12) runs with every launch count set
to 0 just before it and read just after; each must launch every kernel
it goes through, the base chain exactly once per image and K3 once per
image and 8 octaves it extracts, K6 once per matched pair on the
sequence, K10 three times a bench pair, K11 once per frame registered by
PnP, and together they launch every kernel (K1 and K2 are one kernel).  The last lines of
standard output are the kernels' JSON record (each kernel's
``launches`` summed over those paths, its ``max_abs_err`` the largest
of phases 3, 5, 6 and 12, its times and bound phase 3's, or phase 5's
for K7, phase 6's for K8, phase 4's for K10 and phase 9's for K11; K3's
gated mode under ``gated``, at both
shapes; K6's f32 mode under ``f32`` and K8 and K5 at the XLA route's
shapes under ``xla_route``, from phase 12),
the card's name and power limit, and ``{"ok": true, "device": {...}}``.
A detailed JSON report goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

ROOT = os.path.dirname(os.path.abspath(__file__))

# The JAX package on the same synthetic pair, bench config, 8 seeds,
# measured on CPU (the CPU auto route, its XLA path): median matches
# 1869, inliers 1729, valid points 1729, reprojection 0.1418 px; worst
# seed 0.047 deg rotation and 0.284 deg translation-direction error
# (PERF.md).  The port must reach 90% of each median; the pose bounds
# hold per seed with margin.
JAX_MEDIANS = {"matches": 1869.0, "inliers": 1729.0, "valid": 1729.0,
               "px": 0.1418}
MAX_ROT_DEG = 0.5
MAX_TDIR_DEG = 2.0

# The JAX package on the same rotation pair (rotation_pair(960, 1280,
# seed=0)), up_t2.0 + MatchConfig(), bench_upscale's H-fit with
# PRNGKey(0), measured on CPU through the CPU auto route (use_pallas,
# fused_detect and pyramid_pallas resolve off: XLA conv pyramid, XLA
# sampling, chunked XLA matcher) by `tests/jax_cli_reference.py --parts
# upscale`: features 10,444 / 10,935, ratio-test matches 4,705, 296
# H-fit candidates (5 of them > 3 px off H_gt), H-fit 6,597, and H
# within a median 0.1183 px / max 0.3123 px of H_gt on the 16 x 12 grid
# (PERF.md).  Features, candidates and H-fit must reach 90%; the H error
# gates are 3x the JAX package's, rounded down.
JAX_UPSCALE = {"n1": 10444, "n2": 10935, "matches": 4705, "candidates": 296,
               "numfit": 6597}
MAX_H_MEDIAN_PX = 0.35
MAX_H_MAX_PX = 0.93
# The same with lowest_scale=1.0 (the scale gate; the same script):
# features 10,442 / 10,933, 4,705 matches, 296 candidates (5 wrong),
# H-fit 6,597, H error 0.1184 / 0.3124 px.  The same gates.
JAX_UPSCALE_LOWEST = {"n1": 10442, "n2": 10933, "matches": 4705, "candidates": 296,
                      "numfit": 6597}

# The JAX package's XLA route at bench.py's configuration with
# SiftConfig(fused_detect=False, use_pallas=False) and
# MatchConfig(use_pallas=False) on the same float pair, PRNGKey(seed)
# for seeds 0-7, measured on CPU by `tests/jax_cli_reference.py --parts
# xla`: median matches 1869, inliers 1729, valid points 1729, 0.14182
# px; worst seed 0.047 deg rotation and 0.284 deg translation-direction
# error (the same as JAX_MEDIANS: that run took the same route by the
# CPU's auto rules).  Phase 12 (a) holds the port's XLA route to 90% of
# each median, px <= JAX / 0.9, and the pose bounds on every seed.
JAX_XLA_MEDIANS = {"matches": 1869.0, "inliers": 1729.0, "valid": 1729.0,
                   "px": 0.14181984844571116}
# Phase 12 (b): the up-scale extraction has no random draws, so on the
# XLA route the port's features and ratio-test matches must land within
# 2% of the JAX package's (JAX_UPSCALE, JAX_UPSCALE_LOWEST: its XLA
# route).
XLA_UPSCALE_BAND = (0.98, 1.02)

# The JAX package's CLI (`python -m sfm_tpu reconstruct a.pgm b.pgm
# --focal 792 --seed s`, its defaults otherwise: tvote_rounds=1,
# n_hyps=1024, threshold=3e-6) on synthetic_pair(576, 720, seed=0)
# written as 8-bit PGMs, seeds 0-7, measured on CPU by
# tests/jax_cli_reference.py: median matches 1867, inliers 1730, valid
# points 1730, 0.1424 px; worst seed 0.065 deg rotation and 0.276 deg
# translation-direction error.  The port's CLI must reach 90% of each
# count, px <= JAX / 0.9, and the pose bounds above on every seed.
JAX_CLI_MEDIANS = {"matches": 1867.0, "inliers": 1730.0, "valid": 1730.0,
                   "px": 0.1424}
# The JAX package's run_two_view at PipelineConfig() as it stands (4,096
# hypotheses at 1e-6, tvote_rounds=1), seed 0, on the float pair, by the
# same script: 1869 matches, 1600 inliers, 1600 valid points, 0.1028 px,
# 0.0 / 0.121 deg pose error.  Same gates as above.
JAX_DEFAULT = {"matches": 1869.0, "inliers": 1600.0, "valid": 1600.0, "px": 0.1028}
# The CLI's homography is its RANSAC fit alone (no improve_homography):
# held to H_gt more loosely than the up-scale path's H-fit.
MAX_CLI_H_MEDIAN_PX = 1.0
# The JAX CLI's `sift ra.pgm rb.pgm <options> --homography` on the
# rotation pair's PGMs (`tests/jax_cli_reference.py --parts sift`):
# features per image (H vs H_gt median 0.305 px and 0.791 px).  The
# port's CLI must reach 90% of each, and the H median bound above.
JAX_CLI_SIFT = {
    # 5 x 4,096 = 20,480 detection slots: the rank-major interleave.
    "max_pts_4096_up_scale": (["--max-pts", "4096", "--up-scale"], (3332, 3327)),
    # 9 x 2,048 = 18,432 slots, and K3 in two launches per image.
    "octaves_9": (["--octaves", "9"], (3270, 3220)),
}

# The JAX package on synthetic_sequence(576, 720) (12 frames on an arc,
# tests/synthetic_sequence.py) at the CLI's defaults (1,024 points per
# octave, 1,024 hypotheses at 3e-6, 20 BA iterations, seed 0), measured
# on CPU by `tests/jax_cli_reference.py --parts incremental`: the CLI on
# the frames' PGMs ("cli") and run_incremental on the float frames with
# closure (0, 11) ("module").  Poses registered, points, reprojection
# px, and against the rendered poses the Sim(3)-aligned ATE (units:
# the arc's radius is 7) and the median / largest rotation error in
# degrees.  The port must register as many poses, reach 90% of the
# points, px <= JAX / 0.9, and ATE and rotation errors <= 3x JAX's.
JAX_SEQUENCE = {
    "cli": {"poses": 12, "points": 7008, "px": 0.1999, "ate": 0.00034219950024084994,
            "rot_median_deg": 0.0026895166511059377,
            "rot_max_deg": 0.013062056904247365},
    "module": {"poses": 12, "points": 6906, "px": 0.20272707000263263,
               "ate": 0.0003446777504218315, "rot_median_deg": 0.0031986157657363313,
               "rot_max_deg": 0.013636028924477822},
}

# The ring phase: tools/reconstruct_dino.py --turntable at its defaults
# on synthetic_ring(576, 720) written as its 37 files, run by the JAX
# package on the CPU (tests/jax_cli_reference.py --parts turntable: the
# same files, run_incremental then reconstruct_turntable): 36/36 chain
# poses collapsed to 1.35 degrees per step, then 10.0071 +- 0.1150
# degrees per step, 360.102 in all, 1.0201 px over 26,469 of 33,380
# observations of 6,639 tracks, f 2374.56 px (2360 rendered), k1 -1.603
# (-0.45 rendered: f and k1 trade off in the 17-degree field of view;
# only the sign is held), rotation error against the rendered poses
# median 0.4425 / max 1.0128 degrees.  The port must meet r5's bar
# (RING_BAR) against the rendered ring, reach px <= JAX / 0.9, 90% of
# JAX's tracks and kept observations, f within 1% of JAX's, k1 < 0, and
# rotation errors <= 3x JAX's.
RING_FRAMES = 36
RING_PAIRS = 2 * RING_FRAMES   # build_tracks' ring pairs at gaps (1, 2), wrapped
JAX_RING = {"rms_px": 1.02013099193573, "tracks": 6639, "obs_kept": 26469,
            "f_px": 2374.55615234375, "k1": -1.6031674146652222,
            "step_mean": 10.007133483886719, "step_std": 0.11496232450008392,
            "total_deg": 360.1022044512639, "rot_median_deg": 0.4425427308473272,
            "rot_max_deg": 1.0128416350191813}
# r5's bar on the dino ring (NOTES_R5.md: 9.998 +- 0.108 degrees per
# step, 360.05 in all, 1.199 px): |mean step - 10| <= 0.2, std <= 0.3,
# |total - 360| <= 2, rms <= 1.5 px.
RING_BAR = {"step_mean": 0.2, "step_std": 0.3, "total_deg": 2.0, "rms_px": 1.5}

# One NVIDIA H100 SXM (NVIDIA's data sheet; dense rates at 700 W): the
# least time a kernel could take is the larger of its bytes over the
# memory rate and its operations over the peak rate for their type.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12          # float32 outside the tensor cores
TF32_FLOPS = 495e12        # TF32 tensor cores, f32 accumulation
BF16_FLOPS = 989e12        # bf16 tensor cores, f32 accumulation
# An f32-accurate product: one exact f32 pass on the CUDA cores, or three
# TF32 passes over an error-compensated split (x = hi + lo), whichever
# the card does faster (the latter); the bound reads the work, not the
# kernel.
F32_ACCURATE_FLOPS = max(F32_FLOPS, TF32_FLOPS / 3)

# Operations per live keypoint of the sampling kernels, counted from
# the source (a transcendental, a compare or a floor counts as one): a
# bilinear sample is 13 (2 fractions, 2 complements, 6 products, 3
# sums); an orientation sample 4 of them plus 12 (differences,
# magnitude, Gaussian weight, bin); a descriptor sample 4 plus 28
# (rotated position, differences, magnitude, window, angle bin) and its
# trilinear binning 2 angle bins x 4 cells x 3; the smoothing and peak
# search ~11 per bin.
_BILINEAR = 13
ORI_OPS = 121 * (4 * _BILINEAR + 12)
DESC_OPS = 256 * (4 * _BILINEAR + 28) + 256 * 2 * 4 * 3
PEAK_OPS = 32 * 11

# Where each kernel's time and bound are taken: the bench path's shapes,
# unless the bench path does not launch it.
TIMED_AT = {"scale_up": "upscale", "orientation_histogram_sample": "module_api",
            "refine_relative_pose": "pair_geometry", "pnp_lo": "registration"}

# Operations per correspondence of one K10 step, counted from
# csrc/refine.cu as the sampling kernels' above: the normal pass 300
# (the lines, numerator and denominator 37, the clamped root and its
# cube 8, five derivative columns of 41, the Huber weight 5, the 20
# sums 45), the trial pass's cost 47; one more cost pass at the start.
REFINE_STEP_OPS = 347
REFINE_START_OPS = 47

# Operations per row of K11's passes, counted from csrc/pnp_lo.cu the
# same way: a Gauss-Newton pass 203 (the camera-frame point 18, its
# guarded projection and residual 10, the Huber cost and weight 8, the
# Jacobian 47, the 21 + 6 sums 120), a Gram pass 132 (the scaled rows
# 12, 4 x 10 sums 120), a count pass 56 (two poses), the final mask 28;
# per round two chains of 1 + iters passes, one Gram and one count.
LO_NORMAL_OPS = 203
LO_GRAM_OPS = 132
LO_COUNT_OPS = 56
LO_FINAL_OPS = 28


def lo_ops(n: int, iters: int, rounds: int = 3) -> int:
    """Operations of one K11 call on n rows."""
    return n * (rounds * ((2 * iters + 2) * LO_NORMAL_OPS + LO_GRAM_OPS + LO_COUNT_OPS)
                + LO_FINAL_OPS)


def k3_launches(images: int, octaves: int = 5) -> int:
    """K3 launches once per image for every 8 octaves, all together."""
    return images * -(-octaves // 8)


# The sequence phase: 12 frames, the CLI's run without a closure pair,
# then run_incremental with one.
SEQ_FRAMES = 12
SEQ_CLOSURES = [(0, 11)]
N_BACK = 3     # run_incremental's default


def sequence_matches(n_frames: int, closures: int = 0) -> int:
    """Matcher calls (one K6 launch each) of one run_incremental: the
    bootstrap pair, min(i, N_BACK) previous frames for each frame
    i >= 2, then each closure pair."""
    return 1 + sum(min(i, N_BACK) for i in range(2, n_frames)) + closures


# The distributed phase: the dry run's match (__graft_entry__.py:
# dryrun_multichip, 4,096 x 4,096) and two ranks sharing the card.
DRYRUN_N = 4096
DIST_WORLD = 2
DIST_BA_ITERS = 10

# Images each main path extracts (phases 4 to 11): 16 bench images; 2
# up-scale, 1 module-API, 2 window and 2 gated images; the CLI's 16
# reconstruct images, then 3 sift runs of 2 images, the last with 9
# octaves; the sequence's 12 frames twice; the ring's 36 frames; the
# sequence's 12 frames on the mesh.  The base chain launches once
# per image, K3 once per image and 8 octaves.
PATH_CHAIN = {"bench": 16, "upscale": 2, "module_api": 1, "upscale_window": 2,
              "upscale_lowest": 2, "cli": 16 + 4 + 2, "sequence": 2 * SEQ_FRAMES,
              "ring": RING_FRAMES, "distributed": SEQ_FRAMES}
PATH_K3 = {"bench": k3_launches(16), "upscale": k3_launches(2),
           "module_api": k3_launches(1), "upscale_window": k3_launches(2),
           "upscale_lowest": k3_launches(2),
           "cli": k3_launches(16) + k3_launches(4) + k3_launches(2, 9),
           "sequence": k3_launches(2 * SEQ_FRAMES), "ring": k3_launches(RING_FRAMES),
           "distributed": k3_launches(SEQ_FRAMES)}
# K6 launches where a path fixes them: the sequence's matcher calls; the
# ring's chain matches, then one per ring pair in build_tracks; the
# mesh run's matcher calls (dist_match: one launch on the rank's block).
# K10 launches on the bench path: the probe and two refine rounds a pair
# (bench.py's config: tvote_rounds 0), 8 seeds.
PATH_K10 = {"bench": 3 * 8}
# K11 launches: one per frame registered by PnP (every frame after the
# first two) in each run_incremental: the sequence's CLI run and its
# run with a closure, reconstruct_dino's run on the ring, the mesh's CLI run.
PATH_K11 = {"sequence": 2 * (SEQ_FRAMES - 2), "ring": RING_FRAMES - 2,
            "distributed": SEQ_FRAMES - 2}
PATH_K6 = {"sequence": sequence_matches(SEQ_FRAMES)
           + sequence_matches(SEQ_FRAMES, len(SEQ_CLOSURES)),
           "ring": sequence_matches(RING_FRAMES) + RING_PAIRS,
           "distributed": sequence_matches(SEQ_FRAMES)}
# Kernels each main path must launch (phases 4 to 11).
_BASE = {"base_chain", "detect_maps", "descriptor_sample"}
PATH_KERNELS = {
    "bench": _BASE | {"fused_orient_descriptor", "match_top2", "refine_relative_pose"},
    "upscale": _BASE | {"scale_up", "fused_orient_descriptor", "match_top2"},
    "module_api": _BASE | {"orientation_histogram_sample"},
    "upscale_window": _BASE | {"scale_up", "fused_orient_descriptor_win",
                               "match_top2"},
    "upscale_lowest": _BASE | {"scale_up", "fused_orient_descriptor", "match_top2"},
    "cli": _BASE | {"scale_up", "fused_orient_descriptor", "match_top2",
                    "refine_relative_pose"},
    "sequence": _BASE | {"fused_orient_descriptor", "match_top2", "refine_relative_pose",
                         "pnp_lo"},
    "ring": _BASE | {"fused_orient_descriptor", "match_top2", "pnp_lo"},
    "distributed": _BASE | {"fused_orient_descriptor", "match_top2", "pnp_lo"},
}


def xla_config(cfg):
    """``cfg`` (a PipelineConfig) on the JAX package's XLA route: the
    dense detector, two-stage sampling and the f32 matcher."""
    import dataclasses

    return dataclasses.replace(
        cfg, sift=dataclasses.replace(cfg.sift, fused_detect=False, use_pallas=False),
        match=dataclasses.replace(cfg.match, use_pallas=False))


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call: the calls are queued behind a
    ~10 ms spin kernel, so the events bracket device work only, not the
    host's time to enqueue them (a wrapper that synchronizes falls back
    to ``cuda_ms``'s reading)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, ops: float, peak: float = F32_FLOPS):
    """(least ms on the card, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def patch_bytes(atlas, live: int, P: int) -> int:
    """Atlas bytes a sampling kernel must read: each live keypoint's
    (P + 8) x P f32 patch (P = 40 for K4, K5 and K9, 16 for K8), or the
    whole atlas where that is less."""
    return min(4 * atlas.numel(), live * (P + 8) * P * 4)


def kernel_record(name, err, k_fn, p_fn, shapes, nbytes, ops, peak=F32_FLOPS,
                  lib_fn=None, plain_reps=20):
    """A kernel's record: max |err| against its plain version, CUDA-event
    ms of kernel and plain version, the kernel's device ms alone, the
    bound on the card for ``nbytes``
    and ``ops``, and the ms of ``lib_fn`` (one PyTorch call computing the
    same function) where there is one."""
    from sfm_tpu_torch.utils.precision import f32_precision

    src, replaces = KERNEL_SOURCES[name]
    b_ms, b_by = bound(nbytes, ops, peak)
    lib_ms = None
    if lib_fn is not None:
        with f32_precision():
            lib_ms = cuda_ms(lib_fn)
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
            "max_abs_err": err, "ms": cuda_ms(k_fn), "device_ms": device_ms(k_fn),
            "plain_ms": cuda_ms(p_fn, reps=plain_reps), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms, "bytes": nbytes, "ops": ops,
            "shapes": shapes}


def hold_orientation_kernel(img, x, y, s, count, gates, where):
    """K8 against its plain version on keypoints compacted valid-first:
    within 1e-6 of the largest bin, rows >= ``count`` zero.  Returns
    (max |err|, max |h|)."""
    from sfm_tpu_torch.ops import sample

    hk = sample.orientation_histogram_sample(img, x, y, s, count)
    hp = sample.orientation_histogram_sample_plain(img, x, y, s, count)
    e8 = float((hk - hp).abs().max())
    h8max = float(hp.abs().max())
    gates.check(e8 <= 1e-6 * h8max, f"{where}: K8 max err {e8} (max |h| {h8max})")
    gates.check(not bool(hk[int(count):].any()), f"{where}: K8 rows >= count not zero")
    return e8, h8max


class Gates:
    def __init__(self):
        self.failures = []

    def check(self, cond, msg):
        if not cond:
            self.failures.append(msg)
            log(f"GATE FAIL: {msg}")


def slice_config():
    """bench.py's configuration (bench.py:75-79)."""
    from sfm_tpu_torch.config import PipelineConfig, RansacConfig, SiftConfig

    return PipelineConfig(
        sift=SiftConfig(max_pts_per_octave=1024),
        ransac=RansacConfig(n_hyps=1536, threshold=3e-6, chunk=256),
        tvote_rounds=0,
    )


def upscale_config():
    """tools/bench_upscale.py's up_t2.0 (``cfgf(2.0, True)``)."""
    from sfm_tpu_torch.config import SiftConfig

    per = 4096
    return SiftConfig(num_octaves=5, max_pts_per_octave=per,
                      octave_caps=(per, per, per // 2, per // 4, per // 8),
                      sample_cap=16384, thresh=2.0, init_blur=1.0, up_scale=True)


KERNEL_SOURCES = {
    "base_chain": ("sfm_tpu_torch/csrc/pyramid.cu",
                   "sfm_tpu/ops/pallas_pyramid.py:147 and :272"),
    "scale_up": ("sfm_tpu_torch/csrc/pyramid.cu", "sfm_tpu/ops/pallas_pyramid.py:241"),
    "detect_maps": ("sfm_tpu_torch/csrc/detect.cu", "sfm_tpu/ops/pallas_detect.py:259"),
    "fused_orient_descriptor": ("sfm_tpu_torch/csrc/sample.cu",
                                "sfm_tpu/ops/pallas_sample.py:788"),
    "descriptor_sample": ("sfm_tpu_torch/csrc/sample.cu", "sfm_tpu/ops/pallas_sample.py:414"),
    "match_top2": ("sfm_tpu_torch/csrc/match.cu", "sfm_tpu/ops/pallas_match.py:247"),
    "orientation_histogram_sample": ("sfm_tpu_torch/csrc/sample.cu",
                                     "sfm_tpu/ops/pallas_sample.py:578"),
    "fused_orient_descriptor_win": ("sfm_tpu_torch/csrc/sample.cu",
                                    "sfm_tpu/ops/pallas_sample.py:998"),
    "refine_relative_pose": ("sfm_tpu_torch/csrc/refine.cu",
                             "none: sfm_tpu/geometry/refine.py runs jax.jacfwd under XLA"),
    "pnp_lo": ("sfm_tpu_torch/csrc/pnp_lo.cu",
               "none: the LO stage of sfm_tpu/geometry/pnp.py:ransac_pnp runs under XLA"),
}


def check_path_launches(path, launches, gates):
    """Every kernel the path goes through launched in its run, the base
    chain once per image, K3 once per image and 8 octaves, and K6 once
    per matched pair where the path fixes the pairs."""
    for name in sorted(PATH_KERNELS[path]):
        gates.check(launches[name] > 0, f"kernel {name} was not launched on the "
                    f"{path} path")
    gates.check(launches["base_chain"] == PATH_CHAIN[path],
                f"the base chain launched {launches['base_chain']} times on the "
                f"{path} path, not {PATH_CHAIN[path]}")
    gates.check(launches["detect_maps"] == PATH_K3[path],
                f"K3 launched {launches['detect_maps']} times on the {path} path, "
                f"not {PATH_K3[path]}")
    if path in PATH_K6:
        gates.check(launches["match_top2"] == PATH_K6[path],
                    f"K6 launched {launches['match_top2']} times on the {path} "
                    f"path, not {PATH_K6[path]}")
    if path in PATH_K10:
        gates.check(launches["refine_relative_pose"] == PATH_K10[path],
                    f"K10 launched {launches['refine_relative_pose']} times on the "
                    f"{path} path, not {PATH_K10[path]}")
    if path in PATH_K11:
        gates.check(launches["pnp_lo"] == PATH_K11[path],
                    f"K11 launched {launches['pnp_lo']} times on the {path} path, "
                    f"not {PATH_K11[path]}")


def _conv(taps, stride, dev):
    """One PyTorch module computing a separable blur as a 2-D convolution
    of the edge-replicated image (the yardstick of K1 and K2)."""
    import numpy as np
    import torch

    n = len(taps)
    conv = torch.nn.Conv2d(1, 1, n, stride=stride, padding=n // 2,
                           padding_mode="replicate", bias=False).to(dev)
    with torch.no_grad():
        conv.weight.copy_(torch.as_tensor(np.outer(taps, taps), device=dev))
    conv.requires_grad_(False)
    return conv


# Operations of K3's gated mode per candidate beyond the lean mode's,
# counted from the source: the edge ratio, the adjugate (15), its
# determinant (5), the reciprocal, the three offsets (18), the fallback
# test and divisions (8), the clamps (6), the scale gate (4, exp2 as
# one) and the sharpness (6).
GATED_SOLVE_OPS = 70


def hold_gated_k3(bases, taps, sc, scale_gates, gates, where):
    """K3's gated mode (one launch) against its plain version on each
    octave: both round the same operations in the same order (exp2f as
    torch.exp2), so they must agree bit for bit."""
    from sfm_tpu_torch.ops import detect

    multi = detect.detect_maps_octaves(bases, taps, sc.thresh, sc.edge_limit,
                                       scale_gates, lean=False)
    n_cand = n_diff = 0
    err = 0.0
    for (rk, ak), b, tp, g in zip(multi, bases, taps, scale_gates):
        rp, ap = detect.detect_maps_plain(b, tp, sc.thresh, sc.edge_limit, g,
                                          lean=False)
        gates.check(tuple(ak.shape) == (6, *b.shape),
                    f"{where}: K3 gated aux shape {tuple(ak.shape)}")
        n_cand += int((rp > 0).sum())
        n_diff += int((rk != rp).sum()) + int((ak != ap).sum())
        err = max(err, float((rk - rp).abs().max()), float((ak - ap).abs().max()))
    gates.check(n_cand > 1000, f"{where}: K3 gated mode only {n_cand} candidates")
    gates.check(n_diff == 0, f"{where}: K3 gated mode differs from its plain "
                f"version in {n_diff} values (max |err| {err})")
    return {"candidates": n_cand, "values_differing": n_diff, "max_abs_err": err}


def hold_k3_nine_octaves(img, gates):
    """K3 past 8 octaves at 11 planes (``num_scales=8``): the 9 octave
    bases of ``img`` take two launches, lean and gated (octave o at
    1 / 2**o), equal bit for bit to one launch per octave and to the
    plain version."""
    from sfm_tpu_torch.config import SiftConfig
    from sfm_tpu_torch.ops import _cuda, detect
    from sfm_tpu_torch.sift import frontend, pyramid

    cfg = SiftConfig(num_octaves=9, num_scales=8)
    bases = pyramid.base_chain(img, cfg)
    taps = frontend._tap_banks(cfg)
    out = {}
    for mode, scale_gates in (("lean", [0.0] * 9),
                              ("gated", [1.0 / 2 ** o for o in range(9)])):
        lean = mode == "lean"
        n0 = _cuda.LAUNCHES["detect_maps"]
        multi = detect.detect_maps_octaves(bases, taps, cfg.thresh, cfg.edge_limit,
                                           scale_gates, lean)
        launches = _cuda.LAUNCHES["detect_maps"] - n0
        per_octave = plain = 0
        for (rk, ak), b, tp, g in zip(multi, bases, taps, scale_gates):
            rs, as_ = detect.detect_maps(b, tp, cfg.thresh, cfg.edge_limit, g, lean)
            rp, ap = detect.detect_maps_plain(b, tp, cfg.thresh, cfg.edge_limit, g, lean)
            per_octave += int((rk != rs).sum()) + int((ak != as_).sum())
            plain += int((rk != rp).sum()) + int((ak != ap).sum())
        out[mode] = {"launches": launches, "per_octave_values_differing": per_octave,
                     "plain_values_differing": plain}
        gates.check(launches == 2, f"9 octaves ({mode}): {launches} K3 launches, not 2")
        gates.check(per_octave == 0, f"9 octaves ({mode}): the grouped launches "
                    f"differ from the per-octave ones in {per_octave} values")
        gates.check(plain == 0, f"9 octaves ({mode}): {plain} values differ from plain")
    log(f"K3 on 9 octave bases of {tuple(img.shape)} at 11 planes, lean / gated: "
        f"{out['lean']['launches']} / {out['gated']['launches']} launches; values "
        f"differing, grouped vs per-octave {out['lean']['per_octave_values_differing']}"
        f" / {out['gated']['per_octave_values_differing']}, vs plain "
        f"{out['lean']['plain_values_differing']} / "
        f"{out['gated']['plain_values_differing']} (expected 0)")
    return out


def hold_kernels(img1, img2, sc, gates, where, s1=None, s2=None):
    """Every kernel of a main path against its plain version on the
    card, at the shapes that path gives it: K7 (with ``up_scale``), the
    base chain (K1 + K2) on img1, K3 on its octave bases, K4, K8 and K9
    on its capped sample slots (K9, and K5 at K4's orientations, also
    against K4's output), K5 on their duplicate subset, and K6 on the
    descriptor sets ``s1`` x
    ``s2`` (the path's own extractions of img1 and img2; extracted here
    when not given).  Launches made here are not the path's: callers
    read the launch counts before.  Returns {kernel name: record} with
    max |err|, CUDA-event ms for kernel and plain version, the bound on
    the card, the library call's ms where there is one, and the
    shapes."""
    import torch
    import torch.nn.functional as F

    from sfm_tpu_torch.ops import compact, detect, match, sample
    from sfm_tpu_torch.ops import pyramid as pyr
    from sfm_tpu_torch.sift import describe, frontend, pyramid
    from sfm_tpu_torch.utils.precision import f32_precision

    rec = {}

    def add(name, *args, **kwargs):
        rec[name] = kernel_record(name, *args, **kwargs)

    def err(a, b):
        return float((a - b).abs().max())

    # K7, then the base chain.
    base0 = img1
    if sc.up_scale:
        base0 = pyr.scale_up(img1)
        e7 = max(err(base0, pyr.scale_up_plain(img1)),
                 err(pyr.scale_up(img2), pyr.scale_up_plain(img2)))
        gates.check(tuple(base0.shape) == (2 * img1.shape[0], 2 * img1.shape[1]),
                    f"{where}: K7 shape {tuple(base0.shape)}")
        gates.check(e7 <= 1e-4, f"{where}: K7 max err {e7}")
        n_in = img1.numel()
        add("scale_up", e7, lambda: pyr.scale_up(img1), lambda: pyr.scale_up_plain(img1),
            f"{tuple(img1.shape)} -> {tuple(base0.shape)} f32, both images",
            4 * (n_in + 4 * n_in), 8 * n_in,
            lib_fn=lambda: F.interpolate(img1[None, None], scale_factor=2,
                                         mode="bilinear", align_corners=False))
    # K1 + K2: the base chain in one launch, bit for bit the plain chain.
    lp, sd = pyramid.chain_taps(sc.lowpass_radius, sc.init_blur)
    L = sc.num_octaves
    chain, n_diff, e12 = hold_chain(base0, lp, sd, L, gates, where)
    H, W = base0.shape
    shapes = [tuple(b.shape) for b in chain]
    conv1, conv2 = _conv(lp, 1, base0.device), _conv(sd, 2, base0.device)

    def chain_conv():
        b = conv1(base0[None, None])
        for _ in range(L - 1):
            b = conv2(b)
        return b

    # Bytes: the source read once, every level written once.  Operations:
    # K1's column and row passes (a multiply and an add per tap), then
    # per descent [h, w] -> [h/2, w/2] the 5 vertical taps on the kept
    # rows at full width and the 5 horizontal taps on the kept columns.
    desc_in = shapes[:-1]
    add("base_chain", e12,
        lambda: pyr.base_chain(base0, lp, sd, L),
        lambda: pyr.base_chain_plain(base0, lp, sd, L),
        f"{H}x{W} f32, {len(lp)} prefilter taps, {L} levels {shapes} (one image)",
        4 * (H * W + sum(h * w for h, w in shapes)),
        4 * len(lp) * H * W
        + sum(10 * (h // 2) * w + 10 * (h // 2) * (w // 2) for h, w in desc_in))
    rec["base_chain"]["values_differing"] = n_diff
    # No single PyTorch call computes the chain (library_ms stays null):
    # its yardstick is the composed Conv2d 9x9 and L - 1 strided 5x5.
    with f32_precision():
        rec["base_chain"]["composed_conv_ms"] = cuda_ms(chain_conv)

    # K3 on the octave bases: one launch for all of them, as the path
    # runs it, equal bit for bit to one launch per octave.
    bases = pyramid.base_chain(img1, sc)
    taps = frontend._tap_banks(sc)   # [octaves, planes, 9], as the path passes them
    multi = detect.detect_maps_octaves(bases, taps, sc.thresh, sc.edge_limit)
    mism, n_cand, e3, per_octave_diff = 0, 0, 0.0, 0
    for (rk, ak), b, tp in zip(multi, bases, taps):
        rs, as_ = detect.detect_maps(b, tp, sc.thresh, sc.edge_limit)
        per_octave_diff += int((rk != rs).sum()) + int((ak != as_).sum())
        rp, ap = detect.detect_maps_plain(b, tp, sc.thresh, sc.edge_limit)
        ck, cp = rk > 0, rp > 0
        mism += int((ck != cp).sum())
        n_cand += int(cp.sum())
        both = ck & cp
        if both.any():
            e3 = max(e3, float((rk - rp)[both].abs().max()),
                     float((ak - ap)[:, both].abs().max()))
    gates.check(n_cand > 1000, f"{where}: K3 only {n_cand} candidates")
    gates.check(mism <= max(2, 0.001 * n_cand), f"{where}: K3 {mism} mismatched pixels")
    gates.check(e3 <= 1e-4, f"{where}: K3 max err {e3}")
    gates.check(per_octave_diff == 0, f"{where}: K3's one launch differs from its "
                f"per-octave launches in {per_octave_diff} values")
    # Per pixel: the separable blur bank, the DoG differences and the
    # 26-neighbour test on each interior DoG plane; out: resp + 11 aux.
    n_px = sum(b.numel() for b in bases)
    _, planes, ntap = taps.shape
    add("detect_maps", e3,
        lambda: detect.detect_maps_octaves(bases, taps, sc.thresh, sc.edge_limit),
        lambda: [detect.detect_maps_plain(b, tp, sc.thresh, sc.edge_limit)
                 for b, tp in zip(bases, taps)],
        f"{len(bases)} octave bases of {H}x{W} (one image, one launch)",
        4 * n_px * (1 + 12),
        n_px * (4 * planes * ntap + (planes - 1) + 26 * (planes - 3)),
        plain_reps=5)
    # K3's gated mode, as lowest_scale=1.0 runs it (octave o gated at
    # 1 / 2**o), and at gate 0 with lean=False; timed at the former.
    # Out: resp + 6 maps.
    _, subs = frontend.atlas_layout(tuple(img1.shape), sc)
    lowest = [1.0 / sub for sub in subs]
    held_g = {"lowest_scale_1": hold_gated_k3(bases, taps, sc, lowest, gates, where),
              "gate_0": hold_gated_k3(bases, taps, sc, [0.0] * len(bases), gates,
                                      where)}
    g_rec = kernel_record(
        "detect_maps", max(h["max_abs_err"] for h in held_g.values()),
        lambda: detect.detect_maps_octaves(bases, taps, sc.thresh, sc.edge_limit,
                                           lowest, lean=False),
        lambda: [detect.detect_maps_plain(b, tp, sc.thresh, sc.edge_limit, g,
                                          lean=False)
                 for b, tp, g in zip(bases, taps, lowest)],
        f"{len(bases)} octave bases of {H}x{W}, gates {lowest}", 4 * n_px * (1 + 7),
        n_px * (4 * planes * ntap + (planes - 1) + 26 * (planes - 3))
        + GATED_SOLVE_OPS * held_g["lowest_scale_1"]["candidates"], plain_reps=5)
    rec["detect_maps"]["gated"] = {
        **{k: g_rec[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                 "bound_ms", "bound_by", "bytes", "ops", "shapes")},
        **held_g}

    # K4, K8 and K9 on the capped sample slots of the path's detect stage.
    atlas, dets = frontend.detect_stage(img1, sc)
    x = torch.cat([d.x for d in dets])
    y = torch.cat([d.y for d in dets])
    s = torch.cat([d.scale for d in dets])
    v = torch.cat([d.valid for d in dets])
    sharp = torch.cat([d.sharpness for d in dets])
    n_slots = min(sc.sample_cap, x.shape[0]) if sc.sample_cap else x.shape[0]
    order = frontend._sample_order(v, sharp, sc.sample_cap, [d.x.shape[0] for d in dets])
    x, y, s, v = x[order], y[order], s[order], v[order]
    count = v.sum().to(torch.int32)
    K = x.shape[0]
    d1k, o1k, o2k, dk = sample.fused_orient_descriptor(atlas, x, y, s, count)
    d1p, o1p, o2p, dp = sample.fused_orient_descriptor_plain(atlas, x, y, s, count)
    n = int(count)

    def rows_agree(d1a, o1a, d1b, o1b):
        row = (describe.normalize_descriptors(d1a) - describe.normalize_descriptors(d1b)
               ).abs().amax(dim=1)[:n]
        ori = ((o1a - o1b + 180.0) % 360.0 - 180.0).abs()[:n]
        return float(((row <= 1e-3) & (ori <= 0.01)).float().mean()), float(row.max())

    frac, e4 = rows_agree(d1k, o1k, d1p, o1p)
    dup_agree = float((dk == dp)[:n].float().mean())
    gates.check(K == n_slots, f"{where}: K4 {K} slots, not {n_slots}")
    gates.check(frac >= 0.995, f"{where}: K4 only {frac:.4f} of rows agree")
    gates.check(dup_agree >= 0.995, f"{where}: K4 dup agreement {dup_agree:.4f}")
    gates.check(not bool(d1k[n:].any()), f"{where}: K4 rows >= count not zero")
    # Bytes: the live keypoints' inputs and patches, every slot's outputs.
    fused_bytes = patch_bytes(atlas, n, 40) + 3 * 4 * n + K * (128 * 4 + 4 + 4 + 1)
    fused_ops = n * (ORI_OPS + PEAK_OPS + DESC_OPS)
    add("fused_orient_descriptor", e4,
        lambda: sample.fused_orient_descriptor(atlas, x, y, s, count),
        lambda: sample.fused_orient_descriptor_plain(atlas, x, y, s, count),
        f"{K} slots, {n} live, atlas {tuple(atlas.shape)}", fused_bytes, fused_ops,
        plain_reps=5)

    # K9: K4's outputs bit for bit, and K4's plain version at K4's gates.
    d1w, o1w, o2w, dw = sample.fused_orient_descriptor_win(atlas, x, y, s, count)
    e9k = max(err(d1w, d1k), err(o1w, o1k), err(o2w, o2k))
    frac9, e9 = rows_agree(d1w, o1w, d1p, o1p)
    gates.check(e9k == 0.0 and bool((dw == dk).all()),
                f"{where}: K9 differs from K4 by {e9k}")
    gates.check(frac9 >= 0.995, f"{where}: K9 only {frac9:.4f} of rows agree")
    add("fused_orient_descriptor_win", e9,
        lambda: sample.fused_orient_descriptor_win(atlas, x, y, s, count),
        lambda: sample.fused_orient_descriptor_plain(atlas, x, y, s, count),
        f"{K} slots, {n} live, atlas {tuple(atlas.shape)}", fused_bytes, fused_ops,
        plain_reps=5)

    # K5 at K4's own orientations: K4's descriptors bit for bit (one warp
    # device function computes both).
    r5k4 = sample.descriptor_sample(atlas, x, y, s, o1k, count)
    e5k4 = err(r5k4, d1k)
    gates.check(torch.equal(r5k4, d1k), f"{where}: K5 at K4's ori1 differs from "
                f"K4's d1 by {e5k4}")

    # K8: raw histograms on the 16-column patch.
    e8, h8max = hold_orientation_kernel(atlas, x, y, s, count, gates, where)
    add("orientation_histogram_sample", e8,
        lambda: sample.orientation_histogram_sample(atlas, x, y, s, count),
        lambda: sample.orientation_histogram_sample_plain(atlas, x, y, s, count),
        f"{K} slots, {n} live, atlas {tuple(atlas.shape)}",
        patch_bytes(atlas, n, 16) + 3 * 4 * n + K * 32 * 4, n * ORI_OPS, plain_reps=5)

    # K5 on the duplicate subset.
    v2 = dk & v
    od = compact.compaction_order(v2)
    xd, yd, sd2, od2 = x[od], y[od], s[od], o2k[od]
    c2 = v2.sum().to(torch.int32)
    rk5 = sample.descriptor_sample(atlas, xd, yd, sd2, od2, c2)
    rp5 = sample.descriptor_sample_plain(atlas, xd, yd, sd2, od2, c2)
    n2 = int(c2)
    e5 = float((describe.normalize_descriptors(rk5)
                - describe.normalize_descriptors(rp5)).abs().max())
    gates.check(n2 > 0, f"{where}: K5 no duplicates to sample")
    gates.check(e5 <= 1e-3, f"{where}: K5 max err {e5}")
    add("descriptor_sample", e5,
        lambda: sample.descriptor_sample(atlas, xd, yd, sd2, od2, c2),
        lambda: sample.descriptor_sample_plain(atlas, xd, yd, sd2, od2, c2),
        f"{K} slots, {n2} live",
        patch_bytes(atlas, n2, 40) + 4 * 4 * n2 + K * 128 * 4, n2 * DESC_OPS,
        plain_reps=5)

    # K6 on the path's descriptor sets of both images.
    if s1 is None:
        s1, s2 = frontend.extract_sift(img1, sc), frontend.extract_sift(img2, sc)
    a, b = s1.descriptors, s2.descriptors
    va = s2.keypoints.valid
    bk, sk, ik = match.match_top2(a, b, va)
    bp, sp, ip = match.match_top2_plain(a, b, va)
    live = s1.keypoints.valid
    agree = float((ik == ip)[live].float().mean())
    e6 = max(float((bk - bp).abs().max()), float((sk - sp).abs().max()))
    gates.check(a.shape[0] == 2 * n_slots, f"{where}: K6 {a.shape[0]} rows")
    gates.check(agree >= 0.999, f"{where}: K6 argmax agreement {agree}")
    gates.check(e6 <= 1e-4, f"{where}: K6 max err {e6}")
    n1r, n2r = a.shape[0], b.shape[0]
    add("match_top2", e6, lambda: match.match_top2(a, b, va),
        lambda: match.match_top2_plain(a, b, va),
        f"{n1r}x{n2r}x128 bf16, {int(live.sum())} live rows",
        2 * 128 * (n1r + n2r) + n2r + 12 * n1r, 2.0 * n1r * n2r * 128, peak=BF16_FLOPS)
    # The unfused two-call form: the score matrix through device memory.
    ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
    rec["match_top2"]["unfused_topk_ms"] = cuda_ms(lambda: torch.topk(ab @ bb.T, 2))
    del ab, bb
    torch.cuda.synchronize()
    e7_txt = f"K7 {rec['scale_up']['max_abs_err']:.3g}, " if sc.up_scale else ""
    log(f"{where}, kernels against their plain versions: {e7_txt}base chain "
        f"{shapes}: {n_diff} values differ (expected 0); K3 "
        f"candidates {n_cand}, mismatched pixels {mism}, max |err| {e3:.3g} "
        f"(tolerance <= max(2, 0.1%), 1e-4), one launch vs per octave "
        f"{per_octave_diff} values differ (expected 0); K3 gated vs plain at "
        f"lowest_scale=1 / gate 0: candidates {held_g['lowest_scale_1']['candidates']}"
        f" / {held_g['gate_0']['candidates']}, values differing "
        f"{held_g['lowest_scale_1']['values_differing']} / "
        f"{held_g['gate_0']['values_differing']} (expected 0); K4 slots {K}, live {n}, "
        f"rows within 1e-3 and 0.01 deg {frac:.5f}, dup agreement {dup_agree:.5f}, "
        f"max |err| {e4:.3g} (>= 99.5%); K9 vs K4 max |err| {e9k:.3g} (expected "
        f"0), vs plain rows {frac9:.5f}, max |err| {e9:.3g}; K5 at K4's ori1 vs "
        f"K4's d1 max |err| {e5k4:.3g} (expected 0); K8 max |err| "
        f"{e8:.3g} of max |h| {h8max:.4g} (tolerance 1e-6 relative); "
        f"K5 duplicates {n2}, max |err| {e5:.3g} (1e-3); K6 {n1r} x {n2r} x 128, "
        f"argmax agreement {agree:.5f}, max |err| {e6:.3g} (>= 99.9%, 1e-4)")
    return rec


def hold_chain(img, lp, sd, levels, gates, where):
    """The base chain (one launch) against the plain chain: the level
    shapes ``[H >> o, W >> o]`` and 0 values differing; the standalone
    K1 and K2 (the kernel's one-phase cases) on its levels too.
    Returns (the chain's levels, values differing, max |err|)."""
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.ops import pyramid as pyr

    n0 = _cuda.LAUNCHES["base_chain"]
    chain = pyr.base_chain(img, lp, sd, levels)
    launches = _cuda.LAUNCHES["base_chain"] - n0
    ref = pyr.base_chain_plain(img, lp, sd, levels)
    H, W = img.shape
    shapes = [tuple(b.shape) for b in chain]
    gates.check(shapes == [(H >> o, W >> o) for o in range(levels)],
                f"{where}: base chain shapes {shapes}")
    gates.check(launches == 1, f"{where}: base chain took {launches} launches")
    pairs = list(zip(chain, ref)) + [(pyr.blur9(img, lp), ref[0])] + [
        (pyr.scale_down(a, sd), b) for a, b in zip(chain, chain[1:])]
    n_diff = sum(int((a != b).sum()) for a, b in pairs)
    err = max(float((a - b).abs().max()) for a, b in pairs)
    gates.check(n_diff == 0, f"{where}: the base chain differs from its plain "
                f"version in {n_diff} values (max |err| {err})")
    return chain, n_diff, err


def check_odd_scale_down(img, gates):
    """The base chain on the bench image cut to an odd 575 x 719 (5
    levels: [H//2**o, W//2**o], the floor at every step) and on its 9
    levels (down to 2 x 2), bit for bit the plain chain; the standalone
    K2 on the odd image too.  Returns {case: values differing}."""
    from sfm_tpu_torch.ops import pyramid as pyr
    from sfm_tpu_torch.sift import pyramid

    lp, sd = pyramid.chain_taps(4, 1.5)
    odd = img[:-1, :-1].contiguous()
    k = pyr.scale_down(odd, sd)
    gates.check(tuple(k.shape) == (odd.shape[0] // 2, odd.shape[1] // 2),
                f"K2: odd shape {tuple(k.shape)}")
    out = {"scale_down_odd": int((k != pyr.scale_down_plain(odd, sd)).sum()),
           "chain_odd_5": hold_chain(odd, lp, sd, 5, gates, "odd 575x719")[1],
           "chain_9_levels": hold_chain(img, lp, sd, 9, gates, "9 levels")[1]}
    gates.check(out["scale_down_odd"] == 0,
                f"K2 on odd {tuple(odd.shape)}: {out['scale_down_odd']} values differ")
    log(f"base chain on odd {tuple(odd.shape)} (5 levels) and on "
        f"{tuple(img.shape)} (9 levels), K2 alone on the odd image: values "
        f"differing {out} (expected 0)")
    return out


def hold_k3_planes(img, gates):
    """K3 past 13 planes (its run-time-plane route): the 5 octave bases
    of ``img`` at 14 and 19 planes (``num_scales`` 11 and 16), lean and
    gated (octave o at 1 / 2**o), one launch each, bit for bit the plain
    version; with the route's ms, device ms and bound."""
    from sfm_tpu_torch.config import SiftConfig
    from sfm_tpu_torch.ops import _cuda, detect
    from sfm_tpu_torch.sift import frontend, pyramid

    out = {}
    for S in (11, 16):
        cfg = SiftConfig(num_octaves=5, num_scales=S)
        bases = pyramid.base_chain(img, cfg)
        taps = frontend._tap_banks(cfg)
        n_px = sum(b.numel() for b in bases)
        for mode, scale_gates in (("lean", [0.0] * 5),
                                  ("gated", [1.0 / 2 ** o for o in range(5)])):
            lean = mode == "lean"
            n0 = _cuda.LAUNCHES["detect_maps"]
            multi = detect.detect_maps_octaves(bases, taps, cfg.thresh,
                                               cfg.edge_limit, scale_gates, lean)
            launches = _cuda.LAUNCHES["detect_maps"] - n0
            n_diff = n_cand = 0
            for (rk, ak), b, tp, g in zip(multi, bases, taps, scale_gates):
                rp, ap = detect.detect_maps_plain(b, tp, cfg.thresh, cfg.edge_limit,
                                                  g, lean)
                n_diff += int((rk != rp).sum()) + int((ak != ap).sum())
                n_cand += int((rp > 0).sum())

            def fn():
                return detect.detect_maps_octaves(bases, taps, cfg.thresh,
                                                  cfg.edge_limit, scale_gates, lean)

            P = S + 3
            b_ms, b_by = bound(4 * n_px * (1 + (12 if lean else 7)),
                               n_px * (4 * P * 9 + (P - 1) + 26 * (P - 3)))
            r = out[f"{P} planes {mode}"] = {
                "launches": launches, "candidates": n_cand, "values_differing": n_diff,
                "ms": cuda_ms(fn), "device_ms": device_ms(fn), "bound_ms": b_ms,
                "bound_by": b_by}
            gates.check(launches == 1, f"K3 at {P} planes ({mode}): {launches} launches")
            gates.check(n_cand > 100, f"K3 at {P} planes ({mode}): {n_cand} candidates")
            gates.check(n_diff == 0, f"K3 at {P} planes ({mode}): {n_diff} values "
                        f"differ from plain")
            log(f"K3 at {P} planes ({mode}) on the 5 octave bases of "
                f"{tuple(img.shape)}: {n_cand} candidates, {n_diff} values differ "
                f"from plain (expected 0); {r['ms']:.4f} ms, device "
                f"{r['device_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return out


def run_pairs(img1, img2, K, cfg, f, seeds, dev):
    """Drive the main path once per seed; per-seed quality and ms."""
    import torch

    from sfm_tpu_torch.models import two_view

    rows = []
    for seed in seeds:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = two_view.two_view_pipeline(img1, img2, K, gen, cfg)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rows.append({
            "seed": seed, "ms": ms, "matches": int(r.num_matches),
            "inliers": int(r.num_inliers), "valid": int(r.point_valid.sum()),
            "px": math.sqrt(max(float(r.reproj_err), 0.0) / 2.0) * f,
            "R": r.R.cpu().numpy(), "t": r.t.cpu().numpy(),
            "finite": bool(torch.isfinite(r.points).all()),
        })
    return rows


def median(rows, key):
    vals = sorted(r[key] for r in rows)
    m = len(vals) // 2
    return vals[m] if len(vals) % 2 else 0.5 * (vals[m - 1] + vals[m])


def gate_two_view(rows, ref, gates, where):
    """Per-seed pose bounds and median quality against a reference's
    medians; returns the medians."""
    for r in rows:
        gates.check(r["rot_deg"] <= MAX_ROT_DEG,
                    f"{where} seed {r['seed']}: rotation error {r['rot_deg']:.3f} deg")
        gates.check(r["tdir_deg"] <= MAX_TDIR_DEG,
                    f"{where} seed {r['seed']}: translation error "
                    f"{r['tdir_deg']:.3f} deg")
    med = {k: median(rows, k) for k in ("matches", "inliers", "valid", "px", "ms",
                                        "rot_deg", "tdir_deg")}
    log(f"{where} median: matches {med['matches']:.0f} inliers {med['inliers']:.0f} "
        f"valid {med['valid']:.0f} px {med['px']:.4f} rot {med['rot_deg']:.4f} "
        f"deg tdir {med['tdir_deg']:.4f} deg")
    for k in ("matches", "inliers", "valid"):
        gates.check(med[k] >= 0.9 * ref[k],
                    f"{where} median {k} {med[k]} < 90% of the JAX package's {ref[k]}")
    gates.check(med["px"] <= ref["px"] / 0.9,
                f"{where} median px {med['px']:.4f} > JAX {ref['px']} / 0.9")
    return med


def end_to_end(pair, cfg, gates, dev, card):
    """Phase 4: the port's bench path on the synthetic pair."""
    import torch

    from sfm_tpu_torch.ops import _cuda
    from synthetic_pair import pose_errors_deg

    img1 = torch.as_tensor(pair["img1"], device=dev)
    img2 = torch.as_tensor(pair["img2"], device=dev)
    K = torch.as_tensor(pair["K"], device=dev)
    f = float(pair["K"][0, 0])
    run_pairs(img1, img2, K, cfg, f, [0], dev)          # warm-up
    _cuda.reset_launches()
    rows = run_pairs(img1, img2, K, cfg, f, range(8), dev)
    launches = dict(_cuda.LAUNCHES)
    for r in rows:
        r["rot_deg"], r["tdir_deg"] = pose_errors_deg(r.pop("R"), r.pop("t"),
                                                      pair["R"], pair["t"])
        log(f"seed {r['seed']}: matches {r['matches']} inliers {r['inliers']} "
            f"valid {r['valid']} px {r['px']:.4f} rot {r['rot_deg']:.4f} deg "
            f"tdir {r['tdir_deg']:.4f} deg  {r['ms']:.1f} ms")
        gates.check(r["finite"], f"seed {r['seed']}: non-finite points")
    med = gate_two_view(rows, JAX_MEDIANS, gates, "bench path")
    log(f"ms/pair: median {med['ms']:.2f} (host clock around a synchronized "
        f"pair, 720x576, {card})")
    log(f"launches in the 8-pair run: {launches}")
    check_path_launches("bench", launches, gates)
    return launches, med, rows


def hold_refine(pair, cfg, gates, dev):
    """K10 on one bench pair's own inputs: the probe's call (8 starts x 6
    steps) and the first refine round's (1 start x 10 steps), captured
    from ``two_view_pipeline``.  Each against the plain route in float32
    and float64, as ``tests/test_torch_cuda.py`` holds it (K10's error
    to float64 within the plain f32 route's own plus 1e-4 relative in
    the costs, 5e-4 deg in R and 1.5e-3 in t: on this narrow field both
    f32 routes drift ~2e-4 deg in R and ~1e-3 in t, against 2e-3 in both
    on the tests' wide scenes); K10's CUDA-event and device ms,
    the plain route's host ms (a synchronized call on the host clock)
    and its device ms and launches (a profile), and a digest of K10's
    outputs.  Returns {"refine_relative_pose": the probe's record, with
    the round's under "rounds"}."""
    import hashlib
    import torch

    from synthetic_pair import pose_errors_deg
    from sfm_tpu_torch.geometry import refine
    from sfm_tpu_torch.models import two_view

    img1, img2, K = (torch.as_tensor(pair[k], device=dev) for k in ("img1", "img2", "K"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    with spy(refine, "refine_relative_pose") as calls:
        two_view.two_view_pipeline(img1, img2, K, gen, cfg)
    torch.cuda.synchronize()
    out = {}
    for where, (args, kwargs, _, _) in (("probe", calls[0]), ("rounds", calls[1])):
        R0, t0, x1, x2 = args
        w, iters = kwargs["weights"], kwargs["iters"]
        k_fn = lambda: refine.refine_relative_pose(R0, t0, x1, x2, weights=w, iters=iters)
        p_fn = lambda: refine.refine_relative_pose_plain(R0, t0, x1, x2, weights=w,
                                                         iters=iters)
        k, p = k_fn(), p_fn()
        p64 = refine.refine_relative_pose_plain(
            *(a.double() for a in (R0, t0, x1, x2)), weights=w.double(), iters=iters)
        err = {}
        for name in ("cost", "initial_cost"):
            e_k, e_p = ((getattr(r, name).double().cpu() - getattr(p64, name).cpu()).abs()
                        / getattr(p64, name).abs().cpu() for r in (k, p))
            err[name] = (float(e_k.max()), float(e_p.max()))
            gates.check(bool((e_k <= e_p + 1e-4).all()),
                        f"K10 {where}: {name} error {e_k.tolist()} past the plain "
                        f"route's {e_p.tolist()} + 1e-4")
        host = lambda r: (r.R.cpu().numpy().reshape(-1, 3, 3), r.t.cpu().numpy().reshape(-1, 3))
        for name, a_k, a_p, tol in zip(("rot_deg", "t_deg"),
                                       pose_errors_deg(*host(k), *host(p64)),
                                       pose_errors_deg(*host(p), *host(p64)), (5e-4, 1.5e-3)):
            err[name] = (float(a_k.max()), float(a_p.max()))
            gates.check(bool((a_k <= a_p + tol).all()),
                        f"K10 {where}: {name} to float64 {a_k.tolist()} past the plain "
                        f"route's {a_p.tolist()} + {tol}")
        B, n = R0.reshape(-1, 9).shape[0], x1.shape[0]
        t_host = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            p_fn()
            torch.cuda.synchronize()
            t_host.append((time.perf_counter() - t1) * 1e3)
        plain_launches, plain_dev = profile_launches(p_fn)
        shapes = f"B {B} x {iters} steps, N {n}"
        rec = kernel_record(
            "refine_relative_pose", max(float((k.R - p.R).abs().max()),
                                        float((k.t - p.t).abs().max())),
            k_fn, p_fn, shapes, n * (24 + 4 * (w.numel() // n)) + B * 4 * (2 * 12 + 11),
            B * n * (REFINE_STEP_OPS * iters + REFINE_START_OPS), plain_reps=3)
        rec.update(errors_vs_float64=err, plain_host_ms=sorted(t_host)[1],
                   plain_device_ms=plain_dev, plain_launches=plain_launches,
                   digest=hashlib.sha256(b"".join(v.cpu().numpy().tobytes() for v in k)
                                         ).hexdigest()[:16])
        log(f"K10 {where} ({shapes}): {rec['device_ms']:.4f} device ms, "
            f"{rec['ms']:.4f} ms; plain route {rec['plain_host_ms']:.1f} host ms, "
            f"{plain_dev:.3f} device ms in {plain_launches} launches; bound "
            f"{rec['bound_ms'] * 1e3:.3f} us ({rec['bound_by']}); errors to float64 "
            f"(K10, plain f32) {err}; digest {rec['digest']}")
        out[where] = rec
    rec = out["probe"]
    rec["rounds"] = out["rounds"]
    return {"refine_relative_pose": rec}


def hold_pnp_lo(call, gates, where):
    """K11 on one registered frame's own LO inputs (``call``: the args,
    kwargs and result of its ``pnp.pnp_lo`` call in ``run_incremental``)
    against the plain route in float32 and float64, as
    ``tests/test_torch_cuda.py`` holds it (K11's rotation error to
    float64 within the plain f32 route's own plus 1e-4 deg, its
    translation's relative error within the plain route's plus 5e-6,
    the strict counts within a row or 0.1%: on a real frame a row may
    sit at the threshold); K11's CUDA-event and device ms, the plain
    route's host ms (a synchronized call on the host clock), its device
    ms and launches (a profile), and a digest of K11's outputs."""
    import hashlib
    import torch

    from synthetic_pair import pose_errors_deg
    from sfm_tpu_torch.geometry import pnp

    args, kwargs, first, _ = call
    x, Xn, mask, R0, t0 = args
    k_fn = lambda: pnp.pnp_lo(*args, **kwargs)
    p_fn = lambda: pnp.pnp_lo_plain(*args, **kwargs)
    k, p = k_fn(), p_fn()
    p64 = pnp.pnp_lo_plain(x.double(), Xn.double(), mask, R0.double(), t0.double(), **kwargs)
    gates.check(all(torch.equal(a, b) for a, b in zip(k, first)),
                f"K11 {where}: a second call differs from the frame's own")
    host = lambda r: (r[0].cpu().numpy(), r[1].cpu().numpy())
    rot_k, _ = pose_errors_deg(*host(k), *host(p64))
    rot_p, _ = pose_errors_deg(*host(p), *host(p64))
    t_err = lambda r: float((r[1].double() - p64[1]).norm() / p64[1].norm())
    counts = tuple(int(r[3]) for r in (k, p, p64))
    err = {"rot_deg": (float(rot_k), float(rot_p)), "t_rel": (t_err(k), t_err(p)),
           "counts": counts}
    gates.check(rot_k <= rot_p + 1e-4, f"K11 {where}: rotation to float64 {rot_k} past the "
                f"plain route's {rot_p} + 1e-4 deg")
    gates.check(t_err(k) <= t_err(p) + 5e-6, f"K11 {where}: translation to float64 "
                f"{t_err(k)} past the plain route's {t_err(p)} + 5e-6")
    gates.check(abs(counts[0] - counts[1]) <= max(1, counts[1] // 1000),
                f"K11 {where}: strict counts (K11, plain f32, float64) {counts}")
    t_host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        p_fn()
        torch.cuda.synchronize()
        t_host.append((time.perf_counter() - t1) * 1e3)
    plain_launches, plain_dev = profile_launches(p_fn)
    n, iters = x.shape[0], kwargs["refine_iters"]
    shapes = f"N {n} ({int(mask.sum())} live), 3 rounds x 2 chains x {iters} steps"
    rec = kernel_record(
        "pnp_lo", max(float((k[0] - p[0]).abs().max()), float((k[1] - p[1]).abs().max())),
        k_fn, p_fn, shapes, n * (24 + 1 + 1) + 4 * (9 + 3 + 9 + 3 + 1), lo_ops(n, iters),
        plain_reps=3)
    rec.update(errors_vs_float64=err, plain_host_ms=sorted(t_host)[1],
               plain_device_ms=plain_dev, plain_launches=plain_launches,
               digest=hashlib.sha256(b"".join(v.cpu().numpy().tobytes() for v in k)
                                     ).hexdigest()[:16])
    log(f"K11 {where} ({shapes}): {rec['device_ms']:.4f} device ms, {rec['ms']:.4f} ms; "
        f"plain route {rec['plain_host_ms']:.1f} host ms, {plain_dev:.3f} device ms in "
        f"{plain_launches} launches; bound {rec['bound_ms'] * 1e3:.3f} us "
        f"({rec['bound_by']}); errors to float64 (K11, plain f32) {err}; digest "
        f"{rec['digest']}")
    return rec


class HFit(NamedTuple):
    H: "torch.Tensor"        # [3, 3], H[2, 2] = 1
    uv1: "torch.Tensor"      # [N, 2] keypoints of image 1
    uv2: "torch.Tensor"      # [N, 2] their argmax matches in image 2
    cand: "torch.Tensor"     # [N] bool: the fit's candidates
    numfit: int


def h_fit(s1, s2, m, generator, n_hyps: int = 8192) -> HFit:
    """tools/bench_upscale.py:116-134 on the port's extractions and
    matches: candidates with ambiguity < 0.8, ``ransac_homography`` at
    25 (px^2) over ``n_hyps`` hypotheses, 5 ``improve_homography``
    loops at 9, and numfit, the valid argmax matches within 3 px."""
    import torch

    from sfm_tpu_torch.geometry import homography

    kp1, kp2 = s1.keypoints, s2.keypoints
    uv1 = torch.stack([kp1.x, kp1.y], dim=-1)
    uv2 = torch.stack([kp2.x[m.index], kp2.y[m.index]], dim=-1)
    slot_ok = kp1.valid & kp2.valid[m.index]
    cand = slot_ok & (m.ambiguity < 0.80) & (m.score > 0.0)
    hres = homography.ransac_homography(uv1, uv2, cand, generator=generator,
                                        n_hyps=n_hyps, threshold=25.0,
                                        refit_iters=0)
    H = homography.improve_homography(hres.H, uv1, uv2, cand, loops=5,
                                      threshold=9.0)
    errs = homography.transfer_errors(H, uv1, uv2)
    return HFit(H, uv1, uv2, cand, int(((errs < 9.0) & slot_ok).sum()))


def upscale_run(rpair, cfg, dev, mcfg=None):
    """One up-scale run as bench_upscale drives it: warm-up, 6 timed
    extractions, then the counted run (launch counts set to 0 just
    before, read just after): extract x2, match (``mcfg``, else
    ``MatchConfig()``), H-fit.  Returns (result dict, s1, s2)."""
    import numpy as np
    import torch

    from sfm_tpu_torch.config import MatchConfig
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.sift import frontend
    from sfm_tpu_torch.sift import match as match_mod
    from synthetic_pair import homography_grid_errors, transfer_px

    img1 = torch.as_tensor(rpair["img1"], device=dev)
    img2 = torch.as_tensor(rpair["img2"], device=dev)
    frontend.extract_sift(img1, cfg)                     # warm-up
    times = []
    for _ in range(3):
        for img in (img1, img2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frontend.extract_sift(img, cfg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    _cuda.reset_launches()
    torch.cuda.synchronize()
    t = [time.perf_counter()]
    s1 = frontend.extract_sift(img1, cfg)
    s2 = frontend.extract_sift(img2, cfg)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    m = match_mod.match(s1.descriptors, s2.descriptors, s1.keypoints.valid,
                        s2.keypoints.valid, mcfg or MatchConfig())
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    fit = h_fit(s1, s2, m, gen)
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    launches = dict(_cuda.LAUNCHES)
    cand = fit.cand.cpu().numpy()
    # Candidates that the exact homography places > 3 px from their match.
    true_err = transfer_px(rpair["H_gt"], fit.uv1.cpu().numpy(), fit.uv2.cpu().numpy())
    h, w = rpair["img1"].shape
    grid = homography_grid_errors(fit.H.cpu().numpy(), rpair["H_gt"], h, w)
    res = {"n1": int(s1.keypoints.valid.sum()), "n2": int(s2.keypoints.valid.sum()),
           "matches": int(m.valid.sum()), "candidates": int(cand.sum()),
           "wrong_candidates": int((cand & (true_err > 3.0)).sum()),
           "numfit": fit.numfit,
           "h_median_px": float(np.median(grid)), "h_max_px": float(grid.max()),
           "extract_ms_per_image": float(np.median(times)),
           "stage_ms": {k: (b - a) * 1e3 for k, a, b in
                        zip(("extract_x2", "match", "h_fit"), t, t[1:])},
           "launches": launches, "finite": bool(torch.isfinite(fit.H).all())}
    return res, s1, s2


def _log_upscale(res, rpair, card, where):
    h, w = rpair["img1"].shape
    st = res["stage_ms"]
    log(f"{where} {w}x{h} -> {2 * w}x{2 * h}: features {res['n1']} / {res['n2']}, "
        f"ratio-test matches {res['matches']}, H-fit candidates {res['candidates']} "
        f"({res['wrong_candidates']} > 3 px off H_gt), H-fit {res['numfit']}; H vs "
        f"H_gt on a 16x12 grid: median {res['h_median_px']:.4f} px, max "
        f"{res['h_max_px']:.4f} px")
    log(f"{where} extraction: {res['extract_ms_per_image']:.2f} ms/image "
        f"(median of 6, host clock around a synchronized call, {card}); "
        f"in the counted run: extract x2 {st['extract_x2']:.1f} ms, "
        f"match {st['match']:.1f} ms, H-fit {st['h_fit']:.1f} ms")
    log(f"launches in the {where} run: {res['launches']}")


def upscale_path(rpair, gates, dev, card):
    """Phase 5: up_t2.0 extraction -> matching -> H-fit on the rotation
    pair, then every kernel of that run against its plain version at
    the run's shapes.  Returns (result, kernel records)."""
    import torch

    cfg = upscale_config()
    res, s1, s2 = upscale_run(rpair, cfg, dev)
    _log_upscale(res, rpair, card, "up-scale")
    gates.check(res["finite"], "up-scale: non-finite H")
    for k in ("n1", "n2", "candidates", "numfit"):
        gates.check(res[k] >= 0.9 * JAX_UPSCALE[k],
                    f"up-scale {k} {res[k]} < 90% of the JAX package's "
                    f"{JAX_UPSCALE[k]}")
    gates.check(res["h_median_px"] <= MAX_H_MEDIAN_PX,
                f"up-scale H median error {res['h_median_px']:.4f} px")
    gates.check(res["h_max_px"] <= MAX_H_MAX_PX,
                f"up-scale H max error {res['h_max_px']:.4f} px")
    check_path_launches("upscale", res["launches"], gates)
    # The counted run's inputs at its own shapes, after the counts were read.
    img1 = torch.as_tensor(rpair["img1"], device=dev)
    img2 = torch.as_tensor(rpair["img2"], device=dev)
    kernels = hold_kernels(img1, img2, cfg, gates, "up-scale path", s1, s2)
    return res, kernels


def upscale_lowest_path(rpair, ref, gates, dev, card):
    """Phase 5, second run: the up-scale path with ``lowest_scale=1.0``
    (K3's gated mode, octave o gated at 1 / 2**o), gated against the
    JAX package's numbers at the same configuration; the gate must
    remove features against the ungated run ``ref``."""
    import dataclasses

    cfg = dataclasses.replace(upscale_config(), lowest_scale=1.0)
    res, _, _ = upscale_run(rpair, cfg, dev)
    _log_upscale(res, rpair, card, "up-scale lowest_scale=1.0")
    gates.check(res["finite"], "up-scale lowest_scale=1.0: non-finite H")
    for k in ("n1", "n2", "candidates", "numfit"):
        gates.check(res[k] >= 0.9 * JAX_UPSCALE_LOWEST[k],
                    f"up-scale lowest_scale=1.0 {k} {res[k]} < 90% of the JAX "
                    f"package's {JAX_UPSCALE_LOWEST[k]}")
    gates.check(res["h_median_px"] <= MAX_H_MEDIAN_PX,
                f"up-scale lowest_scale=1.0 H median error {res['h_median_px']:.4f} px")
    gates.check(res["h_max_px"] <= MAX_H_MAX_PX,
                f"up-scale lowest_scale=1.0 H max error {res['h_max_px']:.4f} px")
    gates.check(res["n1"] + res["n2"] < ref["n1"] + ref["n2"],
                f"up-scale lowest_scale=1.0: features {res['n1']} / {res['n2']}, "
                f"not fewer than the ungated {ref['n1']} / {ref['n2']}")
    check_path_launches("upscale_lowest", res["launches"], gates)
    return res


def upscale_window_path(rpair, ref, gates, dev, card):
    """Phase 7: the up-scale path with ``sample_window=True`` (K9 in
    place of K4); the same features, matches, H-fit and H error as the
    K4 run ``ref``."""
    import dataclasses

    cfg = dataclasses.replace(upscale_config(), sample_window=True)
    res, _, _ = upscale_run(rpair, cfg, dev)
    _log_upscale(res, rpair, card, "up-scale sample_window=True")
    for k in ("n1", "n2", "matches", "candidates", "wrong_candidates", "numfit",
              "h_median_px", "h_max_px"):
        gates.check(res[k] == ref[k], f"up-scale sample_window=True: {k} "
                    f"{res[k]} != the K4 run's {ref[k]}")
    check_path_launches("upscale_window", res["launches"], gates)
    gates.check(res["launches"]["fused_orient_descriptor"] == 0,
                "up-scale sample_window=True went through K4")
    return res


def module_api(img, sc, gates, dev):
    """Phase 6: ``assign_orientations`` (K8) and ``extract_descriptors
    (valid=...)`` (K5) on the atlas and every detection slot of a real
    ``detect_stage``, against K4 and K5 on the same keypoints.  Then K8
    and K5 against their plain versions on the inputs this phase gave
    them (every slot, compacted valid-first).  Returns (result,
    launches, {kernel name: record})."""
    import torch

    from sfm_tpu_torch.ops import _cuda, compact, sample
    from sfm_tpu_torch.sift import describe, frontend, orient

    _cuda.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    atlas, dets = frontend.detect_stage(img, sc)
    x, y, s, v = (torch.cat([getattr(d, f) for d in dets])
                  for f in ("x", "y", "scale", "valid"))
    o1, o2, v2 = orient.assign_orientations(atlas, x, y, s, v, use_pallas=True)
    da = describe.extract_descriptors(atlas, x, y, s, o1, valid=v, use_pallas=True)
    db = describe.extract_descriptors(atlas, x, y, s, o2, valid=v2, use_pallas=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_cuda.LAUNCHES)
    # K4 on the same keypoints compacted valid-first, K5 on its
    # duplicates, both scattered back to the slots.
    order = compact.compaction_order(v)
    count = v.sum().to(torch.int32)
    d1c, k1c, k2c, kdc = sample.fused_orient_descriptor(
        atlas, x[order], y[order], s[order], count)
    d1, k1, k2 = torch.empty_like(d1c), torch.empty_like(k1c), torch.empty_like(k2c)
    kd = torch.empty_like(kdc)
    d1[order], k1[order], k2[order], kd[order] = d1c, k1c, k2c, kdc
    kd = kd & v
    od = compact.compaction_order(kd)
    d2 = torch.zeros_like(d1)
    d2[od] = sample.descriptor_sample(atlas, x[od], y[od], s[od], k2[od],
                                      kd.sum().to(torch.int32))

    # K8 and K5 as the module API launched them, against their plain
    # versions: K8 is timed and bounded at these shapes.
    xc, yc, scc, o1c = x[order], y[order], s[order], o1[order]
    e8, h8max = hold_orientation_kernel(atlas, xc, yc, scc, count, gates, "module API")
    K = x.shape[0]
    n_live = int(count)
    held = {"orientation_histogram_sample": kernel_record(
        "orientation_histogram_sample", e8,
        lambda: sample.orientation_histogram_sample(atlas, xc, yc, scc, count),
        lambda: sample.orientation_histogram_sample_plain(atlas, xc, yc, scc, count),
        f"{K} slots, {n_live} live, atlas {tuple(atlas.shape)}",
        patch_bytes(atlas, n_live, 16) + 3 * 4 * n_live + K * 32 * 4,
        n_live * ORI_OPS, plain_reps=5)}
    r5k = sample.descriptor_sample(atlas, xc, yc, scc, o1c, count)
    r5p = sample.descriptor_sample_plain(atlas, xc, yc, scc, o1c, count)
    e5 = float((describe.normalize_descriptors(r5k)
                - describe.normalize_descriptors(r5p)).abs().max())
    gates.check(e5 <= 1e-3, f"module API: K5 max err {e5}")
    gates.check(not bool(r5k[n_live:].any()), "module API: K5 rows >= count not zero")
    held["descriptor_sample"] = {"max_abs_err": e5}
    log(f"module API, kernels against their plain versions on {K} compacted "
        f"slots ({n_live} live): K8 max |err| {e8:.3g} of max |h| {h8max:.4g} "
        f"(tolerance 1e-6 relative), K5 max |err| {e5:.3g} (1e-3)")

    def ang(a, b):
        return ((a - b + 180.0) % 360.0 - 180.0).abs()

    ori_ok = (ang(o1, k1) <= 0.1) & (~kd | (ang(o2, k2) <= 0.1))
    frac_ori = float(ori_ok[v].float().mean())
    v2_agree = float((v2 == kd)[v].float().mean())
    dot1 = (da * describe.normalize_descriptors(d1)).sum(1)[v]
    both = v2 & kd
    dot2 = (db * describe.normalize_descriptors(d2)).sum(1)[both]
    frac_d1 = float((dot1 > 0.999).float().mean())
    frac_d2 = float((dot2 > 0.999).float().mean())
    n_dup = int(both.sum())
    log(f"module API on {x.shape[0]} detection slots ({n_live} live, atlas "
        f"{tuple(atlas.shape)}): orientations within 0.1 deg of K4's {frac_ori:.5f}, "
        f"valid2 = K4's dup on {v2_agree:.5f}, descriptor dot > 0.999 with K4's "
        f"{frac_d1:.5f} and with K5's on {n_dup} duplicates {frac_d2:.5f} "
        f"(gates >= 0.99); {ms:.1f} ms with detection")
    log(f"launches in the module-API run: {launches}")
    gates.check(n_live > 1000, f"module API: only {n_live} live keypoints")
    gates.check(n_dup > 0, "module API: no duplicates")
    gates.check(frac_ori >= 0.99, f"module API: orientations agree on {frac_ori:.4f}")
    gates.check(v2_agree >= 0.99, f"module API: valid2 agrees on {v2_agree:.4f}")
    gates.check(frac_d1 >= 0.99, f"module API: descriptors agree on {frac_d1:.4f}")
    gates.check(frac_d2 >= 0.99, f"module API: duplicates agree on {frac_d2:.4f}")
    check_path_launches("module_api", launches, gates)
    return {"slots": x.shape[0], "live": n_live, "duplicates": n_dup,
            "orientation_agreement": frac_ori, "valid2_agreement": v2_agree,
            "descriptor_agreement": frac_d1, "duplicate_agreement": frac_d2,
            "ms": ms}, launches, held


def _ply_vertices(path) -> int:
    with open(path, "rb") as fh:
        head = fh.read(4096).split(b"end_header")[0].decode()
    return int(next(line.split()[2] for line in head.splitlines()
                    if line.startswith("element vertex")))


def cli_phase(pair, rpair, gates, dev, card):
    """Phase 8: ``python -m sfm_tpu_torch`` in-process on PGMs of the
    synthetic pair (reconstruct, 8 seeds) and of the rotation pair
    (sift --up-scale --homography), then ``run_two_view`` at
    ``PipelineConfig()``.  Returns (result, launches of the CLI runs)."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from sfm_tpu_torch import cli
    from sfm_tpu_torch.config import PipelineConfig, SiftConfig
    from sfm_tpu_torch.models import two_view
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.sift import frontend
    from synthetic_pair import homography_grid_errors, pose_errors_deg, write_pgm

    rows = []
    with tempfile.TemporaryDirectory() as d:
        a, b, ra, rb = (os.path.join(d, n) for n in ("a.pgm", "b.pgm", "ra.pgm",
                                                     "rb.pgm"))
        for path, img in ((a, pair["img1"]), (b, pair["img2"]),
                          (ra, rpair["img1"]), (rb, rpair["img2"])):
            write_pgm(path, img)
        _cuda.reset_launches()
        for seed in range(8):
            ply, js = os.path.join(d, f"c{seed}.ply"), os.path.join(d, f"m{seed}.json")
            with contextlib.redirect_stdout(io.StringIO()):   # the metrics JSON
                rc = cli.main(["reconstruct", a, b, "--focal", "792", "--out", ply,
                               "--metrics", js, "--seed", str(seed)])
            with open(js) as fh:
                m = json.load(fh)
            rot, tdir = pose_errors_deg(np.array(m["R"]), np.array(m["t"]),
                                        pair["R"], pair["t"])
            rows.append({"seed": seed, "rc": rc, "matches": m["num_matches"],
                         "inliers": m["num_inliers"], "valid": m["num_points"],
                         "px": m["mean_reproj_px"], "rot_deg": rot, "tdir_deg": tdir,
                         "ms": m["stage_times"]["pipeline"]["total_ms"],
                         "ply_vertices": _ply_vertices(ply), "device": m["device"]})
        sj = os.path.join(d, "sift.json")
        with contextlib.redirect_stdout(io.StringIO()):
            rc_sift = cli.main(["sift", ra, rb, "--up-scale", "--homography",
                                "--metrics", sj, "--out", os.path.join(d, "f.npz")])
        more = {}
        for name, (extra, _) in JAX_CLI_SIFT.items():
            js = os.path.join(d, f"sift_{name}.json")
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(["sift", ra, rb, *extra, "--homography", "--metrics", js])
            with open(js) as fh:
                more[name] = (rc, json.load(fh))
        launches = dict(_cuda.LAUNCHES)
        with open(sj) as fh:
            sm = json.load(fh)
        with np.load(os.path.join(d, "f.npz")) as npz:
            npz_rows = [npz[f"descriptors{i}"].shape[0] for i in (0, 1)]
    for r in rows:
        log(f"cli seed {r['seed']}: matches {r['matches']} inliers {r['inliers']} "
            f"valid {r['valid']} px {r['px']:.4f} rot {r['rot_deg']:.4f} deg tdir "
            f"{r['tdir_deg']:.4f} deg  {r['ms']:.1f} ms  (PLY {r['ply_vertices']} "
            f"vertices)")
        gates.check(r["rc"] == 0, f"cli seed {r['seed']}: exit code {r['rc']}")
        gates.check(r["ply_vertices"] == r["valid"],
                    f"cli seed {r['seed']}: PLY holds {r['ply_vertices']} vertices, "
                    f"num_points {r['valid']}")
        gates.check(r["device"] == torch.cuda.get_device_name(0),
                    f"cli seed {r['seed']}: ran on {r['device']}")
    med = gate_two_view(rows, JAX_CLI_MEDIANS, gates, "cli reconstruct")
    log(f"cli reconstruct ms/pair (translation re-vote on): median {med['ms']:.2f} "
        f"(the CLI's pipeline stage: host clock around a synchronized "
        f"run_two_view, 720x576, {card})")
    # The sift demo's features against the port's own extraction at the
    # CLI's configuration on the unquantized pair: the CLI keeps the
    # default sample_cap (2,560 slots, so at most 5,120 features), where
    # phase 5's up_t2.0 config keeps 16,384.
    scfg = SiftConfig(num_octaves=5, thresh=2.0, max_pts_per_octave=2048,
                      up_scale=True)
    ref = [int(frontend.extract_sift(torch.as_tensor(rpair[k], device=dev),
                                     scfg).keypoints.valid.sum())
           for k in ("img1", "img2")]
    h, w = rpair["img1"].shape
    grid = homography_grid_errors(np.array(sm["H"]), rpair["H_gt"], h, w)
    sift_res = {"features": sm["features"], "reference_features": ref,
                "matches": sm["num_matches"], "homography_inliers":
                sm["homography_inliers"], "h_median_px": float(np.median(grid)),
                "h_max_px": float(grid.max()), "npz_rows": npz_rows}
    log(f"cli sift --up-scale --homography on the rotation pair's PGMs: features "
        f"{sm['features']} (float pair at the CLI's config: {ref}), matches "
        f"{sm['num_matches']}, homography inliers {sm['homography_inliers']}, H vs "
        f"H_gt median {sift_res['h_median_px']:.4f} px, max "
        f"{sift_res['h_max_px']:.4f} px")
    gates.check(rc_sift == 0, f"cli sift: exit code {rc_sift}")
    for i in (0, 1):
        gates.check(sm["features"][i] >= 0.9 * ref[i],
                    f"cli sift: features {sm['features'][i]} < 90% of {ref[i]}")
        gates.check(npz_rows[i] == sm["features"][i], "cli sift: npz rows")
    gates.check(sm["homography_inliers"] >= 0.5 * sm["num_matches"] > 0,
                "cli sift: homography inliers")
    gates.check(sift_res["h_median_px"] <= MAX_CLI_H_MEDIAN_PX,
                f"cli sift: H median error {sift_res['h_median_px']:.4f} px")
    # Past 16,384 detection slots and past 8 octaves, against the JAX CLI.
    sift_more = {}
    for name, (rc, m) in more.items():
        jref = JAX_CLI_SIFT[name][1]
        grid = homography_grid_errors(np.array(m["H"]), rpair["H_gt"], h, w)
        r = sift_more[name] = {
            "rc": rc, "features": m["features"], "jax_features": list(jref),
            "matches": m["num_matches"], "homography_inliers": m["homography_inliers"],
            "h_median_px": float(np.median(grid)), "h_max_px": float(grid.max()),
            "extract_ms": m["stage_times"]["extract"]["total_ms"]}
        opts = " ".join(JAX_CLI_SIFT[name][0])
        log(f"cli sift {opts} --homography on the rotation pair's PGMs: features "
            f"{r['features']} (JAX CLI {list(jref)}), matches {r['matches']}, "
            f"homography inliers {r['homography_inliers']}, H vs H_gt median "
            f"{r['h_median_px']:.4f} px, max {r['h_max_px']:.4f} px, extraction of "
            f"both {r['extract_ms']:.1f} ms")
        gates.check(rc == 0, f"cli sift {opts}: exit code {rc}")
        for i in (0, 1):
            gates.check(r["features"][i] >= 0.9 * jref[i],
                        f"cli sift {opts}: features {r['features'][i]} < 90% of the "
                        f"JAX CLI's {jref[i]}")
        gates.check(r["h_median_px"] <= MAX_CLI_H_MEDIAN_PX,
                    f"cli sift {opts}: H median error {r['h_median_px']:.4f} px")
    sift_res["more"] = sift_more
    log(f"launches in the CLI runs: {launches}")
    check_path_launches("cli", launches, gates)
    # The package default as it stands (4,096 hypotheses at 1e-6).
    imgs = [torch.as_tensor(pair[k], device=dev) for k in ("img1", "img2", "K")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = two_view.run_two_view(*imgs, PipelineConfig(), seed=0)
    torch.cuda.synchronize()
    dflt = {"seed": 0, "ms": (time.perf_counter() - t0) * 1e3,
            "matches": int(r.num_matches), "inliers": int(r.num_inliers),
            "valid": int(r.point_valid.sum()),
            "px": math.sqrt(max(float(r.reproj_err), 0.0) / 2.0) * float(pair["K"][0, 0]),
            "finite": bool(torch.isfinite(r.points).all())}
    dflt["rot_deg"], dflt["tdir_deg"] = pose_errors_deg(
        r.R.cpu().numpy(), r.t.cpu().numpy(), pair["R"], pair["t"])
    log(f"run_two_view at PipelineConfig(): matches {dflt['matches']} inliers "
        f"{dflt['inliers']} valid {dflt['valid']} px {dflt['px']:.4f} rot "
        f"{dflt['rot_deg']:.4f} deg tdir {dflt['tdir_deg']:.4f} deg, "
        f"{dflt['ms']:.1f} ms")
    gates.check(dflt["finite"], "PipelineConfig(): non-finite points")
    gate_two_view([dflt], JAX_DEFAULT, gates, "PipelineConfig()")
    return {"median": med, "seeds": rows, "sift": sift_res,
            "pipeline_config_default": dflt}, launches


@contextlib.contextmanager
def spy(module, name, **extra):
    """Record (args, kwargs, result, the launch counts after it) of each
    call of ``module.name`` inside the block, passing it ``extra``
    keyword arguments too; the function itself is restored after it."""
    from sfm_tpu_torch.ops import _cuda

    fn = getattr(module, name)
    calls = []

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs, **extra)
        calls.append((args, kwargs, out, dict(_cuda.LAUNCHES)))
        return out

    setattr(module, name, wrapped)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def sequence_quality(R, t, pose_valid, seq):
    """``synthetic_sequence.pose_quality`` by the port's metrics, as
    tests/jax_cli_reference.py measures the JAX package's."""
    from sfm_tpu_torch.utils import metrics
    from synthetic_sequence import pose_quality

    return pose_quality(metrics, R.cpu().numpy(), t.cpu().numpy(),
                        pose_valid.cpu().numpy(), seq)


def gate_sequence(r, ref, gates, where):
    """A sequence run against the JAX package's on the same frames."""
    gates.check(r["poses"] == ref["poses"],
                f"{where}: {r['poses']} poses registered, the JAX package {ref['poses']}")
    for k in ("ate", "rot_median_deg", "rot_max_deg"):
        gates.check(r[k] <= 3.0 * ref[k], f"{where}: {k} {r[k]:.6g} > 3 x the JAX "
                    f"package's {ref[k]:.6g}")
    gates.check(r["points"] >= 0.9 * ref["points"], f"{where}: {r['points']} points "
                f"< 90% of the JAX package's {ref['points']}")
    gates.check(r["px"] <= ref["px"] / 0.9, f"{where}: {r['px']:.4f} px > the JAX "
                f"package's {ref['px']:.4f} / 0.9")
    gates.check(r["ba_cost_final"] < r["ba_cost_initial"],
                f"{where}: the BA cost did not fall ({r['ba_cost_initial']:.6g} -> "
                f"{r['ba_cost_final']:.6g})")


def solver_ab(R, t, X, problem, iters, huber_delta=3e-3):
    """One BA problem solved by run_ba's dense LU and its CG on the card,
    against a float64 dense solve on the CPU: final costs, the relative
    gap to float64, and ms per LM iteration (CUDA events around whole
    runs of ``iters`` iterations, 3 runs after a warm-up)."""
    import torch

    from sfm_tpu_torch.models import bundle_adjust as ba

    def f64(a):
        return a.detach().cpu().double() if a.is_floating_point() else a.cpu()

    M, P = R.shape[0], X.shape[0]
    t0 = time.perf_counter()
    ref, ref_costs = ba.run_ba(f64(R), f64(t), f64(X),
                               ba.BAProblem(*map(f64, problem)), iters=iters,
                               huber_delta=huber_delta, solver="dense")
    c_ref = float(ref_costs[-1])
    out = {"cameras": M, "points": P, "fixed_cameras": int(problem.fixed.sum()),
           "observation_slots": problem.mask.shape[0],
           "observations": int(problem.mask.sum()), "iters": iters,
           "huber_delta": huber_delta,
           "auto": ba.resolve_solver("auto", M, P),
           "cpu_float64_dense": {"cost_initial": float(ref_costs[0]),
                                 "cost_final": c_ref,
                                 "seconds": time.perf_counter() - t0}}
    for solver in ("dense", "cg"):
        kw = dict(iters=iters, huber_delta=huber_delta, solver=solver)
        ms = cuda_ms(lambda: ba.run_ba(R, t, X, problem, **kw), reps=3, warmup=1)
        fin, costs = ba.run_ba(R, t, X, problem, **kw)
        c = float(costs[-1])
        out[solver] = {"cost_initial": float(costs[0]), "cost_final": c,
                       "gap_to_float64": (c - c_ref) / c_ref, "ms_per_iter": ms / iters,
                       "max_rotation_diff_to_float64": float(
                           (fin.R.cpu().double() - ref.R).abs().max()),
                       "finite": bool(torch.isfinite(costs).all())}
    return out


def ba_solver_ab(state, uv, kp_valid, K_inv, iters, dev):
    """run_ba's solvers on three problems: the sequence's global BA (the
    map as run_incremental hands it to its global BA; camera 0 fixed,
    the scale gauge held by the damping), the same with no camera fixed
    (the 7-dimensional similarity gauge held by the damping alone, as in
    the JAX package's turntable free-BA stage), and a 36-camera ring
    with no camera fixed (``tests/ba_problems.py``)."""
    import torch

    from ba_problems import ring_problem
    from sfm_tpu_torch.models import bundle_adjust as ba
    from sfm_tpu_torch.models import incremental

    problem = incremental.build_ba_problem(state, uv, kp_valid, K_inv)
    R0, t0, X0, *ring = ring_problem(M=36, P=400)
    ring = ba.BAProblem(*(torch.as_tensor(a, device=dev, dtype=torch.float32)
                          if a.dtype.kind == "f" else torch.as_tensor(a, device=dev)
                          for a in ring))
    r32 = [torch.as_tensor(a, device=dev, dtype=torch.float32) for a in (R0, t0, X0)]
    free = problem._replace(fixed=torch.zeros_like(problem.fixed))
    return {"sequence": solver_ab(state.R, state.t, state.X, problem, iters),
            "sequence_free_gauge": solver_ab(state.R, state.t, state.X, free, iters),
            "ring36_free_gauge": solver_ab(*r32, ring, iters)}


def sequence_phase(gates, dev, card):
    """Phase 9: multi-view SfM on the 12-frame arc sequence
    (``tests/synthetic_sequence.py``, 576 x 720, the CLI's defaults):
    (a) ``reconstruct`` of its 12 PGMs through the CLI with a map
    checkpoint, (b) ``run_incremental`` on the float frames with the
    closure pair (0, 11), each gated against the JAX package's run on
    the same frames and the rendered poses; then the BA solver A/B on
    (b)'s global BA problem.  Returns (result, launches of (a) + (b))."""
    import contextlib
    import io
    import tempfile

    import torch

    from sfm_tpu_torch import cli
    from sfm_tpu_torch.config import PipelineConfig, RansacConfig, SiftConfig
    from sfm_tpu_torch.geometry import pnp
    from sfm_tpu_torch.models import incremental
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.utils.checkpoint import load_map
    from sfm_tpu_torch.utils.timing import StageTimer
    from synthetic_sequence import synthetic_sequence, write_pgms

    t0 = time.perf_counter()
    seq = synthetic_sequence(576, 720, n_frames=SEQ_FRAMES)
    log(f"sequence: {SEQ_FRAMES} frames of 576 x 720 rendered in "
        f"{time.perf_counter() - t0:.1f} s")
    f = float(seq["K"][0, 0])
    with tempfile.TemporaryDirectory() as d:
        paths = write_pgms(d, seq["images"])
        ply, js, npz = (os.path.join(d, n) for n in ("seq.ply", "seq.json", "seq.npz"))
        _cuda.reset_launches()
        with spy(incremental, "run_incremental") as calls, \
                contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["reconstruct", *paths, "--focal", f"{f:g}", "--out", ply,
                           "--metrics", js, "--checkpoint", npz])
        launches_a = dict(_cuda.LAUNCHES)
        with open(js) as fh:
            m = json.load(fh)
        run_state = calls[0][2].state
        ckpt, extra = load_map(npz)
        vertices = _ply_vertices(ply)
    same = all(torch.equal(a, b.cpu()) for a, b in zip(ckpt, run_state))
    a = {"rc": rc, "device": m["device"], "poses": m["poses_registered"],
         "points": m["num_points"], "px": m["mean_reproj_px"],
         "ba_cost_initial": m["ba_cost_initial"], "ba_cost_final": m["ba_cost_final"],
         **sequence_quality(ckpt.R, ckpt.t, ckpt.pose_valid, seq),
         "ply_vertices": vertices, "checkpoint_equals_run": same,
         "checkpoint_K": extra["K"], "ms": m["stage_times"]["pipeline"]["total_ms"]}
    log(f"sequence (a) cli reconstruct x{SEQ_FRAMES} PGMs: poses {a['poses']} points "
        f"{a['points']} px {a['px']:.4f} ATE {a['ate']:.6f} rotation error median "
        f"{a['rot_median_deg']:.5f} max {a['rot_max_deg']:.5f} deg, BA cost "
        f"{a['ba_cost_initial']:.6g} -> {a['ba_cost_final']:.6g}; PLY {vertices} "
        f"vertices; checkpoint equals the run's map: {same}; {a['ms']:.0f} ms "
        f"(host clock, {card})")
    gates.check(rc == 0, f"sequence cli: exit code {rc}")
    gates.check(a["device"] == torch.cuda.get_device_name(0),
                f"sequence cli: ran on {a['device']}")
    gates.check(vertices == a["points"], f"sequence cli: PLY holds {vertices} "
                f"vertices, num_points {a['points']}")
    gates.check(same, "sequence cli: the checkpoint differs from the run's map")
    gates.check(int(ckpt.pose_valid.sum()) == a["poses"]
                and int(ckpt.X_valid.sum()) == a["points"],
                "sequence cli: the checkpoint's counts differ from the metrics")
    gate_sequence(a, JAX_SEQUENCE["cli"], gates, "sequence cli")

    cfg = PipelineConfig(sift=SiftConfig(max_pts_per_octave=1024),
                         ransac=RansacConfig(n_hyps=1024, threshold=3e-6))
    imgs = [torch.as_tensor(im, device=dev) for im in seq["images"]]
    timer = StageTimer()
    with spy(incremental, "_global_ba") as gcalls, spy(pnp, "pnp_lo") as lo_calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = incremental.run_incremental(imgs, seq["K"], cfg, seed=0, ba_iters=20,
                                          closure_pairs=SEQ_CLOSURES, timer=timer)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    launches = dict(_cuda.LAUNCHES)
    st = res.state
    costs = res.ba_costs.cpu()
    b = {"poses": int(st.pose_valid.sum()), "points": int(st.X_valid.sum()),
         "px": math.sqrt(max(float(res.mean_reproj), 0.0) / 2) * f,
         "ba_cost_initial": float(costs[0]), "ba_cost_final": float(costs[-1]),
         **sequence_quality(st.R, st.t, st.pose_valid, seq), "ms": ms,
         "finite": bool(torch.isfinite(st.X).all() and torch.isfinite(costs).all()),
         "stage_ms": {k: v["total_ms"] for k, v in timer.summary().items()}}
    b["stage_ms_per_frame"] = {k: v / max(b["poses"], 1)
                               for k, v in b["stage_ms"].items()}
    log(f"sequence (b) run_incremental, closure {SEQ_CLOSURES}: poses {b['poses']} "
        f"points {b['points']} px {b['px']:.4f} ATE {b['ate']:.6f} rotation error "
        f"median {b['rot_median_deg']:.5f} max {b['rot_max_deg']:.5f} deg, BA cost "
        f"{b['ba_cost_initial']:.6g} -> {b['ba_cost_final']:.6g}; {ms:.0f} ms")
    per = ", ".join(f"{k} {v:.2f}" for k, v in b["stage_ms_per_frame"].items())
    log(f"sequence (b) ms per registered frame (host clock around synchronized "
        f"stages, {card}): {per}")
    gates.check(b["finite"], "sequence run_incremental: non-finite map or costs")
    gate_sequence(b, JAX_SEQUENCE["module"], gates, "sequence run_incremental")
    k6_a = launches_a["match_top2"]
    k6_b = launches["match_top2"] - k6_a
    log(f"launches in the sequence runs: {launches} (K6: cli {k6_a}, "
        f"run_incremental {k6_b}; matched pairs {sequence_matches(SEQ_FRAMES)} and "
        f"{sequence_matches(SEQ_FRAMES, len(SEQ_CLOSURES))})")
    gates.check(k6_a == sequence_matches(SEQ_FRAMES),
                f"sequence cli: K6 launched {k6_a} times")
    check_path_launches("sequence", launches, gates)

    # K11 on the last registered frame's LO inputs, then the BA solver
    # A/B on (b)'s global problem, after the counts were read.
    k11 = hold_pnp_lo(lo_calls[-1], gates, f"frame {SEQ_FRAMES - 1}")
    g_args = gcalls[0][0]
    ab = ba_solver_ab(*g_args[:4], iters=20, dev=dev)
    log_solver_ab(ab, gates, card)
    return {"cli": a, "module": b, "ba_solver_ab": ab, "launches_cli": launches_a,
            "pnp_lo": k11}, launches


def log_solver_ab(ab, gates, card):
    """Log each problem's solver A/B; gate every solve on a falling,
    finite cost and run_ba's "auto" choice on ending within 1e-3 of the
    float64 cost."""
    for name, p in ab.items():
        ref = p["cpu_float64_dense"]
        log(f"BA solver A/B, {name}: {p['cameras']} cameras "
            f"({p['fixed_cameras']} fixed), {p['points']} point slots, "
            f"{p['observations']} of {p['observation_slots']} observations, "
            f"{p['iters']} LM iterations; run_ba's auto: {p['auto']}; float64 CPU "
            f"dense: cost {ref['cost_initial']:.6g} -> {ref['cost_final']:.6g}")
        for solver in ("dense", "cg"):
            r = p[solver]
            log(f"  {solver} on the card: cost {r['cost_initial']:.6g} -> "
                f"{r['cost_final']:.6g} (gap to float64 {r['gap_to_float64']:+.3e}, "
                f"max |R - R_f64| {r['max_rotation_diff_to_float64']:.2e}), "
                f"{r['ms_per_iter']:.3f} ms per LM iteration (CUDA events, {card})")
            gates.check(r["finite"] and r["cost_final"] < r["cost_initial"],
                        f"BA A/B {name} {solver}: cost {r['cost_initial']} -> "
                        f"{r['cost_final']}")
        gap = p[p["auto"]]["gap_to_float64"]
        gates.check(abs(gap) <= 1e-3, f"BA A/B {name}: run_ba's auto solver "
                    f"({p['auto']}) ends {gap:+.3e} from the float64 cost")


@contextlib.contextmanager
def timed(module, name, timer, stage, dev):
    """Record the synchronized wall time of each call of ``module.name``
    inside the block under ``stage``, in a profiler range of that name."""
    import torch

    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(stage):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize(dev)
            timer.record(stage, time.perf_counter() - t0)
        return out

    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def env(name, value):
    """Set the environment variable ``name`` inside the block."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def run_turntable_driver(d, out, timer=None, dump=None):
    """``python -m sfm_tpu_torch.tools.reconstruct_dino --dir d --turntable
    --out out`` in-process, its stdout swallowed; ``timer`` records ms by
    stage (extract, then run_incremental's and reconstruct_turntable's
    stages), ``dump`` sets SFM_TPU_TT_DUMP.  Returns (exit code,
    metrics, PLY vertices, the TurntableResult, launches after the chain,
    ms)."""
    import io

    import torch

    from sfm_tpu_torch.models import incremental, turntable
    from sfm_tpu_torch.sift import frontend
    from sfm_tpu_torch.tools import reconstruct_dino

    extra = {} if timer is None else {"timer": timer}
    with contextlib.ExitStack() as stack:
        if timer is not None:
            stack.enter_context(timed(frontend, "extract_sift", timer, "extract",
                                      torch.device("cuda", 0)))
        if dump is not None:
            stack.enter_context(env("SFM_TPU_TT_DUMP", dump))
        chain = stack.enter_context(spy(incremental, "run_incremental", **extra))
        ring = stack.enter_context(spy(turntable, "reconstruct_turntable", **extra))
        stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = reconstruct_dino.main(["--dir", d, "--turntable", "--out", out])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    with open(out + ".metrics.json") as fh:
        m = json.load(fh)
    return rc, m, _ply_vertices(out + ".ply"), ring[0][2], chain[0][3], ms


def gate_ring_bar(m, gates, where):
    """r5's bar (RING_BAR) on the driver's metrics."""
    gates.check(abs(m["tt_step_deg_mean"] - 10.0) <= RING_BAR["step_mean"],
                f"{where}: mean step {m['tt_step_deg_mean']:.4f} deg")
    gates.check(m["tt_step_deg_std"] <= RING_BAR["step_std"],
                f"{where}: step std {m['tt_step_deg_std']:.4f} deg")
    gates.check(abs(m["tt_total_deg"] - 360.0) <= RING_BAR["total_deg"],
                f"{where}: total {m['tt_total_deg']} deg")
    gates.check(m["tt_rms_px"] <= RING_BAR["rms_px"], f"{where}: {m['tt_rms_px']} px")
    gates.check(m["poses_valid"] == m["frames"],
                f"{where}: {m['poses_valid']} of {m['frames']} poses")


def ring_phase(gates, dev, card):
    """Phase 10: the turntable driver on the synthetic ring (36 frames of
    576 x 720, k1 = -0.45), gated on r5's bar, against the JAX package's
    run on the same files and against the rendered poses; ms per frame
    by stage; then the free-BA solver A/B on the run's own dump.
    Returns (result, launches of the run)."""
    import tempfile

    import numpy as np

    from sfm_tpu_torch.models import turntable
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.utils import metrics
    from sfm_tpu_torch.utils.timing import StageTimer
    from synthetic_ring import synthetic_ring
    from synthetic_sequence import nearest_rotations

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ring = synthetic_ring(576, 720, n_frames=RING_FRAMES, directory=d)
        log(f"ring: {RING_FRAMES} frames of 576 x 720 (+ viff.{RING_FRAMES:03d}.ppm) "
            f"rendered and written in {time.perf_counter() - t0:.1f} s")
        timer = StageTimer()
        dump = os.path.join(d, "free_ba.npz")
        _cuda.reset_launches()
        rc, m, vertices, ttr, after_chain, ms = run_turntable_driver(
            d, os.path.join(d, "ring"), timer=timer, dump=dump)
        launches = dict(_cuda.LAUNCHES)
        R, t, X, problem, delta = turntable.free_ba_problem(dump, dev)
    rot = metrics.rotation_errors_deg(nearest_rotations(ttr.R.cpu().numpy()), ring["R"])
    sd = ttr.step_deg.numpy()
    r = {"rc": rc, "poses": m["poses_valid"], "step_mean": float(sd.mean()),
         "step_std": float(sd.std()), "total_deg": ttr.total_deg, "rms_px": ttr.rms_px,
         "f_px": ttr.f, "k1": ttr.k1, "k2": ttr.k2, "tracks": ttr.tracks.n_tracks,
         "obs": int(ttr.tracks.cam_idx.shape[0]), "obs_kept": int(ttr.keep.sum()),
         "rot_median_deg": float(np.median(rot)), "rot_max_deg": float(rot.max()),
         "n_points": m["n_points"], "ply_vertices": vertices, "metrics": m, "ms": ms,
         "k6_chain": after_chain["match_top2"],
         "k6_tracks": launches["match_top2"] - after_chain["match_top2"],
         "stage_ms": {k: v["total_ms"] for k, v in timer.summary().items()}}
    r["stage_ms_per_frame"] = {k: v / RING_FRAMES for k, v in r["stage_ms"].items()}
    log(f"ring driver --turntable: {r['poses']} poses, step {r['step_mean']:.4f} +- "
        f"{r['step_std']:.4f} deg, total {r['total_deg']:.3f} deg, {r['rms_px']:.4f} px "
        f"over {r['obs_kept']} of {r['obs']} observations of {r['tracks']} tracks, f "
        f"{r['f_px']:.2f} px, k1 {r['k1']:.4f}; rotation error median "
        f"{r['rot_median_deg']:.4f} max {r['rot_max_deg']:.4f} deg; PLY {vertices} "
        f"vertices; {ms:.0f} ms (host clock, {card})")
    per = ", ".join(f"{k} {v:.2f}" for k, v in r["stage_ms_per_frame"].items())
    log(f"ring ms per frame (host clock around synchronized stages, {card}): {per}")
    log(f"launches in the ring run: {launches} (K6: chain {r['k6_chain']}, ring tracks "
        f"{r['k6_tracks']})")
    gates.check(rc == 0, f"ring driver: exit code {rc}")
    gate_ring_bar(m, gates, "ring driver")
    # The metrics JSON reports the result the run computed.
    gates.check(m["tt_tracks"] == r["tracks"] and m["tt_obs_kept"] == r["obs_kept"]
                and m["tt_rms_px"] == round(r["rms_px"], 3),
                "ring driver: the metrics differ from the run's result")
    gates.check(r["rms_px"] <= JAX_RING["rms_px"] / 0.9,
                f"ring: {r['rms_px']:.4f} px > the JAX package's "
                f"{JAX_RING['rms_px']:.4f} / 0.9")
    for k in ("tracks", "obs_kept"):
        gates.check(r[k] >= 0.9 * JAX_RING[k], f"ring: {k} {r[k]} < 90% of the JAX "
                    f"package's {JAX_RING[k]}")
    gates.check(abs(r["f_px"] - JAX_RING["f_px"]) <= 0.01 * JAX_RING["f_px"],
                f"ring: f {r['f_px']:.2f} px, the JAX package's {JAX_RING['f_px']:.2f}")
    gates.check(r["k1"] < 0, f"ring: k1 {r['k1']:.4f}, rendered {ring['k1']}")
    for k in ("rot_median_deg", "rot_max_deg"):
        gates.check(r[k] <= 3.0 * JAX_RING[k], f"ring: {k} {r[k]:.4f} > 3 x the JAX "
                    f"package's {JAX_RING[k]:.4f}")
    gates.check(vertices == m["ply_vertices"], f"ring: PLY holds {vertices} vertices, "
                f"the metrics {m['ply_vertices']}")
    gates.check(r["k6_chain"] == sequence_matches(RING_FRAMES),
                f"ring: K6 launched {r['k6_chain']} times in the chain")
    gates.check(r["k6_tracks"] == RING_PAIRS,
                f"ring: K6 launched {r['k6_tracks']} times in build_tracks")
    check_path_launches("ring", launches, gates)

    # The free-BA stage's solver A/B (no camera fixed), after the counts.
    ab = {"ring_free_ba": solver_ab(R, t, X, problem, 30, huber_delta=delta)}
    log_solver_ab(ab, gates, card)
    r["ba_solver_ab"] = ab
    return r, launches


def rel_gap(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def dist_ba_ab(R, t, X, problem, mesh, iters, card, name, gates):
    """run_dist_ba on the mesh against run_ba with the same solver on the
    same inputs (the mesh's partition of the problem; on one rank the
    all-reduce is an identity: gated at 1e-6 in the final cost, R and X)
    and on the problem as it came (the cost gated at 1e-4), all with
    deterministic algorithms (no float atomics in the segment sums);
    then ms per LM iteration of run_dist_ba and of run_ba on the problem
    as it came, in the default mode (CUDA events around whole runs, 3
    after a warm-up)."""
    import torch

    from sfm_tpu_torch.models import bundle_adjust as ba
    from sfm_tpu_torch.parallel import dist_ba, mesh as meshmod

    X_sh, prob_sh = dist_ba.partition_problem(problem, X, mesh.size)
    prob_d = ba.BAProblem(*(meshmod.put_sharded(mesh, a) for a in prob_sh[:4]),
                          prob_sh.fixed)
    X_d = meshmod.put_sharded(mesh, X_sh)
    out = {"cameras": R.shape[0], "points": X.shape[0],
           "observations": int(problem.mask.sum()), "iters": iters}
    for solver in ("cg", "dense"):
        kw = dict(iters=iters, solver=solver)

        def run_d():
            return dist_ba.run_dist_ba(R, t, X_d, prob_d, mesh, **kw)

        def run_l():
            return ba.run_ba(R, t, X, problem, **kw)

        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            Rd, _, Xd, cd = run_d()
            same, cs = ba.run_ba(R, t, X_sh, prob_sh, **kw)
            _, cl = run_l()
        finally:
            torch.use_deterministic_algorithms(False)
        Xd = meshmod.gather_sharded(mesh, Xd)
        r = {"cost_initial": float(cd[0]), "cost_final": float(cd[-1]),
             "gap_cost": abs(float(cd[-1]) / float(cs[-1]) - 1),
             "gap_R": rel_gap(Rd, same.R), "gap_X": rel_gap(Xd, same.X),
             "gap_cost_as_it_came": abs(float(cd[-1]) / float(cl[-1]) - 1),
             "finite": bool(torch.isfinite(cd).all()),
             "never_rises": bool((cd[1:] <= cd[:-1]).all()),
             "ms_per_iter": cuda_ms(run_d, reps=3, warmup=1) / iters,
             "ms_per_iter_run_ba": cuda_ms(run_l, reps=3, warmup=1) / iters}
        out[solver] = r
        log(f"run_dist_ba {solver} on {name} ({out['cameras']} cameras, {out['points']} "
            f"point slots, {out['observations']} observations, {iters} LM iterations, "
            f"{mesh.backend} mesh of {mesh.size}): cost {r['cost_initial']:.6g} -> "
            f"{r['cost_final']:.6g}; against run_ba on the same inputs (deterministic "
            f"algorithms) gaps cost {r['gap_cost']:.2e}, R {r['gap_R']:.2e}, X "
            f"{r['gap_X']:.2e}; cost against run_ba on the problem as it came "
            f"{r['gap_cost_as_it_came']:.2e}; {r['ms_per_iter']:.3f} ms per LM "
            f"iteration, run_ba {r['ms_per_iter_run_ba']:.3f} (CUDA events, {card})")
        gates.check(r["finite"] and r["never_rises"] and r["cost_final"] < r["cost_initial"],
                    f"run_dist_ba {solver} on {name}: cost {r['cost_initial']} -> "
                    f"{r['cost_final']}")
        for k in ("gap_cost", "gap_R", "gap_X"):
            gates.check(r[k] <= 1e-6, f"run_dist_ba {solver} on {name}: {k} {r[k]:.3e} "
                        f"to run_ba on the same inputs > 1e-6")
        gates.check(r["gap_cost_as_it_came"] <= 1e-4,
                    f"run_dist_ba {solver} on {name}: cost "
                    f"{r['gap_cost_as_it_came']:.3e} from run_ba's > 1e-4")
    return out


def distributed_phase(seq_res, gates, dev, card):
    """Phase 11: the distributed layer on a one-rank NCCL mesh (the CLI's
    ``--mesh 1`` on the sequence; the dry run's match; BA against
    run_ba), ``make_mesh(2)``'s refusal, then two ranks sharing the card
    over gloo.  Returns (result, launches of the CLI run)."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as tdist

    from ba_problems import rig_problem
    from sfm_tpu_torch import cli
    from sfm_tpu_torch.models import bundle_adjust as ba
    from sfm_tpu_torch.models import incremental
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.ops.match import match_top2
    from sfm_tpu_torch.parallel import dist_match, mesh as meshmod
    from sfm_tpu_torch.utils.checkpoint import load_map
    from sfm_tpu_torch.utils.timing import StageTimer
    from synthetic_sequence import synthetic_sequence, write_pgms
    from torch_dist_worker import run_ranks

    # (a) The sequence through the CLI on a one-rank mesh.
    seq = synthetic_sequence(576, 720, n_frames=SEQ_FRAMES)
    f = float(seq["K"][0, 0])
    timer = StageTimer()
    with tempfile.TemporaryDirectory() as d:
        paths = write_pgms(d, seq["images"])
        ply, js, npz = (os.path.join(d, n) for n in ("m.ply", "m.json", "m.npz"))
        _cuda.reset_launches()
        with spy(incremental, "run_incremental", timer=timer) as calls, \
                spy(incremental, "_global_ba") as gcalls, \
                contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["reconstruct", *paths, "--focal", f"{f:g}", "--out", ply,
                           "--metrics", js, "--checkpoint", npz, "--mesh", "1"])
        launches = dict(_cuda.LAUNCHES)
        with open(js) as fh:
            m = json.load(fh)
        run_state = calls[0][2].state
        ckpt, _ = load_map(npz)
        vertices = _ply_vertices(ply)
    same = all(torch.equal(x, y.cpu()) for x, y in zip(ckpt, run_state))
    a = {"rc": rc, "device": m["device"], "mesh": m.get("mesh"),
         "poses": m["poses_registered"], "points": m["num_points"],
         "px": m["mean_reproj_px"], "ba_cost_initial": m["ba_cost_initial"],
         "ba_cost_final": m["ba_cost_final"],
         **sequence_quality(ckpt.R, ckpt.t, ckpt.pose_valid, seq),
         "ply_vertices": vertices, "checkpoint_equals_run": same,
         "ms": m["stage_times"]["pipeline"]["total_ms"],
         "group_closed": not tdist.is_initialized()}
    a["stage_ms_per_frame"] = {k: v["total_ms"] / max(a["poses"], 1)
                               for k, v in timer.summary().items()}
    log(f"distributed (a) cli reconstruct x{SEQ_FRAMES} PGMs --mesh 1 ({a['mesh']}): "
        f"poses {a['poses']} points {a['points']} px {a['px']:.4f} ATE {a['ate']:.6f} "
        f"rotation error median {a['rot_median_deg']:.5f} max {a['rot_max_deg']:.5f} "
        f"deg, BA cost {a['ba_cost_initial']:.6g} -> {a['ba_cost_final']:.6g}; PLY "
        f"{vertices} vertices; checkpoint equals the run's map: {same}; {a['ms']:.0f} ms "
        f"(host clock, {card})")
    base = seq_res["module"]["stage_ms_per_frame"]
    per = ", ".join(f"{k} {v:.2f} (phase 9 (b) {base.get(k, float('nan')):.2f})"
                    for k, v in a["stage_ms_per_frame"].items())
    log(f"distributed (a) ms per registered frame (host clock around synchronized "
        f"stages, {card}; phase 9 (b) without the mesh, with its closure pair): {per}")
    log(f"launches in the mesh run: {launches}")
    gates.check(rc == 0, f"distributed cli: exit code {rc}")
    gates.check(a["mesh"] == {"size": 1, "backend": "nccl"},
                f"distributed cli: mesh {a['mesh']}, not one NCCL rank")
    gates.check(a["group_closed"], "distributed cli: the process group was left open")
    gates.check(a["device"] == torch.cuda.get_device_name(0),
                f"distributed cli: ran on {a['device']}")
    gates.check(vertices == a["points"], f"distributed cli: PLY holds {vertices} "
                f"vertices, num_points {a['points']}")
    gates.check(same, "distributed cli: the checkpoint differs from the run's map")
    gate_sequence(a, JAX_SEQUENCE["cli"], gates, "distributed cli")
    check_path_launches("distributed", launches, gates)

    # (a) Matching and BA on a one-rank mesh, after the counts were read.
    rng = np.random.default_rng(0)
    d1, d2 = (rng.normal(size=(DRYRUN_N, 128)).astype(np.float32) for _ in range(2))
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    v2 = np.ones(DRYRUN_N, bool)
    R0, t0, X0, *arrs = rig_problem()
    f32 = (lambda x: torch.as_tensor(x, device=dev,
                                     dtype=torch.float32 if x.dtype.kind == "f" else None))
    rig = ba.BAProblem(*map(f32, arrs))
    n_proc = meshmod.init_distributed()
    with meshmod.make_global_mesh() as mesh:
        gates.check(n_proc == 1 and (mesh.size, mesh.backend, mesh.device) == (1, "nccl", dev),
                    f"distributed: init_distributed() {n_proc}, make_global_mesh() {mesh}")
        t1, t2, tv = f32(d1), f32(d2), f32(v2)
        before = _cuda.LAUNCHES["match_top2"]
        top2 = dist_match.dist_match_top2(t1, meshmod.put_sharded(mesh, t2), tv, mesh)
        torch.cuda.synchronize()
        k6 = _cuda.LAUNCHES["match_top2"] - before
        ref = match_top2(t1, t2, tv)
        match_equal = all(torch.equal(x, y) for x, y in zip(top2, ref))
        match = {"n1": DRYRUN_N, "n2": DRYRUN_N, "k6_launches": k6, "equal": match_equal,
                 "ms": cuda_ms(lambda: dist_match.dist_match_top2(
                     t1, meshmod.put_sharded(mesh, t2), tv, mesh)),
                 "local_ms": cuda_ms(lambda: match_top2(t1, t2, tv))}
        log(f"dist_match_top2 {DRYRUN_N} x {DRYRUN_N} on the one-rank mesh: K6 x{k6}, "
            f"equal to the local K6 bit for bit: {match_equal}; {match['ms']:.4f} ms "
            f"against {match['local_ms']:.4f} (CUDA events, {card})")
        gates.check(k6 == 1 and match_equal, f"dist_match_top2 on one rank: K6 x{k6}, "
                    f"equal {match_equal}")
        # What one collective costs: CG's [M, 6] all-reduce per matvec, the
        # matcher's [N1, 3] float64 all-gather per pair.
        x6 = torch.ones((SEQ_FRAMES, 6), device=dev)
        c3 = torch.ones((DRYRUN_N, 3), dtype=torch.float64, device=dev)
        match["all_reduce_ms"] = cuda_ms(lambda: mesh.all_reduce(x6))
        match["all_gather_ms"] = cuda_ms(lambda: mesh.all_gather(c3))
        log(f"one {mesh.backend} collective on the one-rank mesh: all-reduce of "
            f"[{SEQ_FRAMES}, 6] f32 {match['all_reduce_ms']:.4f} ms, all-gather of "
            f"[{DRYRUN_N}, 3] f64 {match['all_gather_ms']:.4f} ms (CUDA events, {card})")
        g_args = gcalls[0][0]
        problem = incremental.build_ba_problem(*g_args[:4])
        st = g_args[0]
        ba_seq = dist_ba_ab(st.R, st.t, st.X, problem, mesh, 20, card,
                            "the sequence's global BA", gates)
        ba_rig = dist_ba_ab(*map(f32, (R0, t0, X0)), rig, mesh, DIST_BA_ITERS, card,
                            "the dry run's rig", gates)
    try:
        meshmod.make_mesh(2)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    log(f"make_mesh(2): {refusal}")
    n_cards = torch.cuda.device_count()
    gates.check(refusal is not None and f"have {n_cards}" in refusal,
                f"make_mesh(2) on {n_cards} card(s): {refusal}")

    # (b) Two ranks sharing the card over gloo.
    cases = {"match/dryrun/d1": d1, "match/dryrun/d2": d2, "match/dryrun/v2": v2,
             "match/dryrun/bf16": np.bool_(True)}
    for solver in ("cg", "dense"):
        cases.update({f"ba/{solver}/{k}": v for k, v in zip(
            ("R", "t", "X", "cam", "pt", "uv", "mask", "fixed"),
            (x.astype(np.float32) if x.dtype.kind == "f" else x
             for x in (R0, t0, X0, *arrs)))})
        cases.update({f"ba/{solver}/iters": np.int64(DIST_BA_ITERS),
                      f"ba/{solver}/solver": np.str_(solver),
                      f"ba/{solver}/cg_iters": np.int64(32)})
    t0_ = time.perf_counter()
    results, lines = run_ranks(cases, device=str(dev), world=DIST_WORLD,
                               timeout=600)
    b = {"world": DIST_WORLD, "seconds": time.perf_counter() - t0_, "lines": lines,
         "k6_launches_per_rank": [int(r["launches/match_top2"]) for r in results]}
    ref_np = [x.cpu().numpy() for x in ref]
    b["match_equal"] = [bool(all(np.array_equal(r[f"match/dryrun/{k}"], x)
                                 for k, x in zip(("best", "second", "index"), ref_np)))
                        for r in results]
    for solver in ("cg", "dense"):
        c = results[0][f"ba/{solver}/costs"]
        b[solver] = {"cost_initial": float(c[0]), "cost_final": float(c[-1]),
                     "gap_to_one_rank": abs(float(c[-1]) / ba_rig[solver]["cost_final"] - 1),
                     "ms_per_iter": [float(r[f"ba/{solver}/ms_per_iter"]) for r in results],
                     "never_rises": bool(np.all(np.diff(c) <= 0))}
    log(f"distributed (b) {DIST_WORLD} ranks on {torch.cuda.get_device_name(0)} over gloo "
        f"({b['seconds']:.1f} s with the processes' start): K6 per rank "
        f"{b['k6_launches_per_rank']} (dist_match_top2 + dist_match on "
        f"{DRYRUN_N // DIST_WORLD} rows each), top-2 equal to (a)'s: {b['match_equal']}; "
        + "; ".join(f"{s} cost {b[s]['cost_initial']:.6g} -> {b[s]['cost_final']:.6g} "
                    f"(gap to one rank {b[s]['gap_to_one_rank']:.2e}), ms per LM iteration "
                    f"by rank {[round(x, 3) for x in b[s]['ms_per_iter']]} (host clock, "
                    f"{card})" for s in ("cg", "dense")))
    log(f"distributed (b) ranks' cost lines equal: {lines[0] == lines[1]}: {lines[0]}")
    gates.check(all(b["match_equal"]), f"2 ranks: top-2 differs from one rank's K6 "
                f"{b['match_equal']}")
    gates.check(b["k6_launches_per_rank"] == [2] * DIST_WORLD,
                f"2 ranks: K6 launches per rank {b['k6_launches_per_rank']}")
    gates.check(len(set(lines)) == 1, f"2 ranks: the ranks' costs differ: {lines}")
    for solver in ("cg", "dense"):
        gates.check(b[solver]["gap_to_one_rank"] <= 1e-3 and b[solver]["never_rises"],
                    f"2 ranks: run_dist_ba {solver} {b[solver]}")
    res = {"cli": a, "match": match, "ba_sequence": ba_seq, "ba_rig": ba_rig,
           "make_mesh_2": refusal, "two_ranks": b}
    return res, launches


def profile_launches(fn):
    """(kernel launches, device ms) of one call of ``fn``, from a
    ``torch.profiler`` trace of it (the profiler's own buffers left
    out)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and "Buffer" not in e.name]
    return len(kern), sum(e.time_range.elapsed_us() for e in kern) / 1e3


def check_xla_launches(where, launches, images, pairs, up_scale, gates):
    """The XLA route's launches: the base chain, K8 and K5 once per
    image, K7 once per image with ``up_scale``, K6 once per pair, and
    never K3, K4 or K9."""
    want = {"base_chain": images, "orientation_histogram_sample": images,
            "descriptor_sample": images, "match_top2": pairs,
            "scale_up": images if up_scale else 0, "detect_maps": 0,
            "fused_orient_descriptor": 0, "fused_orient_descriptor_win": 0}
    for name, n in want.items():
        gates.check(launches[name] == n, f"{where}: {name} launched {launches[name]} "
                    f"times, not {n}")


def stage_ms(img1, img2, K, cfg, dev, seed=0):
    """Host-clock ms of one pair's stages, each ending in a synchronize:
    detect and sample (both images), match, geometry."""
    import torch

    from sfm_tpu_torch.models import two_view
    from sfm_tpu_torch.sift import frontend

    out = {}

    def run(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name] = out.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return r

    offsets, subs = frontend.atlas_layout(tuple(img1.shape), cfg.sift)
    feats = []
    for img in (img1, img2):
        atlas, dets = run("detect", lambda: frontend.detect_stage(img, cfg.sift))
        feats.append(run("sample", lambda: frontend.sample_stage(
            atlas, offsets, subs, dets, cfg.sift)))
    uv1, uv2, mask = run("match", lambda: two_view.match_stage(*feats, cfg))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    run("geometry", lambda: two_view.two_view_geometry(uv1, uv2, mask, K, cfg,
                                                       generator=gen))
    return out


def xla_bench_path(pair, cfg, gates, dev, card):
    """Phase 12 (a): the bench path on the XLA route over 8 seeds, gated
    against the JAX package's run of the same configuration and the
    rendered pose; ms per stage of the two routes in turns."""
    import torch

    from sfm_tpu_torch.ops import _cuda
    from synthetic_pair import pose_errors_deg

    xcfg = xla_config(cfg)
    img1 = torch.as_tensor(pair["img1"], device=dev)
    img2 = torch.as_tensor(pair["img2"], device=dev)
    K = torch.as_tensor(pair["K"], device=dev)
    f = float(pair["K"][0, 0])
    run_pairs(img1, img2, K, xcfg, f, [0], dev)          # warm-up
    _cuda.reset_launches()
    rows = run_pairs(img1, img2, K, xcfg, f, range(8), dev)
    launches = dict(_cuda.LAUNCHES)
    for r in rows:
        r["rot_deg"], r["tdir_deg"] = pose_errors_deg(r.pop("R"), r.pop("t"),
                                                      pair["R"], pair["t"])
        log(f"XLA route seed {r['seed']}: matches {r['matches']} inliers "
            f"{r['inliers']} valid {r['valid']} px {r['px']:.4f} rot "
            f"{r['rot_deg']:.4f} deg tdir {r['tdir_deg']:.4f} deg  {r['ms']:.1f} ms")
        gates.check(r["finite"], f"XLA route seed {r['seed']}: non-finite points")
    med = gate_two_view(rows, JAX_XLA_MEDIANS, gates, "XLA route bench path")
    log(f"launches in the XLA route's 8-pair run: {launches}")
    check_xla_launches("XLA route bench path", launches, 16, 8, False, gates)
    # Stage ms of the two routes in turns (fused, XLA, XLA, fused), each
    # the sum over two such runs.
    stages = {"fused": {}, "xla": {}}
    for name in ("fused", "xla", "xla", "fused"):
        for k, v in stage_ms(img1, img2, K, cfg if name == "fused" else xcfg,
                             dev).items():
            stages[name][k] = stages[name].get(k, 0.0) + v / 2
    log(f"XLA route ms/pair: median {med['ms']:.2f} (host clock around a "
        f"synchronized pair, 720x576, {card}); by stage, XLA / fused route (mean of "
        "two runs each, in turns): " + ", ".join(
            f"{k} {stages['xla'][k]:.2f} / {stages['fused'][k]:.2f}"
            for k in stages["xla"]))
    return {"median": med, "seeds": rows, "stage_ms": stages}, launches, xcfg


def xla_upscale_paths(rpair, ref, gates, dev, card):
    """Phase 12 (b): the up-scale path on the XLA route at lowest_scale 0
    and 1.0: features and ratio-test matches at 98-102% of the JAX
    package's, candidates and H-fit at 90%, phase 5's H error bars, and
    the gated run with fewer features.  Returns ({lowest_scale: result},
    summed launches, the ungated run's extractions)."""
    import dataclasses

    from sfm_tpu_torch.config import MatchConfig

    out, launches, feats = {}, {}, None
    lo, hi = XLA_UPSCALE_BAND
    for lowest, jax_ref in ((0.0, JAX_UPSCALE), (1.0, JAX_UPSCALE_LOWEST)):
        cfg = dataclasses.replace(upscale_config(), lowest_scale=lowest,
                                  fused_detect=False, use_pallas=False)
        res, s1, s2 = upscale_run(rpair, cfg, dev, MatchConfig(use_pallas=False))
        where = f"XLA route up-scale lowest_scale={lowest}"
        _log_upscale(res, rpair, card, where)
        gates.check(res["finite"], f"{where}: non-finite H")
        for k in ("n1", "n2", "matches"):
            gates.check(lo * jax_ref[k] <= res[k] <= hi * jax_ref[k],
                        f"{where}: {k} {res[k]} outside {lo:.0%}-{hi:.0%} of the JAX "
                        f"package's {jax_ref[k]}")
        for k in ("candidates", "numfit"):
            gates.check(res[k] >= 0.9 * jax_ref[k], f"{where}: {k} {res[k]} < 90% of "
                        f"the JAX package's {jax_ref[k]}")
        gates.check(res["h_median_px"] <= MAX_H_MEDIAN_PX,
                    f"{where}: H median error {res['h_median_px']:.4f} px")
        gates.check(res["h_max_px"] <= MAX_H_MAX_PX,
                    f"{where}: H max error {res['h_max_px']:.4f} px")
        check_xla_launches(where, res["launches"], 2, 1, True, gates)
        for k, n in res["launches"].items():
            launches[k] = launches.get(k, 0) + n
        out[lowest] = res
        if lowest == 0.0:
            feats = (s1, s2)
    gates.check(out[1.0]["n1"] + out[1.0]["n2"] < out[0.0]["n1"] + out[0.0]["n2"],
                f"XLA route up-scale: the gated run's features {out[1.0]['n1']} / "
                f"{out[1.0]['n2']} not fewer than the ungated {out[0.0]['n1']} / "
                f"{out[0.0]['n2']}")
    log(f"XLA route up-scale features against the fused route's (phase 5): "
        f"{out[0.0]['n1']} / {out[0.0]['n2']} vs {ref['n1']} / {ref['n2']}; "
        f"extraction {out[0.0]['extract_ms_per_image']:.2f} vs "
        f"{ref['extract_ms_per_image']:.2f} ms/image ({card})")
    return out, launches, feats


def xla_module_api(img, sc, gates):
    """Phase 12 (c): ``build_pyramid`` + ``detect`` per octave against
    the fused route's ``detect_stage`` on the same image: valid counts
    within 1%, 99% of the dense route's keypoints within 0.2 px of a
    fused one of the same octave."""
    import torch

    from sfm_tpu_torch.sift import detect, frontend, pyramid

    octaves = pyramid.build_pyramid(img, sc)
    dense = [detect.detect(o.dog, sc, o.subsampling) for o in octaves]
    offsets, _ = frontend.atlas_layout(tuple(img.shape), sc)
    _, fused = frontend.detect_stage(img, sc)
    n_d = n_f = near = 0
    for d, fz, off in zip(dense, fused, offsets):
        pd = torch.stack([d.x, d.y], -1)[d.valid]
        pf = torch.stack([fz.x, fz.y - off], -1)[fz.valid]
        n_d += pd.shape[0]
        n_f += pf.shape[0]
        if pd.shape[0] and pf.shape[0]:
            # Exact distances (cdist's matmul form loses ~0.2 px to
            # cancellation at coordinates of ~700 px).
            dist = torch.cdist(pd, pf, compute_mode="donot_use_mm_for_euclid_dist")
            near += int((dist.min(dim=1).values <= 0.2).sum())
    share = near / max(n_d, 1)
    res = {"octaves": len(octaves), "dense_valid": n_d, "fused_valid": n_f,
           "within_0.2px": share,
           "dog_shapes": [tuple(o.dog.shape) for o in octaves]}
    log(f"XLA route module API on {tuple(img.shape)}: build_pyramid + detect "
        f"{n_d} valid, fused detect_stage {n_f}; {share:.5f} of the dense "
        f"keypoints within 0.2 px of a fused one (gates: counts within 1%, >= 0.99)")
    gates.check(n_d > 1000, f"XLA module API: only {n_d} detections")
    gates.check(abs(n_d - n_f) <= 0.01 * n_f, f"XLA module API: {n_d} dense vs "
                f"{n_f} fused detections")
    gates.check(share >= 0.99, f"XLA module API: {share:.4f} within 0.2 px")
    return res


def hold_k6_f32(s1, s2, gates, where):
    """K6 in its f32 mode against its plain version (TF32 off) on a
    path's descriptor sets: scores within 1e-5, the same index on every
    row whose best and second differ by more than that (a closer pair
    is a tie within the summation order).  Returns the kernel's record,
    with the f32 ``torch.topk(a @ b.T, 2)`` as its library call."""
    import torch

    from sfm_tpu_torch.ops import match
    from sfm_tpu_torch.utils.precision import f32_precision

    a, b = s1.descriptors, s2.descriptors
    va = s2.keypoints.valid
    bk, sk, ik = match.match_top2(a, b, va, bf16=False)
    with f32_precision():
        bp, sp, ip = match.match_top2_plain(a, b, va, bf16=False)
    e6 = max(float((bk - bp).abs().max()), float((sk - sp).abs().max()))
    clear = (bp - sp) > 1e-5
    n_flip = int((ik != ip).sum())
    n_flip_clear = int(((ik != ip) & clear).sum())
    n1, n2 = a.shape[0], b.shape[0]
    gates.check(e6 <= 1e-5, f"{where}: K6 f32 max err {e6}")
    gates.check(n_flip_clear == 0, f"{where}: K6 f32 index differs on {n_flip_clear} "
                f"rows with a clear best")
    rec = kernel_record(
        "match_top2", e6, lambda: match.match_top2(a, b, va, bf16=False),
        lambda: match.match_top2_plain(a, b, va, bf16=False),
        f"{n1}x{n2}x128 f32, {int(s1.keypoints.valid.sum())} live rows",
        4 * 128 * (n1 + n2) + 4 * n2 + 12 * n1, 2.0 * n1 * n2 * 128,
        peak=F32_ACCURATE_FLOPS, lib_fn=lambda: torch.topk(a @ b.T, 2), plain_reps=5)
    if rec["bound_by"] == "operations":
        rec["bound_rate"] = "3 TF32 passes at 495 TFLOP/s"
    rec["index_differences"] = n_flip
    log(f"{where}: K6 f32 {n1} x {n2} x 128 vs plain: max |err| {e6:.3g} (1e-5), "
        f"{n_flip} index differences ({n_flip_clear} with a clear best, expected 0); "
        f"{rec['ms']:.4f} ms, device {rec['device_ms']:.4f}, plain "
        f"{rec['plain_ms']:.4f}, topk(a @ b.T) {rec['library_ms']:.4f}, bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}: {rec.get('bound_rate', 'HBM')})")
    return rec


def hold_two_stage_kernels(img, sc, gates, where):
    """K8 on the image's capped slots and K5 on the 2K compacted slots of
    two-stage sampling, as the XLA route gives them, against their plain
    versions: K8 within 1e-6 of the largest bin, K5's normalized rows
    within 1e-3 and corr > 0.9999.  Returns {name: record}."""
    import torch

    from sfm_tpu_torch.ops import compact, sample
    from sfm_tpu_torch.sift import describe, frontend, orient

    atlas, dets = frontend.detect_stage(img, sc)
    x, y, s, v, sharp = (torch.cat([getattr(d, f) for d in dets])
                         for f in ("x", "y", "scale", "valid", "sharpness"))
    order = frontend._sample_order(v, sharp, sc.sample_cap, [d.x.shape[0] for d in dets])
    x, y, s, v = x[order], y[order], s[order], v[order]
    count = v.sum().to(torch.int32)
    K, n = x.shape[0], int(count)
    e8, h8max = hold_orientation_kernel(atlas, x, y, s, count, gates, where)
    held = {"orientation_histogram_sample": kernel_record(
        "orientation_histogram_sample", e8,
        lambda: sample.orientation_histogram_sample(atlas, x, y, s, count),
        lambda: sample.orientation_histogram_sample_plain(atlas, x, y, s, count),
        f"{K} slots, {n} live, atlas {tuple(atlas.shape)}",
        patch_bytes(atlas, n, 16) + 3 * 4 * n + K * 32 * 4, n * ORI_OPS, plain_reps=5)}
    h = sample.orientation_histogram_sample(atlas, x, y, s, count)
    o1, o2, v2 = orient.orientations_from_histograms(h, v)
    valid2 = torch.cat([v, v2])
    o = compact.compaction_order(valid2)
    x2, y2, s2, ori = (torch.cat([a, b])[o] for a, b in ((x, x), (y, y), (s, s), (o1, o2)))
    c2 = valid2.sum().to(torch.int32)
    n2 = int(c2)
    rk = describe.normalize_descriptors(sample.descriptor_sample(atlas, x2, y2, s2, ori, c2))
    rp = describe.normalize_descriptors(
        sample.descriptor_sample_plain(atlas, x2, y2, s2, ori, c2))
    e5 = float((rk - rp).abs().max())
    corr = float((rk * rp).sum(1)[:n2].min())
    gates.check(e5 <= 1e-3 and corr > 0.9999, f"{where}: K5 max err {e5}, min corr {corr}")
    gates.check(not bool(rk[n2:].any()), f"{where}: K5 rows >= count not zero")
    held["descriptor_sample"] = kernel_record(
        "descriptor_sample", e5,
        lambda: sample.descriptor_sample(atlas, x2, y2, s2, ori, c2),
        lambda: sample.descriptor_sample_plain(atlas, x2, y2, s2, ori, c2),
        f"{2 * K} slots, {n2} live", patch_bytes(atlas, n2, 40) + 4 * 4 * n2
        + 2 * K * 128 * 4, n2 * DESC_OPS, plain_reps=5)
    held["descriptor_sample"]["min_corr"] = corr
    log(f"{where}: K8 on {K} slots ({n} live) max |err| {e8:.3g} of max |h| "
        f"{h8max:.4g} (1e-6 relative), {held['orientation_histogram_sample']['ms']:.4f}"
        f" ms, device {held['orientation_histogram_sample']['device_ms']:.4f}; K5 on "
        f"{2 * K} slots ({n2} live) max |err| {e5:.3g} (1e-3), min corr {corr:.7f} "
        f"(> 0.9999), {held['descriptor_sample']['ms']:.4f} ms, device "
        f"{held['descriptor_sample']['device_ms']:.4f}")
    return held


def closed_form_solvers(pair, cfg, gates, dev, card):
    """Phase 12 (e): ``svd3x3(method="analytic")`` against ``"jacobi"`` on
    the bench path's 1,536-hypothesis 8-point bank (the denormalized
    null vectors that ``project_to_essential`` decomposes), and
    ``triangulate(solver="adj")`` against ``"jacobi"`` on its 2,560
    compacted correspondences at the pose the path recovers, with ms and
    launches of each.  Gates: the two largest singular values within
    1e-4 of the largest, the third as its square (both solvers compute
    the eigenvalues of E^T E; a third singular value near 0 is the
    square root of their rounding); the finite points of the matched
    correspondences equal as sets, and within 1e-3 relative on the
    points the pose keeps (an outlier's near-degenerate DLT system has
    no well-defined null vector in f32)."""
    import torch

    from sfm_tpu_torch.geometry import camera, epipolar, ransac, triangulate
    from sfm_tpu_torch.models import two_view
    from sfm_tpu_torch.ops import linalg
    from sfm_tpu_torch.utils.precision import f32_precision

    img1 = torch.as_tensor(pair["img1"], device=dev)
    img2 = torch.as_tensor(pair["img2"], device=dev)
    K = torch.as_tensor(pair["K"], device=dev)
    uv1, uv2, mask = two_view.frontend_stage(img1, img2, cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    res = two_view.two_view_geometry(uv1, uv2, mask, K, cfg, generator=gen)
    K_inv = camera.inv_intrinsics(K)
    x1, x2 = camera.normalize_points(uv1, K_inv), camera.normalize_points(uv2, K_inv)
    rc = cfg.ransac
    # The bank of the seed-0 run: its draws come first from the generator.
    gen.manual_seed(0)
    m_r = mask & (torch.sum((uv1 - uv2) ** 2, dim=-1) > rc.min_disparity_px ** 2)
    with f32_precision():
        T1 = epipolar.normalizing_transform(x1, m_r)
        T2 = epipolar.normalizing_transform(x2, m_r)
        idx = ransac.sample_minimal_sets(gen, m_r, rc.n_hyps)
        A = epipolar.eight_point_matrix((x1 @ T1.T)[idx], (x2 @ T2.T)[idx])
        E = epipolar.denormalize_E(linalg.qr_nullvec(A).reshape(-1, 3, 3), T1, T2)
    out = {}
    s_j = linalg.svd3x3(E, sweeps=rc.sweeps)[1]
    s_a = linalg.svd3x3(E, method="analytic")[1]
    s_rel = (s_a - s_j).abs() / s_j[:, :1]
    s_err = float(s_rel[:, :2].max())
    s3_sq_err = float(((s_a[:, 2] ** 2 - s_j[:, 2] ** 2).abs() / s_j[:, 0] ** 2).max())
    P1 = torch.cat([torch.eye(3, device=dev), torch.zeros((3, 1), device=dev)], 1)
    P2 = torch.cat([res.R, res.t[:, None]], 1)
    Xj, _, fj = triangulate.triangulate(x1, x2, P1, P2)
    Xa, _, fa = triangulate.triangulate(x1, x2, P1, P2, solver="adj")
    same_sets = bool(torch.equal(fj[mask], fa[mask]))
    rel = (Xa - Xj).norm(dim=-1) / Xj.norm(dim=-1).clamp(min=1e-12)
    m = res.point_valid & fj
    x_err = float(rel[m].max())
    share_matched = float((rel[mask & fj] <= 1e-3).float().mean())
    for name, fn in (("svd3x3_jacobi", lambda: linalg.svd3x3(E, sweeps=rc.sweeps)),
                     ("svd3x3_analytic", lambda: linalg.svd3x3(E, method="analytic")),
                     ("triangulate_jacobi",
                      lambda: triangulate.triangulate(x1, x2, P1, P2)),
                     ("triangulate_adj",
                      lambda: triangulate.triangulate(x1, x2, P1, P2, solver="adj"))):
        n_k, dev_ms = profile_launches(fn)
        out[name] = {"ms": cuda_ms(fn), "launches": n_k, "device_ms": dev_ms}
    out.update({"bank": E.shape[0], "correspondences": x1.shape[0],
                "matched": int(mask.sum()), "kept_finite": int(m.sum()),
                "s12_max_rel_err": s_err, "s3_max_rel_err": float(s_rel[:, 2].max()),
                "s3_squared_max_rel_err": s3_sq_err, "finite_sets_equal": same_sets,
                "kept_point_max_rel_err": x_err,
                "matched_share_within_1e-3": share_matched})
    log(f"closed-form solvers ({card}): svd3x3 on the {E.shape[0]}-hypothesis bank, "
        f"analytic vs jacobi: s1, s2 max rel err {s_err:.3g} (1e-4), s3 "
        f"{out['s3_max_rel_err']:.3g}, s3^2 {s3_sq_err:.3g} (1e-4); triangulate on "
        f"{x1.shape[0]} correspondences ({int(mask.sum())} matched, {int(m.sum())} "
        f"kept by the pose), adj vs jacobi: finite sets equal {same_sets}, max rel err "
        f"on the kept {x_err:.3g} (1e-3), matched within 1e-3 {share_matched:.4f}; "
        + "; ".join(
            f"{k} {v['ms']:.4f} ms, {v['launches']} launches, device "
            f"{v['device_ms']:.4f} ms" for k, v in out.items() if isinstance(v, dict)))
    gates.check(s_err <= 1e-4 and s3_sq_err <= 1e-4,
                f"svd3x3 analytic vs jacobi: {s_err}, s3^2 {s3_sq_err}")
    gates.check(same_sets, "triangulate adj vs jacobi: finite sets differ")
    gates.check(x_err <= 1e-3, f"triangulate adj vs jacobi: {x_err}")
    return out


def xla_phase(pair, rpair, up, gates, dev, card):
    """Phase 12: the XLA routes.  Returns (result, launches of its main
    paths, {path: {kernel name: record}})."""
    import dataclasses

    import torch

    from sfm_tpu_torch.sift import frontend

    cfg = slice_config()
    bench, launches, xcfg = xla_bench_path(pair, cfg, gates, dev, card)
    ups, up_launches, (u1, u2) = xla_upscale_paths(rpair, up, gates, dev, card)
    for k, n in up_launches.items():
        launches[k] += n
    img1 = torch.as_tensor(pair["img1"], device=dev)
    api = xla_module_api(img1, xcfg.sift, gates)
    s1, s2 = (frontend.extract_sift(torch.as_tensor(pair[k], device=dev), xcfg.sift)
              for k in ("img1", "img2"))
    held = {"xla_route": {"match_top2": hold_k6_f32(s1, s2, gates, "XLA route bench"),
                          **hold_two_stage_kernels(img1, xcfg.sift, gates,
                                                   "XLA route bench")},
            "xla_upscale": {"match_top2": hold_k6_f32(u1, u2, gates, "XLA route up-scale"),
                            **hold_two_stage_kernels(
                                torch.as_tensor(rpair["img1"], device=dev),
                                dataclasses.replace(upscale_config(), fused_detect=False,
                                                    use_pallas=False),
                                gates, "XLA route up-scale")}}
    solvers = closed_form_solvers(pair, cfg, gates, dev, card)
    return ({"bench": bench, "upscale": ups, "module_api": api, "solvers": solvers},
            launches, held)


def dino(cfg, gates, dev):
    """Phase 13: bench.py's gates on the dino pair, and r5's bar on the
    driver's --turntable run of its 36 ring frames, where present."""
    import torch

    d = os.environ.get("SFM_DINO_DIR")
    if not d:
        log("dino phase skipped: SFM_DINO_DIR is not set")
        return None
    p1, p2 = (os.path.join(d, f"viff.00{i}.ppm") for i in (0, 1))
    if not (os.path.exists(p1) and os.path.exists(p2)):
        log(f"dino fixture absent in {d}: phase skipped")
        return None
    from sfm_tpu_torch.io.image_io import load_gray

    ring = None
    if all(os.path.exists(os.path.join(d, f"viff.{i:03d}.ppm")) for i in range(36)):
        import tempfile

        with tempfile.TemporaryDirectory() as out:
            rc, m, vertices, _, _, ms = run_turntable_driver(d, os.path.join(out, "dino"))
        log(f"dino --turntable: {m['poses_valid']} poses, step {m['tt_step_deg_mean']:.4f}"
            f" +- {m['tt_step_deg_std']:.4f} deg, total {m['tt_total_deg']} deg, "
            f"{m['tt_rms_px']} px, f {m['tt_f_px']}, k1 {m['tt_k1']}; {ms:.0f} ms")
        gates.check(rc == 0, f"dino --turntable: exit code {rc}")
        gate_ring_bar(m, gates, "dino --turntable")
        gates.check(vertices == m["ply_vertices"], "dino --turntable: PLY vertices")
        ring = {"metrics": m, "ms": ms}
    else:
        log(f"dino ring (viff.000-035.ppm) absent in {d}: --turntable skipped")
    img1 = torch.as_tensor(load_gray(p1), device=dev)
    img2 = torch.as_tensor(load_gray(p2), device=dev)
    h, w = img1.shape
    K = torch.tensor([[2360.0, 0, w / 2], [0, 2360.0, h / 2], [0, 0, 1]],
                     device=dev)
    rows = run_pairs(img1, img2, K, cfg, 2360.0, range(8), dev)
    med = {k: median(rows, k) for k in ("matches", "inliers", "valid", "px", "ms")}
    log(f"dino median: {med}")
    gates.check(med["matches"] >= 1100, f"dino median matches {med['matches']}")
    gates.check(med["inliers"] >= 950, f"dino median inliers {med['inliers']}")
    gates.check(med["valid"] >= 950, f"dino median valid {med['valid']}")
    gates.check(med["px"] <= 0.7, f"dino median px {med['px']}")
    for r in rows:
        gates.check(r["valid"] >= 900, f"dino seed {r['seed']} valid {r['valid']}")
        gates.check(r["px"] <= 0.75, f"dino seed {r['seed']} px {r['px']}")
        r.pop("R"), r.pop("t")
    return {"median": med, "seeds": rows, "turntable": ring}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from sfm_tpu_torch.ops import _cuda
    from synthetic_pair import rotation_pair, synthetic_pair

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {card}")

    t0 = time.perf_counter()
    lib = _cuda.library()
    log(f"build: {lib.path.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.build_log.splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            log("  ptxas: " + line.strip())

    gates = Gates()
    cfg = slice_config()
    pair = synthetic_pair(576, 720, seed=0)
    t0 = time.perf_counter()
    rpair = rotation_pair(960, 1280, seed=0)
    log(f"rotation pair rendered in {time.perf_counter() - t0:.1f} s")
    img1 = torch.as_tensor(pair["img1"], device=dev)
    held = {"bench": hold_kernels(img1, torch.as_tensor(pair["img2"], device=dev),
                                  cfg.sift, gates, "bench path")}
    odd = check_odd_scale_down(img1, gates)
    nine = hold_k3_nine_octaves(img1, gates)
    wide = hold_k3_planes(img1, gates)
    launches = {}
    launches["bench"], med, rows = end_to_end(pair, cfg, gates, dev, card)
    held["pair_geometry"] = hold_refine(pair, cfg, gates, dev)
    up, held["upscale"] = upscale_path(rpair, gates, dev, card)
    launches["upscale"] = up["launches"]
    low = upscale_lowest_path(rpair, up, gates, dev, card)
    launches["upscale_lowest"] = low["launches"]
    api, launches["module_api"], held["module_api"] = module_api(img1, cfg.sift,
                                                                  gates, dev)
    win = upscale_window_path(rpair, up, gates, dev, card)
    launches["upscale_window"] = win["launches"]
    cli_res, launches["cli"] = cli_phase(pair, rpair, gates, dev, card)
    seq_res, launches["sequence"] = sequence_phase(gates, dev, card)
    held["registration"] = {"pnp_lo": seq_res.pop("pnp_lo")}
    ring_res, launches["ring"] = ring_phase(gates, dev, card)
    dist_res, launches["distributed"] = distributed_phase(seq_res, gates, dev, card)
    xla_res, launches["xla_route"], held_x = xla_phase(pair, rpair, up, gates, dev, card)
    held.update(held_x)
    # One record per kernel: the largest error over every shape it was
    # held at; times and bounds at the bench path's shapes (K7's at the
    # up-scale path's, K8's at the module API's, the fused route's only
    # main path that launches it); launches summed over the main paths'
    # runs.
    records = []
    for name in KERNEL_SOURCES:
        at = {p: h[name] for p, h in held.items() if name in h}
        rec = dict(at[TIMED_AT.get(name, "bench")])
        rec["max_abs_err"] = max(r["max_abs_err"] for r in at.values())
        rec["held_at"] = at
        rec["launches_by_path"] = {p: n[name] for p, n in launches.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
        gates.check(rec["launches"] > 0, f"kernel {name} launched on no main path")
        records.append(rec)
    dino_res = dino(cfg, gates, dev)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "kernels": records, "median": med,
                   "seeds": rows, "upscale": up, "upscale_lowest_scale_1": low,
                   "k3_nine_octaves": nine, "k3_past_13_planes": wide,
                   "base_chain_odd_and_9_levels": odd, "module_api": api,
                   "upscale_window": win, "cli": cli_res, "sequence": seq_res,
                   "ring": ring_res, "distributed": dist_res,
                   "xla_route": xla_res, "dino": dino_res,
                   "gate_failures": gates.failures}, fh, indent=1, default=float)
    if gates.failures:
        log(f"{len(gates.failures)} gate(s) failed")
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    gated_keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")
    line = []
    for r in records:
        line.append({k: r[k] for k in keys})
        if "composed_conv_ms" in r:   # the base chain's yardstick (several calls)
            line[-1]["composed_conv_ms"] = r["composed_conv_ms"]
        if "gated" in r:   # K3's gated mode, at the bench and up-scale shapes
            line[-1]["gated"] = {p: {k: h["gated"][k] for k in gated_keys}
                                 for p, h in r["held_at"].items() if "gated" in h}
        # The XLA route's shapes (phase 12): K6's f32 mode, K8, K5.
        xla = {p: {k: h[k] for k in gated_keys + ("library_ms", "bound_rate") if k in h}
               for p, h in r["held_at"].items() if p.startswith("xla")}
        if xla:
            line[-1]["f32" if r["name"] == "match_top2" else "xla_route"] = xla
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
