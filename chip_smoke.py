#!/usr/bin/env python3
"""The card's path gates for the PyTorch + CUDA port (``sfm_tpu_torch``):
every main path on one NVIDIA card, held to the JAX package's numbers on
the same inputs and to the rendered truth, with its kernel launches
counted and each kernel it launches held against its plain PyTorch twin
on the path's own inputs.  The kernels' holds at small, ragged and odd
shapes are ``tests/test_torch_cuda.py``'s, kernel times and bounds
``kernel_ab.py``'s, span profiles ``profile_port.py``'s and the paths'
times ``portbench/``'s.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases, each of which fails the run on any error:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the hand-written kernels (``sfm_tpu_torch/csrc``)
   with nvcc for sm_90a and loads them;
3. the bench path: ``two_view_pipeline`` with bench.py's own config
   (``slice_config``) on a 720 x 576 synthetic textured pair
   (``tests/synthetic_pair.py``) over 8 RANSAC seeds, gated against the
   JAX package's numbers on the same pair and the rendered ground-truth
   pose;
4. the up-scale path: tools/bench_upscale.py's up_t2.0 config
   (``upscale_config``: a 1280 x 960 input up-scaled to a 2560 x 1920
   base) on the rotation-only synthetic pair (``rotation_pair``):
   extraction of both images, matching, then bench_upscale's H-fit
   (``ransac_homography`` + ``improve_homography`` + the 3 px count),
   gated against the JAX package's features, candidates and H-fit on
   the same pair and against the pair's exact homography; then the same
   path with ``lowest_scale=1.0`` (K3's gated mode), gated against the
   JAX package's numbers at that configuration, with fewer features than
   the ungated run;
5. the module API at the bench path's width: ``assign_orientations``
   (K8) and ``extract_descriptors(valid=...)`` (K5) on the atlas and
   every detection slot of a real ``detect_stage`` of the 576 x 720
   image, gated against K4's (and K5's) output on the same keypoints;
6. the up-scale path again with ``sample_window=True`` (K9 in place of
   K4): features, matches, H-fit and H error must equal phase 4's;
7. the command-line driver: the synthetic pair written as PGMs and
   ``sfm_tpu_torch.cli.main(["reconstruct", ...])`` in-process at the
   CLI's defaults (the translation re-vote on) over 8 seeds, gated
   against the JAX CLI's numbers on the same PGMs
   (``tests/jax_cli_reference.py``) and the rendered pose; then
   ``sift --up-scale --homography`` on the rotation pair's PGMs, and
   ``sift --max-pts 4096 --up-scale`` (20,480 detection slots) and
   ``sift --octaves 9`` (two K3 launches per image), both with
   ``--homography`` and gated against the JAX CLI; then
   ``run_two_view`` at ``PipelineConfig()`` as it stands;
8. multi-view SfM on a 12-frame 576 x 720 sequence rendered on an arc
   (``tests/synthetic_sequence.py``) at the CLI's defaults: (a)
   ``reconstruct`` of its 12 PGMs through the CLI with ``--checkpoint``
   (PLY vertices = ``num_points``, the checkpoint equal to the run's
   map), (b) ``run_incremental`` on the float frames with the closure
   pair (0, 11), each gated against the JAX package's run on the same
   frames (poses registered, points, px, and ATE and rotation errors
   against the rendered poses); then ``run_ba``'s dense LU and CG on
   (b)'s global BA problem, with camera 0 fixed and with none fixed, and
   on a free 36-camera ring, against a float64 CPU solve (final cost and
   gap; the solver ``run_ba``'s "auto" picks must end within 1e-3 of
   float64);
9. the turntable ring: ``tests/synthetic_ring.py``'s 36 frames of 576
   x 720 (a textured box on a turning disc, 10 degrees per frame,
   radial distortion k1 = -0.45) written as ``viff.000.ppm`` ...
   ``viff.036.ppm``, and the driver users run, ``python -m
   sfm_tpu_torch.tools.reconstruct_dino --dir DIR --turntable`` (its
   ``main`` in-process, through the ring's entry point
   ``models/turntable.py:reconstruct_ring``), at its defaults: 512 points per octave, 1,024
   hypotheses, 30 BA iterations; gated on r5's bar against the rendered
   ring (mean step within 0.2 degrees of 10, std <= 0.3, 360 +- 2
   degrees in all, <= 1.5 px) and against the JAX package's run on the
   same files (px, tracks, kept observations, f, k1's sign, rotation
   errors against the rendered poses), its PLY against its metrics,
   K1-K5 once per frame and K6 once per chain pair and ring pair; then
   ``run_ba``'s dense LU and CG on the run's own free-BA stage (dumped
   by ``SFM_TPU_TT_DUMP``, no camera fixed) against a float64 CPU solve;
10. the distributed layer (``sfm_tpu_torch/parallel/``): (a) on a
   one-rank NCCL mesh in this process, phase 8's 12 PGMs through
   ``reconstruct ... --mesh 1 --checkpoint`` (K6 once per matched pair
   through ``dist_match``, the global BA through ``run_dist_ba``), gated
   as phase 8 (a); then ``dist_match_top2`` at ``__graft_entry__.py``'s
   dry-run shape (4,096 x 4,096) equal to the local K6 bit for bit,
   ``run_dist_ba`` (CG and dense) on that run's global BA problem
   against ``run_ba`` with the same solver (within 1e-6, deterministic
   algorithms on both), and on the dry run's 16-camera rig
   (``tests/ba_problems.py:rig_problem``, 16,384 observations);
   ``make_mesh(2)`` must refuse, naming the one card; (b) two processes
   sharing the card over gloo (``tests/torch_dist_worker.py``): K6 on
   each rank's 2,048 rows, the merged top-2 equal to (a)'s, the rig's BA
   within 1e-3 of (a)'s cost, the same on both ranks;
11. the XLA routes (``SiftConfig(fused_detect=False, use_pallas=False)``
   and ``MatchConfig(use_pallas=False)``: the dense DoG detector,
   two-stage sampling and the f32 matcher): (a) the bench path of phase
   3 on that route over 8 seeds, gated against the JAX package's run of
   the same configuration (``tests/jax_cli_reference.py --parts xla``)
   and the rendered pose; (b) the up-scale path of phase 4 on that route
   at ``lowest_scale`` 0 and 1.0, features and ratio-test matches at
   98-102% of the JAX package's (its numbers are its XLA route's), the
   H error bars of phase 4, the gated run with fewer features; (c)
   ``build_pyramid`` + ``detect`` on the 576 x 720 image against the
   fused route's ``detect_stage`` (counts within 1%, shared keypoints
   within 0.2 px); (d) ``svd3x3(method="analytic")`` against
   ``"jacobi"`` on phase 3's 1,536-hypothesis 8-point bank and
   ``triangulate(solver="adj")`` against ``"jacobi"`` on its 2,560
   compacted correspondences.  The route launches the base chain, K8
   and K5 once per image, K6 once per pair, K7 once per up-scale image,
   and K3, K4 and K9 never;
12. the dino pair, with bench.py's quality gates, when ``SFM_DINO_DIR``
   names a directory holding ``viff.000.ppm`` and ``viff.001.ppm``
   (bench.py's fixture), and the driver's ``--turntable`` run on r5's
   bar where it holds the 36 ring frames; skipped, and said so, when it
   is unset or the files are absent.

Each of the main paths (phases 3 to 11) runs with every launch count set
to 0 just before it and read just after; each must launch every kernel
it goes through, the base chain exactly once per image and K3 once per
image and 8 octaves it extracts, K6 once per matched pair on the
sequence, K10 three times a bench pair, K11 once per frame registered by
PnP, K12 three times a bench pair and twice a ``run_incremental`` (its
bootstrap), and together they launch every kernel (K1 and K2 are one
kernel).

While a path runs, ``capture`` keeps the inputs and outputs of each
kernel wrapper's first call (K10's first two, the probe's and a refine
round's; K11's last, the last frame registered; K12's first three, a
bench pair's, or the first bootstrap's two and the next); after the
path's launches are read, ``hold_kernels`` runs the kernel's plain twin
on the same card tensors and holds the kernel to it (``HOLDS``): the
bench path (the base chain, K3 lean, K4, K5, K6 bf16 at 5,120^2, K10,
K12), the up-scale path (K7, the chain on its 1920 x 2560 base, K3, K4,
K5 and K6 on its 11,776 slots), its gated run (K3 gated), the module
API (K8 and K5 on its 5,120 slots), the window run (K9), the sequence
(K11 on frame 11's own LO inputs, K12 on the bootstraps' own rows) and
the XLA routes' bench and up-scale paths (K8, K5 on two-stage
sampling's slots, K6 f32).  Every kernel must be held on some path.

The last lines of standard output are each kernel's launches by path,
each kernel's largest error against its twin by path (``{"kernels":
...}``), the card's name and power limit, and ``{"ok": true, "device":
{...}}``.  A detailed JSON report goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [p for p in (ROOT, os.path.join(ROOT, "tests")) if p not in sys.path]

# The paths' configurations and the card line, re-exported: the cell
# cudasift_1280x960_up2 cites ``chip_smoke.upscale_config()``.
from path_configs import HFit, card_line, h_fit, slice_config, upscale_config  # noqa: E402,F401

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
# CPU's auto rules).  Phase 11 (a) holds the port's XLA route to 90% of
# each median, px <= JAX / 0.9, and the pose bounds on every seed.
JAX_XLA_MEDIANS = {"matches": 1869.0, "inliers": 1729.0, "valid": 1729.0,
                   "px": 0.14181984844571116}
# Phase 11 (b): the up-scale extraction has no random draws, so on the
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

# Images each main path extracts (phases 3 to 10): 16 bench images; 2
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
# K12 launches: three a bench pair (the two refine rounds' and the
# final vote), two a run_incremental (its bootstrap's) on the paths that
# run it.
PATH_K12 = {"bench": 3 * 8, "sequence": 2 * 2, "ring": 2, "distributed": 2}
PATH_K6 = {"sequence": sequence_matches(SEQ_FRAMES)
           + sequence_matches(SEQ_FRAMES, len(SEQ_CLOSURES)),
           "ring": sequence_matches(RING_FRAMES) + RING_PAIRS,
           "distributed": sequence_matches(SEQ_FRAMES)}
# Kernels each main path must launch (phases 3 to 10).
_BASE = {"base_chain", "detect_maps", "descriptor_sample"}
PATH_KERNELS = {
    "bench": _BASE | {"fused_orient_descriptor", "match_top2", "refine_relative_pose",
                      "recover_pose"},
    "upscale": _BASE | {"scale_up", "fused_orient_descriptor", "match_top2"},
    "module_api": _BASE | {"orientation_histogram_sample"},
    "upscale_window": _BASE | {"scale_up", "fused_orient_descriptor_win",
                               "match_top2"},
    "upscale_lowest": _BASE | {"scale_up", "fused_orient_descriptor", "match_top2"},
    "cli": _BASE | {"scale_up", "fused_orient_descriptor", "match_top2",
                    "refine_relative_pose", "recover_pose"},
    "sequence": _BASE | {"fused_orient_descriptor", "match_top2", "refine_relative_pose",
                         "pnp_lo", "recover_pose"},
    "ring": _BASE | {"fused_orient_descriptor", "match_top2", "pnp_lo", "recover_pose"},
    "distributed": _BASE | {"fused_orient_descriptor", "match_top2", "pnp_lo",
                            "recover_pose"},
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


class Gates:
    def __init__(self):
        self.failures = []

    def check(self, cond, msg):
        if not cond:
            self.failures.append(msg)
            log(f"GATE FAIL: {msg}")


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
    if path in PATH_K12:
        gates.check(launches["recover_pose"] == PATH_K12[path],
                    f"K12 launched {launches['recover_pose']} times on the {path} path, "
                    f"not {PATH_K12[path]}")


def run_pairs(img1, img2, K, cfg, f, seeds, dev):
    """Drive the main path once per seed; per-seed quality."""
    import torch

    from sfm_tpu_torch.models import two_view

    rows = []
    for seed in seeds:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        r = two_view.two_view_pipeline(img1, img2, K, gen, cfg)
        rows.append({
            "seed": seed, "matches": int(r.num_matches),
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
    med = {k: median(rows, k) for k in ("matches", "inliers", "valid", "px", "rot_deg",
                                        "tdir_deg")}
    log(f"{where} median: matches {med['matches']:.0f} inliers {med['inliers']:.0f} "
        f"valid {med['valid']:.0f} px {med['px']:.4f} rot {med['rot_deg']:.4f} "
        f"deg tdir {med['tdir_deg']:.4f} deg")
    for k in ("matches", "inliers", "valid"):
        gates.check(med[k] >= 0.9 * ref[k],
                    f"{where} median {k} {med[k]} < 90% of the JAX package's {ref[k]}")
    gates.check(med["px"] <= ref["px"] / 0.9,
                f"{where} median px {med['px']:.4f} > JAX {ref['px']} / 0.9")
    return med


def bench_path(pair, cfg, ref, gates, dev, where):
    """The bench path (``two_view_pipeline`` at ``cfg``) on the synthetic
    pair over 8 seeds, gated against ``ref``'s medians and the rendered
    pose.  Returns (launches, medians, per-seed rows)."""
    import torch

    from sfm_tpu_torch.ops import _cuda
    from synthetic_pair import pose_errors_deg

    img1, img2, K = (torch.as_tensor(pair[k], device=dev) for k in ("img1", "img2", "K"))
    _cuda.reset_launches()
    rows = run_pairs(img1, img2, K, cfg, float(pair["K"][0, 0]), range(8), dev)
    launches = dict(_cuda.LAUNCHES)
    for r in rows:
        r["rot_deg"], r["tdir_deg"] = pose_errors_deg(r.pop("R"), r.pop("t"),
                                                      pair["R"], pair["t"])
        log(f"{where} seed {r['seed']}: matches {r['matches']} inliers {r['inliers']} "
            f"valid {r['valid']} px {r['px']:.4f} rot {r['rot_deg']:.4f} deg "
            f"tdir {r['tdir_deg']:.4f} deg")
        gates.check(r["finite"], f"{where} seed {r['seed']}: non-finite points")
    med = gate_two_view(rows, ref, gates, where)
    log(f"launches in the {where}'s 8-pair run: {launches}")
    return launches, med, rows


def upscale_run(rpair, cfg, dev, mcfg=None):
    """One up-scale run as bench_upscale drives it, its launches counted
    (set to 0 just before, read just after): extract x2, match
    (``mcfg``, else ``MatchConfig()``), H-fit."""
    import numpy as np
    import torch

    from sfm_tpu_torch.config import MatchConfig
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.sift import frontend
    from sfm_tpu_torch.sift import match as match_mod
    from synthetic_pair import homography_grid_errors, transfer_px

    img1 = torch.as_tensor(rpair["img1"], device=dev)
    img2 = torch.as_tensor(rpair["img2"], device=dev)
    _cuda.reset_launches()
    s1 = frontend.extract_sift(img1, cfg)
    s2 = frontend.extract_sift(img2, cfg)
    m = match_mod.match(s1.descriptors, s2.descriptors, s1.keypoints.valid,
                        s2.keypoints.valid, mcfg or MatchConfig())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    fit = h_fit(s1, s2, m, gen)
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
           "launches": launches, "finite": bool(torch.isfinite(fit.H).all())}
    return res


def _log_upscale(res, rpair, where):
    h, w = rpair["img1"].shape
    log(f"{where} {w}x{h} -> {2 * w}x{2 * h}: features {res['n1']} / {res['n2']}, "
        f"ratio-test matches {res['matches']}, H-fit candidates {res['candidates']} "
        f"({res['wrong_candidates']} > 3 px off H_gt), H-fit {res['numfit']}; H vs "
        f"H_gt on a 16x12 grid: median {res['h_median_px']:.4f} px, max "
        f"{res['h_max_px']:.4f} px")
    log(f"launches in the {where} run: {res['launches']}")


def gate_upscale(res, jax_ref, gates, where, band=None):
    """An up-scale run against the JAX package's numbers ``jax_ref``:
    features, candidates and H-fit at 90% (features and ratio-test
    matches within ``band`` of them where given), and the H error bars;
    the run's ``where``."""
    gates.check(res["finite"], f"{where}: non-finite H")
    for k in ("n1", "n2", "matches", "candidates", "numfit"):
        if band is not None and k in ("n1", "n2", "matches"):
            lo, hi = band
            gates.check(lo * jax_ref[k] <= res[k] <= hi * jax_ref[k],
                        f"{where}: {k} {res[k]} outside {lo:.0%}-{hi:.0%} of the JAX "
                        f"package's {jax_ref[k]}")
        elif k != "matches":
            gates.check(res[k] >= 0.9 * jax_ref[k], f"{where}: {k} {res[k]} < 90% of "
                        f"the JAX package's {jax_ref[k]}")
    gates.check(res["h_median_px"] <= MAX_H_MEDIAN_PX,
                f"{where}: H median error {res['h_median_px']:.4f} px")
    gates.check(res["h_max_px"] <= MAX_H_MAX_PX,
                f"{where}: H max error {res['h_max_px']:.4f} px")


def upscale_path(rpair, gates, dev, ref=None):
    """Phase 4: up_t2.0 extraction -> matching -> H-fit on the rotation
    pair; with an ungated run ``ref``, the same with ``lowest_scale=1.0``
    (K3's gated mode, octave o gated at 1 / 2**o), gated against the JAX
    package's numbers at that configuration, with fewer features than
    ``ref``."""
    import dataclasses

    lowest = 0.0 if ref is None else 1.0
    where = "up-scale" + (f" lowest_scale={lowest}" if lowest else "")
    res = upscale_run(rpair, dataclasses.replace(upscale_config(), lowest_scale=lowest), dev)
    _log_upscale(res, rpair, where)
    gate_upscale(res, JAX_UPSCALE_LOWEST if lowest else JAX_UPSCALE, gates, where)
    if ref is not None:
        gates.check(res["n1"] + res["n2"] < ref["n1"] + ref["n2"],
                    f"{where}: features {res['n1']} / {res['n2']}, not fewer than the "
                    f"ungated {ref['n1']} / {ref['n2']}")
    check_path_launches("upscale_lowest" if lowest else "upscale", res["launches"], gates)
    return res


def upscale_window_path(rpair, ref, gates, dev):
    """Phase 6: the up-scale path with ``sample_window=True`` (K9 in
    place of K4); the same features, matches, H-fit and H error as the
    K4 run ``ref``."""
    import dataclasses

    cfg = dataclasses.replace(upscale_config(), sample_window=True)
    res = upscale_run(rpair, cfg, dev)
    _log_upscale(res, rpair, "up-scale sample_window=True")
    for k in ("n1", "n2", "matches", "candidates", "wrong_candidates", "numfit",
              "h_median_px", "h_max_px"):
        gates.check(res[k] == ref[k], f"up-scale sample_window=True: {k} "
                    f"{res[k]} != the K4 run's {ref[k]}")
    check_path_launches("upscale_window", res["launches"], gates)
    gates.check(res["launches"]["fused_orient_descriptor"] == 0,
                "up-scale sample_window=True went through K4")
    return res


def module_api(img, sc, gates):
    """Phase 5: ``assign_orientations`` (K8) and ``extract_descriptors
    (valid=...)`` (K5) on the atlas and every detection slot of a real
    ``detect_stage``, against K4 and K5 on the same keypoints.  Returns
    (result, launches)."""
    import torch

    from sfm_tpu_torch.ops import _cuda, compact, sample
    from sfm_tpu_torch.sift import describe, frontend, orient

    _cuda.reset_launches()
    atlas, dets = frontend.detect_stage(img, sc)
    x, y, s, v = (torch.cat([getattr(d, f) for d in dets])
                  for f in ("x", "y", "scale", "valid"))
    o1, o2, v2 = orient.assign_orientations(atlas, x, y, s, v, use_pallas=True)
    da = describe.extract_descriptors(atlas, x, y, s, o1, valid=v, use_pallas=True)
    db = describe.extract_descriptors(atlas, x, y, s, o2, valid=v2, use_pallas=True)
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

    n_live = int(count)

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
        f"(gates >= 0.99)")
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
            "descriptor_agreement": frac_d1, "duplicate_agreement": frac_d2}, launches


def _ply_vertices(path) -> int:
    with open(path, "rb") as fh:
        head = fh.read(4096).split(b"end_header")[0].decode()
    return int(next(line.split()[2] for line in head.splitlines()
                    if line.startswith("element vertex")))


def cli_phase(pair, rpair, gates, dev):
    """Phase 7: ``python -m sfm_tpu_torch`` in-process on PGMs of the
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
            f"{r['tdir_deg']:.4f} deg (PLY {r['ply_vertices']} vertices)")
        gates.check(r["rc"] == 0, f"cli seed {r['seed']}: exit code {r['rc']}")
        gates.check(r["ply_vertices"] == r["valid"],
                    f"cli seed {r['seed']}: PLY holds {r['ply_vertices']} vertices, "
                    f"num_points {r['valid']}")
        gates.check(r["device"] == torch.cuda.get_device_name(0),
                    f"cli seed {r['seed']}: ran on {r['device']}")
    med = gate_two_view(rows, JAX_CLI_MEDIANS, gates, "cli reconstruct")
    # The sift demo's features against the port's own extraction at the
    # CLI's configuration on the unquantized pair: the CLI keeps the
    # default sample_cap (2,560 slots, so at most 5,120 features), where
    # phase 4's up_t2.0 config keeps 16,384.
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
            "h_median_px": float(np.median(grid)), "h_max_px": float(grid.max())}
        opts = " ".join(JAX_CLI_SIFT[name][0])
        log(f"cli sift {opts} --homography on the rotation pair's PGMs: features "
            f"{r['features']} (JAX CLI {list(jref)}), matches {r['matches']}, "
            f"homography inliers {r['homography_inliers']}, H vs H_gt median "
            f"{r['h_median_px']:.4f} px, max {r['h_max_px']:.4f} px")
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
    r = two_view.run_two_view(*imgs, PipelineConfig(), seed=0)
    dflt = {"seed": 0, "matches": int(r.num_matches), "inliers": int(r.num_inliers),
            "valid": int(r.point_valid.sum()),
            "px": math.sqrt(max(float(r.reproj_err), 0.0) / 2.0) * float(pair["K"][0, 0]),
            "finite": bool(torch.isfinite(r.points).all())}
    dflt["rot_deg"], dflt["tdir_deg"] = pose_errors_deg(
        r.R.cpu().numpy(), r.t.cpu().numpy(), pair["R"], pair["t"])
    log(f"run_two_view at PipelineConfig(): matches {dflt['matches']} inliers "
        f"{dflt['inliers']} valid {dflt['valid']} px {dflt['px']:.4f} rot "
        f"{dflt['rot_deg']:.4f} deg tdir {dflt['tdir_deg']:.4f} deg")
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


# Each kernel's wrapper and its plain PyTorch twin.  The main paths run
# with the wrappers captured (``capture``); each captured call is then
# held against the twin on the same card tensors (``hold_kernels``) at
# the tolerances below, the ones ``tests/test_torch_cuda.py`` holds the
# kernels to at small, ragged and odd shapes.
KERNEL_PLAIN = {name: ("sfm_tpu_torch." + mod, wrapper, twin) for name, mod, wrapper, twin in (
    ("scale_up", "ops.pyramid", "scale_up", "scale_up_plain"),
    ("base_chain", "ops.pyramid", "base_chain", "base_chain_plain"),
    ("detect_maps", "ops.detect", "detect_maps_octaves", "detect_maps_plain"),
    ("fused_orient_descriptor", "ops.sample", "fused_orient_descriptor",
     "fused_orient_descriptor_plain"),
    ("fused_orient_descriptor_win", "ops.sample", "fused_orient_descriptor_win",
     "fused_orient_descriptor_plain"),
    ("descriptor_sample", "ops.sample", "descriptor_sample", "descriptor_sample_plain"),
    ("orientation_histogram_sample", "ops.sample", "orientation_histogram_sample",
     "orientation_histogram_sample_plain"),
    ("match_top2", "ops.match", "match_top2", "match_top2_plain"),
    ("refine_relative_pose", "geometry.refine", "refine_relative_pose",
     "refine_relative_pose_plain"),
    ("pnp_lo", "geometry.pnp", "pnp_lo", "pnp_lo_plain"),
    ("recover_pose", "geometry.pose", "recover_pose", "recover_pose_plain"))}


def _rebind(old, new):
    """Point every module-level name of the port, and every value of a
    module-level dict, that holds ``old`` at ``new``."""
    for name, mod in list(sys.modules.items()):
        if not name.startswith("sfm_tpu_torch"):
            continue
        for k, v in list(vars(mod).items()):
            if v is old:
                setattr(mod, k, new)
            elif isinstance(v, dict):
                for dk in [dk for dk, dv in v.items() if dv is old]:
                    v[dk] = new


@contextlib.contextmanager
def capture(*names):
    """Keep, for each kernel in ``names`` (every kernel if none), the
    inputs and outputs of its wrapper's first call inside the block,
    cloned (K10: its first two, the probe's and a refine round's; K11:
    its last, the last frame registered; K12: its first three).  Yields
    {kernel: [(args, kwargs, outputs)]}."""
    import importlib

    import torch

    def clone(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, dict):
            return {k: clone(a) for k, a in v.items()}
        if isinstance(v, (list, tuple)):
            items = [clone(a) for a in v]
            return type(v)(*items) if hasattr(v, "_fields") else type(v)(items)
        return v

    calls, swaps = {}, []
    for name in names or KERNEL_PLAIN:
        mod, wrapper, _ = KERNEL_PLAIN[name]
        fn = getattr(importlib.import_module(mod), wrapper)
        keep = {"refine_relative_pose": 2, "recover_pose": 3}.get(name, 1)

        def wrapped(*args, _fn=fn, _name=name, _keep=keep, **kwargs):
            out = _fn(*args, **kwargs)
            got = calls.setdefault(_name, [])
            if _name == "pnp_lo":
                got.clear()
            if len(got) < _keep:
                got.append(clone((args, kwargs, out)))
            return out

        _rebind(fn, wrapped)
        swaps.append((fn, wrapped))
    try:
        yield calls
    finally:
        for fn, wrapped in swaps:
            _rebind(wrapped, fn)


def _count(args, kwargs, pos, rows):
    c = args[pos] if len(args) > pos else kwargs.get("count")
    return rows if c is None else int(c)


def _hold_close(plain, args, kwargs, out):
    """K7: within 1e-4."""
    e = float((out - plain(*args, **kwargs)).abs().max())
    return e, None if e <= 1e-4 else f"max |err| {e} > 1e-4"


def _hold_chain(plain, args, kwargs, out):
    """The base chain: bit for bit."""
    ref = plain(*args, **kwargs)
    n = sum(int((a != b).sum()) for a, b in zip(out, ref))
    e = max(float((a - b).abs().max()) for a, b in zip(out, ref))
    return e, None if n == 0 else f"{n} values differ"


def _hold_k3(plain, args, kwargs, out):
    """K3 per octave: the gated mode bit for bit; the lean mode's
    candidate pixels within max(2, 0.1%), their maps within 1e-4."""
    import numpy as np

    bases, taps, thresh, edge, *rest = args
    g = rest[0] if rest else kwargs.get("scale_gate", 0.0)
    gs = [float(g)] * len(bases) if np.ndim(g) == 0 else list(g)
    n_diff = mism = n_cand = 0
    err = 0.0
    for (rk, ak), b, tp, gate in zip(out, bases, taps, gs):
        lean = ak.shape[0] == 11
        rp, ap = plain(b, tp, thresh, edge, gate, lean)
        n_diff += int((rk != rp).sum()) + int((ak != ap).sum())
        ck, cp = rk > 0, rp > 0
        mism += int((ck != cp).sum())
        n_cand += int(cp.sum())
        both = ck & cp
        if both.any():
            err = max(err, float((rk - rp)[both].abs().max()),
                      float((ak - ap)[:, both].abs().max()))
    if not lean:
        return err, None if n_diff == 0 else f"gated: {n_diff} values differ"
    ok = mism <= max(2, 0.001 * n_cand) and err <= 1e-4
    return err, None if ok else f"{mism} of {n_cand} candidate pixels differ, max |err| {err}"


def _normalized(d):
    from sfm_tpu_torch.sift.describe import normalize_descriptors

    return normalize_descriptors(d)


def _hold_fused(plain, args, kwargs, out):
    """K4 and K9: 99.5% of live rows within 1e-3 (normalized) and 0.01
    deg, duplicates agreeing on 99.5%, rows >= count zero."""
    d1k, o1k, _, dk = out
    d1p, o1p, _, dp = plain(*args, **kwargs)
    n = _count(args, kwargs, 4, d1k.shape[0])
    row = (_normalized(d1k) - _normalized(d1p)).abs().amax(1)[:n]
    ori = ((o1k - o1p + 180.0) % 360.0 - 180.0).abs()[:n]
    share = float(((row <= 1e-3) & (ori <= 0.01)).float().mean())
    dup = float((dk == dp)[:n].float().mean())
    ok = share >= 0.995 and dup >= 0.995 and not bool(d1k[n:].any())
    return float(row.max()), None if ok else f"rows {share}, dup {dup} of {n}"


def _hold_desc(plain, args, kwargs, out):
    """K5: normalized rows within 1e-3, rows >= count zero."""
    n = _count(args, kwargs, 5, out.shape[0])
    e = float((_normalized(out) - _normalized(plain(*args, **kwargs))).abs().max())
    ok = e <= 1e-3 and not bool(out[n:].any())
    return e, None if ok else f"max |err| {e} (1e-3) on {n} rows"


def _hold_hist(plain, args, kwargs, out):
    """K8: within 1e-6 of the largest bin, rows >= count zero."""
    ref = plain(*args, **kwargs)
    n = _count(args, kwargs, 4, out.shape[0])
    e, top = float((out - ref).abs().max()), float(ref.abs().max())
    ok = e <= 1e-6 * top and not bool(out[n:].any())
    return e, None if ok else f"max |err| {e} of max |h| {top}"


def _hold_match(plain, args, kwargs, out):
    """K6: bf16 scores within 1e-4 and the argmax on 99.9% of the rows
    with a descriptor; f32 (TF32 off in the twin) within 1e-5 and the
    same index wherever the best leads the second by more."""
    from sfm_tpu_torch.utils.precision import f32_precision

    bf16 = kwargs.get("bf16", True)
    with contextlib.nullcontext() if bf16 else f32_precision():
        bp, sp, ip = plain(*args, **kwargs)
    bk, sk, ik = out
    e = max(float((bk - bp).abs().max()), float((sk - sp).abs().max()))
    if bf16:
        agree = float((ik == ip)[args[0].abs().amax(1) > 0].float().mean())
        ok = e <= 1e-4 and agree >= 0.999
        return e, None if ok else f"bf16 max |err| {e} (1e-4), argmax agreement {agree}"
    flips = int(((ik != ip) & ((bp - sp) > 1e-5)).sum())
    ok = e <= 1e-5 and flips == 0
    return e, None if ok else f"f32 max |err| {e} (1e-5), {flips} clear rows differ"


def _to64(v):
    return v.double() if hasattr(v, "double") else v


def _hold_refine(plain, args, kwargs, out):
    """K10 and the plain f32 route, each against the plain route in
    float64: K10's error there within the f32 route's plus 1e-4
    relative in the costs, 5e-4 deg in R and 1.5e-3 deg in t."""
    from synthetic_pair import pose_errors_deg

    p = plain(*args, **kwargs)
    p64 = plain(*map(_to64, args), **{k: _to64(v) for k, v in kwargs.items()})
    fails = []
    for name in ("cost", "initial_cost"):
        exact = getattr(p64, name).double()
        e_k, e_p = ((getattr(r, name).double() - exact).abs() / exact.abs() for r in (out, p))
        if not bool((e_k <= e_p + 1e-4).all()):
            fails.append(f"{name} {e_k.tolist()} vs {e_p.tolist()}")
    host = lambda r: (r.R.cpu().numpy().reshape(-1, 3, 3), r.t.cpu().numpy().reshape(-1, 3))
    for name, a_k, a_p, tol in zip(("R", "t"), pose_errors_deg(*host(out), *host(p64)),
                                   pose_errors_deg(*host(p), *host(p64)), (5e-4, 1.5e-3)):
        if not (a_k <= a_p + tol).all():
            fails.append(f"{name} {a_k.tolist()} deg vs {a_p.tolist()} + {tol}")
    e = max(float((out.R - p.R).abs().max()), float((out.t - p.t).abs().max()))
    return e, "; ".join(fails) or None


def _hold_lo(plain, args, kwargs, out):
    """K11 and the plain f32 route, each against the plain route in
    float64: K11's rotation error within the f32 route's plus 1e-4 deg,
    its translation's relative error within it plus 5e-6, the strict
    counts within a row or 0.1%."""
    from synthetic_pair import pose_errors_deg

    x, Xn, mask, R0, t0 = args
    p = plain(*args, **kwargs)
    p64 = plain(x.double(), Xn.double(), mask, R0.double(), t0.double(), **kwargs)
    host = lambda r: (r[0].cpu().numpy(), r[1].cpu().numpy())
    rot_k, rot_p = (pose_errors_deg(*host(r), *host(p64))[0] for r in (out, p))
    t_k, t_p = (float((r[1].double() - p64[1]).norm() / p64[1].norm()) for r in (out, p))
    c_k, c_p = int(out[3]), int(p[3])
    ok = (rot_k <= rot_p + 1e-4 and t_k <= t_p + 5e-6
          and abs(c_k - c_p) <= max(1, c_p // 1000))
    e = max(float((out[0] - p[0]).abs().max()), float((out[1] - p[1]).abs().max()))
    return e, None if ok else (f"R {rot_k} vs {rot_p} deg, t {t_k} vs {t_p}, counts "
                               f"{c_k} vs {c_p}")


def _hold_pose(plain, args, kwargs, out):
    """K12 and the plain f32 route, each against the plain route in
    float64: the same votes (as a set: the paths' E have two equal
    singular values, so the rounding orders the candidates), the
    winner's R and t within 1e-5 of the plain route's and no further
    from float64 than it plus 1e-5, front / finite flips on <= 0.1% of
    the rows, the points' median relative gap <= 1e-5 where both are
    finite."""
    import torch

    p = plain(*args, **kwargs)
    p64 = plain(*map(_to64, args), **{k: _to64(v) for k, v in kwargs.items()})
    gap = lambda a, b: max(float((a["R"].double() - b["R"].double()).abs().max()),
                           float((a["t"].double() - b["t"].double()).abs().max()))
    n = out["front"].shape[0]
    flips = int((out["front"] != p["front"]).sum() + (out["finite"] != p["finite"]).sum())
    both = out["finite"] & p["finite"]
    Xk, Xp = out["points"][both].double(), p["points"][both].double()
    rel = float(((Xk - Xp).norm(dim=1) / Xp.norm(dim=1).clamp(min=1e-30)).median()) \
        if bool(both.any()) else 0.0
    ok = (torch.equal(out["votes"].sort().values, p["votes"].sort().values)
          and gap(out, p) <= 1e-5 and gap(out, p64) <= gap(p, p64) + 1e-5
          and flips <= 1e-3 * n and rel <= 1e-5)
    return gap(out, p), None if ok else (
        f"votes {out['votes'].tolist()} vs {p['votes'].tolist()}, R/t gap {gap(out, p)} "
        f"(float64: {gap(out, p64)} vs {gap(p, p64)}), {flips} flips of {n}, points {rel}")


HOLDS = {"scale_up": _hold_close, "base_chain": _hold_chain, "detect_maps": _hold_k3,
         "fused_orient_descriptor": _hold_fused, "fused_orient_descriptor_win": _hold_fused,
         "descriptor_sample": _hold_desc, "orientation_histogram_sample": _hold_hist,
         "match_top2": _hold_match, "refine_relative_pose": _hold_refine,
         "pnp_lo": _hold_lo, "recover_pose": _hold_pose}


def hold_kernels(calls, gates, where):
    """Each call ``capture`` kept against the kernel's plain twin on the
    same tensors.  Returns {kernel: max |err|}."""
    import importlib

    errs = {}
    for name, got in calls.items():
        mod, _, twin = KERNEL_PLAIN[name]
        plain = getattr(importlib.import_module(mod), twin)
        for i, (args, kwargs, out) in enumerate(got):
            e, fail = HOLDS[name](plain, args, kwargs, out)
            errs[name] = max(errs.get(name, 0.0), e)
            gates.check(fail is None, f"{where}: {name} (call {i}) against its plain "
                        f"twin: {fail}")
    calls.clear()
    log(f"{where}, kernels against their plain twins on the path's own inputs, max "
        f"|err|: {errs}")
    return errs


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
    against a float64 dense solve on the CPU: final costs and the
    relative gap to float64."""
    import torch

    from sfm_tpu_torch.models import bundle_adjust as ba

    def f64(a):
        return a.detach().cpu().double() if a.is_floating_point() else a.cpu()

    M, P = R.shape[0], X.shape[0]
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
                                 "cost_final": c_ref}}
    for solver in ("dense", "cg"):
        fin, costs = ba.run_ba(R, t, X, problem, iters=iters, huber_delta=huber_delta,
                               solver=solver)
        c = float(costs[-1])
        out[solver] = {"cost_initial": float(costs[0]), "cost_final": c,
                       "gap_to_float64": (c - c_ref) / c_ref,
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


def cli_sequence(seq, gates, where, *extra):
    """``reconstruct`` of the sequence's PGMs through the CLI with a map
    checkpoint (and ``extra`` options), its launches counted, gated
    against the JAX CLI's run and the rendered poses: the PLY's vertices
    and the checkpoint against the run.  Returns (result, launches, the
    run's ``_global_ba`` calls)."""
    import io
    import tempfile

    import torch

    from sfm_tpu_torch import cli
    from sfm_tpu_torch.models import incremental
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.utils.checkpoint import load_map
    from synthetic_sequence import write_pgms

    f = float(seq["K"][0, 0])
    with tempfile.TemporaryDirectory() as d:
        paths = write_pgms(d, seq["images"])
        ply, js, npz = (os.path.join(d, n) for n in ("m.ply", "m.json", "m.npz"))
        _cuda.reset_launches()
        with spy(incremental, "run_incremental") as calls, \
                spy(incremental, "_global_ba") as gcalls, \
                contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["reconstruct", *paths, "--focal", f"{f:g}", "--out", ply,
                           "--metrics", js, "--checkpoint", npz, *extra])
        launches = dict(_cuda.LAUNCHES)
        with open(js) as fh:
            m = json.load(fh)
        ckpt, saved = load_map(npz)
        vertices = _ply_vertices(ply)
    same = all(torch.equal(x, y.cpu()) for x, y in zip(ckpt, calls[0][2].state))
    a = {"rc": rc, "device": m["device"], "mesh": m.get("mesh"),
         "poses": m["poses_registered"], "points": m["num_points"],
         "px": m["mean_reproj_px"], "ba_cost_initial": m["ba_cost_initial"],
         "ba_cost_final": m["ba_cost_final"],
         **sequence_quality(ckpt.R, ckpt.t, ckpt.pose_valid, seq),
         "ply_vertices": vertices, "checkpoint_equals_run": same,
         "checkpoint_K": saved["K"],
         "checkpoint_counts_equal": (int(ckpt.pose_valid.sum()) == m["poses_registered"]
                                     and int(ckpt.X_valid.sum()) == m["num_points"])}
    log(f"{where}: {len(seq['images'])} PGMs {' '.join(extra)}: poses {a['poses']} points "
        f"{a['points']} px {a['px']:.4f} ATE {a['ate']:.6f} rotation error median "
        f"{a['rot_median_deg']:.5f} max {a['rot_max_deg']:.5f} deg, BA cost "
        f"{a['ba_cost_initial']:.6g} -> {a['ba_cost_final']:.6g}; PLY {vertices} "
        f"vertices; checkpoint equals the run's map: {same}")
    log(f"launches in the {where} run: {launches}")
    gates.check(rc == 0, f"{where}: exit code {rc}")
    gates.check(a["device"] == torch.cuda.get_device_name(0), f"{where}: ran on {a['device']}")
    gates.check(vertices == a["points"], f"{where}: PLY holds {vertices} vertices, "
                f"num_points {a['points']}")
    gates.check(same, f"{where}: the checkpoint differs from the run's map")
    gate_sequence(a, JAX_SEQUENCE["cli"], gates, where)
    return a, launches, gcalls


def sequence_phase(gates, dev):
    """Phase 8: multi-view SfM on the 12-frame arc sequence
    (``tests/synthetic_sequence.py``, 576 x 720, the CLI's defaults):
    (a) ``reconstruct`` of its 12 PGMs through the CLI with a map
    checkpoint, (b) ``run_incremental`` on the float frames with the
    closure pair (0, 11), each gated against the JAX package's run on
    the same frames and the rendered poses; then the BA solver A/B on
    (b)'s global BA problem.  Returns (result, launches of (a) + (b))."""
    import torch

    from sfm_tpu_torch.config import PipelineConfig, RansacConfig, SiftConfig
    from sfm_tpu_torch.models import incremental
    from sfm_tpu_torch.ops import _cuda
    from synthetic_sequence import synthetic_sequence

    seq = synthetic_sequence(576, 720, n_frames=SEQ_FRAMES)
    f = float(seq["K"][0, 0])
    a, launches_a, _ = cli_sequence(seq, gates, "sequence cli")
    gates.check(a["checkpoint_counts_equal"],
                "sequence cli: the checkpoint's counts differ from the metrics")

    cfg = PipelineConfig(sift=SiftConfig(max_pts_per_octave=1024),
                         ransac=RansacConfig(n_hyps=1024, threshold=3e-6))
    imgs = [torch.as_tensor(im, device=dev) for im in seq["images"]]
    with spy(incremental, "_global_ba") as gcalls:
        res = incremental.run_incremental(imgs, seq["K"], cfg, seed=0, ba_iters=20,
                                          closure_pairs=SEQ_CLOSURES)
    launches = dict(_cuda.LAUNCHES)
    st = res.state
    costs = res.ba_costs.cpu()
    b = {"poses": int(st.pose_valid.sum()), "points": int(st.X_valid.sum()),
         "px": math.sqrt(max(float(res.mean_reproj), 0.0) / 2) * f,
         "ba_cost_initial": float(costs[0]), "ba_cost_final": float(costs[-1]),
         **sequence_quality(st.R, st.t, st.pose_valid, seq),
         "finite": bool(torch.isfinite(st.X).all() and torch.isfinite(costs).all())}
    log(f"sequence (b) run_incremental, closure {SEQ_CLOSURES}: poses {b['poses']} "
        f"points {b['points']} px {b['px']:.4f} ATE {b['ate']:.6f} rotation error "
        f"median {b['rot_median_deg']:.5f} max {b['rot_max_deg']:.5f} deg, BA cost "
        f"{b['ba_cost_initial']:.6g} -> {b['ba_cost_final']:.6g}")
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

    # The BA solver A/B on (b)'s global problem, after the counts were read.
    ab = ba_solver_ab(*gcalls[0][0][:4], iters=20, dev=dev)
    log_solver_ab(ab, gates)
    return {"cli": a, "module": b, "ba_solver_ab": ab, "launches_cli": launches_a}, launches


def log_solver_ab(ab, gates):
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
                f"max |R - R_f64| {r['max_rotation_diff_to_float64']:.2e})")
            gates.check(r["finite"] and r["cost_final"] < r["cost_initial"],
                        f"BA A/B {name} {solver}: cost {r['cost_initial']} -> "
                        f"{r['cost_final']}")
        gap = p[p["auto"]]["gap_to_float64"]
        gates.check(abs(gap) <= 1e-3, f"BA A/B {name}: run_ba's auto solver "
                    f"({p['auto']}) ends {gap:+.3e} from the float64 cost")


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


def run_turntable_driver(d, out, dump=None):
    """``python -m sfm_tpu_torch.tools.reconstruct_dino --dir d --turntable
    --out out`` in-process, its stdout swallowed; ``dump`` sets
    SFM_TPU_TT_DUMP.  Returns (exit code, metrics, PLY vertices, the
    TurntableResult of the ring's entry point, launches after the
    chain, the entry point's calls)."""
    import io

    from sfm_tpu_torch.models import incremental, turntable
    from sfm_tpu_torch.tools import reconstruct_dino

    with contextlib.ExitStack() as stack:
        if dump is not None:
            stack.enter_context(env("SFM_TPU_TT_DUMP", dump))
        chain = stack.enter_context(spy(incremental, "run_incremental"))
        ring = stack.enter_context(spy(turntable, "reconstruct_ring"))
        stack.enter_context(contextlib.redirect_stdout(io.StringIO()))
        rc = reconstruct_dino.main(["--dir", d, "--turntable", "--out", out])
    with open(out + ".metrics.json") as fh:
        m = json.load(fh)
    return rc, m, _ply_vertices(out + ".ply"), ring[0][2], chain[0][3], len(ring)


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


def ring_phase(gates, dev):
    """Phase 9: the turntable driver on the synthetic ring (36 frames of
    576 x 720, k1 = -0.45), gated on r5's bar, against the JAX package's
    run on the same files and against the rendered poses; then the
    free-BA solver A/B on the run's own dump.
    Returns (result, launches of the run)."""
    import tempfile

    import numpy as np

    from sfm_tpu_torch.models import turntable
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.utils import metrics
    from synthetic_ring import synthetic_ring
    from synthetic_sequence import nearest_rotations

    with tempfile.TemporaryDirectory() as d:
        ring = synthetic_ring(576, 720, n_frames=RING_FRAMES, directory=d)
        dump = os.path.join(d, "free_ba.npz")
        _cuda.reset_launches()
        rc, m, vertices, ttr, after_chain, entry_calls = run_turntable_driver(
            d, os.path.join(d, "ring"), dump=dump)
        launches = dict(_cuda.LAUNCHES)
        R, t, X, problem, delta = turntable.free_ba_problem(dump, dev)
    rot = metrics.rotation_errors_deg(nearest_rotations(ttr.R.cpu().numpy()), ring["R"])
    sd = ttr.step_deg.numpy()
    r = {"rc": rc, "poses": m["poses_valid"], "step_mean": float(sd.mean()),
         "step_std": float(sd.std()), "total_deg": ttr.total_deg, "rms_px": ttr.rms_px,
         "f_px": ttr.f, "k1": ttr.k1, "k2": ttr.k2, "tracks": ttr.tracks.n_tracks,
         "obs": int(ttr.tracks.cam_idx.shape[0]), "obs_kept": int(ttr.keep.sum()),
         "rot_median_deg": float(np.median(rot)), "rot_max_deg": float(rot.max()),
         "n_points": m["n_points"], "ply_vertices": vertices, "metrics": m,
         "k6_chain": after_chain["match_top2"],
         "k6_tracks": launches["match_top2"] - after_chain["match_top2"]}
    log(f"ring driver --turntable: {r['poses']} poses, step {r['step_mean']:.4f} +- "
        f"{r['step_std']:.4f} deg, total {r['total_deg']:.3f} deg, {r['rms_px']:.4f} px "
        f"over {r['obs_kept']} of {r['obs']} observations of {r['tracks']} tracks, f "
        f"{r['f_px']:.2f} px, k1 {r['k1']:.4f}; rotation error median "
        f"{r['rot_median_deg']:.4f} max {r['rot_max_deg']:.4f} deg; PLY {vertices} "
        f"vertices")
    log(f"launches in the ring run: {launches} (K6: chain {r['k6_chain']}, ring tracks "
        f"{r['k6_tracks']})")
    gates.check(rc == 0, f"ring driver: exit code {rc}")
    gates.check(entry_calls == 1, f"ring driver: {entry_calls} calls of reconstruct_ring")
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
    log_solver_ab(ab, gates)
    r["ba_solver_ab"] = ab
    return r, launches


def rel_gap(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def dist_ba_ab(R, t, X, problem, mesh, iters, name, gates):
    """run_dist_ba on the mesh against run_ba with the same solver on the
    same inputs (the mesh's partition of the problem; on one rank the
    all-reduce is an identity: gated at 1e-6 in the final cost, R and X)
    and on the problem as it came (the cost gated at 1e-4), all with
    deterministic algorithms (no float atomics in the segment sums)."""
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
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            Rd, _, Xd, cd = dist_ba.run_dist_ba(R, t, X_d, prob_d, mesh, **kw)
            same, cs = ba.run_ba(R, t, X_sh, prob_sh, **kw)
            _, cl = ba.run_ba(R, t, X, problem, **kw)
        finally:
            torch.use_deterministic_algorithms(False)
        Xd = meshmod.gather_sharded(mesh, Xd)
        r = {"cost_initial": float(cd[0]), "cost_final": float(cd[-1]),
             "gap_cost": abs(float(cd[-1]) / float(cs[-1]) - 1),
             "gap_R": rel_gap(Rd, same.R), "gap_X": rel_gap(Xd, same.X),
             "gap_cost_as_it_came": abs(float(cd[-1]) / float(cl[-1]) - 1),
             "finite": bool(torch.isfinite(cd).all()),
             "never_rises": bool((cd[1:] <= cd[:-1]).all())}
        out[solver] = r
        log(f"run_dist_ba {solver} on {name} ({out['cameras']} cameras, {out['points']} "
            f"point slots, {out['observations']} observations, {iters} LM iterations, "
            f"{mesh.backend} mesh of {mesh.size}): cost {r['cost_initial']:.6g} -> "
            f"{r['cost_final']:.6g}; against run_ba on the same inputs (deterministic "
            f"algorithms) gaps cost {r['gap_cost']:.2e}, R {r['gap_R']:.2e}, X "
            f"{r['gap_X']:.2e}; cost against run_ba on the problem as it came "
            f"{r['gap_cost_as_it_came']:.2e}")
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


def distributed_phase(gates, dev):
    """Phase 10: the distributed layer on a one-rank NCCL mesh (the CLI's
    ``--mesh 1`` on the sequence; the dry run's match; BA against
    run_ba), ``make_mesh(2)``'s refusal, then two ranks sharing the card
    over gloo.  Returns (result, launches of the CLI run)."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    from ba_problems import rig_problem
    from sfm_tpu_torch.models import bundle_adjust as ba
    from sfm_tpu_torch.models import incremental
    from sfm_tpu_torch.ops import _cuda
    from sfm_tpu_torch.ops.match import match_top2
    from sfm_tpu_torch.parallel import dist_match, mesh as meshmod
    from synthetic_sequence import synthetic_sequence
    from torch_dist_worker import run_ranks

    # (a) The sequence through the CLI on a one-rank mesh.
    seq = synthetic_sequence(576, 720, n_frames=SEQ_FRAMES)
    a, launches, gcalls = cli_sequence(seq, gates, "distributed cli", "--mesh", "1")
    a["group_closed"] = not tdist.is_initialized()
    gates.check(a["mesh"] == {"size": 1, "backend": "nccl"},
                f"distributed cli: mesh {a['mesh']}, not one NCCL rank")
    gates.check(a["group_closed"], "distributed cli: the process group was left open")
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
        match = {"n1": DRYRUN_N, "n2": DRYRUN_N, "k6_launches": k6, "equal": match_equal}
        log(f"dist_match_top2 {DRYRUN_N} x {DRYRUN_N} on the one-rank mesh: K6 x{k6}, "
            f"equal to the local K6 bit for bit: {match_equal}")
        gates.check(k6 == 1 and match_equal, f"dist_match_top2 on one rank: K6 x{k6}, "
                    f"equal {match_equal}")
        g_args = gcalls[0][0]
        problem = incremental.build_ba_problem(*g_args[:4])
        st = g_args[0]
        ba_seq = dist_ba_ab(st.R, st.t, st.X, problem, mesh, 20,
                            "the sequence's global BA", gates)
        ba_rig = dist_ba_ab(*map(f32, (R0, t0, X0)), rig, mesh, DIST_BA_ITERS,
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
    results, lines = run_ranks(cases, device=str(dev), world=DIST_WORLD,
                               timeout=600)
    b = {"world": DIST_WORLD, "lines": lines,
         "k6_launches_per_rank": [int(r["launches/match_top2"]) for r in results]}
    ref_np = [x.cpu().numpy() for x in ref]
    b["match_equal"] = [bool(all(np.array_equal(r[f"match/dryrun/{k}"], x)
                                 for k, x in zip(("best", "second", "index"), ref_np)))
                        for r in results]
    for solver in ("cg", "dense"):
        c = results[0][f"ba/{solver}/costs"]
        b[solver] = {"cost_initial": float(c[0]), "cost_final": float(c[-1]),
                     "gap_to_one_rank": abs(float(c[-1]) / ba_rig[solver]["cost_final"] - 1),
                     "never_rises": bool(np.all(np.diff(c) <= 0))}
    log(f"distributed (b) {DIST_WORLD} ranks on {torch.cuda.get_device_name(0)} over gloo: "
        f"K6 per rank "
        f"{b['k6_launches_per_rank']} (dist_match_top2 + dist_match on "
        f"{DRYRUN_N // DIST_WORLD} rows each), top-2 equal to (a)'s: {b['match_equal']}; "
        + "; ".join(f"{s} cost {b[s]['cost_initial']:.6g} -> {b[s]['cost_final']:.6g} "
                    f"(gap to one rank {b[s]['gap_to_one_rank']:.2e})"
                    for s in ("cg", "dense")))
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


def xla_upscale_paths(rpair, ref, gates, dev):
    """Phase 11 (b): the up-scale path on the XLA route at lowest_scale 0
    and 1.0: features and ratio-test matches at 98-102% of the JAX
    package's, candidates and H-fit at 90%, phase 4's H error bars, and
    the gated run with fewer features.  Returns ({lowest_scale: result},
    summed launches)."""
    import dataclasses

    from sfm_tpu_torch.config import MatchConfig

    out, launches = {}, {}
    for lowest, jax_ref in ((0.0, JAX_UPSCALE), (1.0, JAX_UPSCALE_LOWEST)):
        cfg = dataclasses.replace(upscale_config(), lowest_scale=lowest,
                                  fused_detect=False, use_pallas=False)
        res = upscale_run(rpair, cfg, dev, MatchConfig(use_pallas=False))
        where = f"XLA route up-scale lowest_scale={lowest}"
        _log_upscale(res, rpair, where)
        gate_upscale(res, jax_ref, gates, where, XLA_UPSCALE_BAND)
        check_xla_launches(where, res["launches"], 2, 1, True, gates)
        for k, n in res["launches"].items():
            launches[k] = launches.get(k, 0) + n
        out[lowest] = res
    gates.check(out[1.0]["n1"] + out[1.0]["n2"] < out[0.0]["n1"] + out[0.0]["n2"],
                f"XLA route up-scale: the gated run's features {out[1.0]['n1']} / "
                f"{out[1.0]['n2']} not fewer than the ungated {out[0.0]['n1']} / "
                f"{out[0.0]['n2']}")
    log(f"XLA route up-scale features against the fused route's (phase 4): "
        f"{out[0.0]['n1']} / {out[0.0]['n2']} vs {ref['n1']} / {ref['n2']}")
    return out, launches


def xla_module_api(img, sc, gates):
    """Phase 11 (c): ``build_pyramid`` + ``detect`` per octave against
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


def closed_form_solvers(pair, cfg, gates, dev):
    """Phase 11 (d): ``svd3x3(method="analytic")`` against ``"jacobi"`` on
    the bench path's 1,536-hypothesis 8-point bank (the denormalized
    null vectors that ``project_to_essential`` decomposes), and
    ``triangulate(solver="adj")`` against ``"jacobi"`` on its 2,560
    compacted correspondences at the pose the path recovers.  Gates: the two largest singular values within
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
    out = {"bank": E.shape[0], "correspondences": x1.shape[0],
           "matched": int(mask.sum()), "kept_finite": int(m.sum()),
           "s12_max_rel_err": s_err, "s3_max_rel_err": float(s_rel[:, 2].max()),
           "s3_squared_max_rel_err": s3_sq_err, "finite_sets_equal": same_sets,
           "kept_point_max_rel_err": x_err, "matched_share_within_1e-3": share_matched}
    log(f"closed-form solvers: svd3x3 on the {E.shape[0]}-hypothesis bank, "
        f"analytic vs jacobi: s1, s2 max rel err {s_err:.3g} (1e-4), s3 "
        f"{out['s3_max_rel_err']:.3g}, s3^2 {s3_sq_err:.3g} (1e-4); triangulate on "
        f"{x1.shape[0]} correspondences ({int(mask.sum())} matched, {int(m.sum())} "
        f"kept by the pose), adj vs jacobi: finite sets equal {same_sets}, max rel err "
        f"on the kept {x_err:.3g} (1e-3), matched within 1e-3 {share_matched:.4f}")
    gates.check(s_err <= 1e-4 and s3_sq_err <= 1e-4,
                f"svd3x3 analytic vs jacobi: {s_err}, s3^2 {s3_sq_err}")
    gates.check(same_sets, "triangulate adj vs jacobi: finite sets differ")
    gates.check(x_err <= 1e-3, f"triangulate adj vs jacobi: {x_err}")
    return out


def xla_phase(pair, rpair, up, gates, dev):
    """Phase 11: the XLA routes.  Returns (result, launches of its main
    paths, {path: its kernels' max |err| against their plain twins})."""
    import torch

    cfg = slice_config()
    xcfg = xla_config(cfg)
    xla_kernels = ("orientation_histogram_sample", "descriptor_sample", "match_top2")
    with capture(*xla_kernels) as calls:
        launches, med, rows = bench_path(pair, xcfg, JAX_XLA_MEDIANS, gates, dev,
                                         "XLA route bench path")
    check_xla_launches("XLA route bench path", launches, 16, 8, False, gates)
    held = {"xla_bench": hold_kernels(calls, gates, "XLA route bench path")}
    with capture(*xla_kernels) as calls:
        ups, up_launches = xla_upscale_paths(rpair, up, gates, dev)
    held["xla_upscale"] = hold_kernels(calls, gates, "XLA route up-scale path")
    for k, n in up_launches.items():
        launches[k] += n
    api = xla_module_api(torch.as_tensor(pair["img1"], device=dev), xcfg.sift, gates)
    solvers = closed_form_solvers(pair, cfg, gates, dev)
    return ({"bench": {"median": med, "seeds": rows}, "upscale": ups, "module_api": api,
             "solvers": solvers}, launches, held)


def dino(cfg, gates, dev):
    """Phase 12: bench.py's gates on the dino pair, and r5's bar on the
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
            rc, m, vertices, *_ = run_turntable_driver(d, os.path.join(out, "dino"))
        log(f"dino --turntable: {m['poses_valid']} poses, step {m['tt_step_deg_mean']:.4f}"
            f" +- {m['tt_step_deg_std']:.4f} deg, total {m['tt_total_deg']} deg, "
            f"{m['tt_rms_px']} px, f {m['tt_f_px']}, k1 {m['tt_k1']}")
        gates.check(rc == 0, f"dino --turntable: exit code {rc}")
        gate_ring_bar(m, gates, "dino --turntable")
        gates.check(vertices == m["ply_vertices"], "dino --turntable: PLY vertices")
        ring = {"metrics": m}
    else:
        log(f"dino ring (viff.000-035.ppm) absent in {d}: --turntable skipped")
    img1 = torch.as_tensor(load_gray(p1), device=dev)
    img2 = torch.as_tensor(load_gray(p2), device=dev)
    h, w = img1.shape
    K = torch.tensor([[2360.0, 0, w / 2], [0, 2360.0, h / 2], [0, 0, 1]],
                     device=dev)
    rows = run_pairs(img1, img2, K, cfg, 2360.0, range(8), dev)
    med = {k: median(rows, k) for k in ("matches", "inliers", "valid", "px")}
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
    from sfm_tpu_torch.ops import _cuda
    from synthetic_pair import rotation_pair, synthetic_pair

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {card}")
    log(f"build: {_cuda.library().path.name}")

    gates = Gates()
    cfg = slice_config()
    pair = synthetic_pair(576, 720, seed=0)
    rpair = rotation_pair(960, 1280, seed=0)
    launches, held = {}, {}
    with capture() as calls:
        launches["bench"], med, rows = bench_path(pair, cfg, JAX_MEDIANS, gates, dev,
                                                  "bench path")
    check_path_launches("bench", launches["bench"], gates)
    held["bench"] = hold_kernels(calls, gates, "bench path")
    with capture() as calls:
        up = upscale_path(rpair, gates, dev)
    launches["upscale"] = up["launches"]
    held["upscale"] = hold_kernels(calls, gates, "up-scale path")
    with capture("detect_maps") as calls:
        low = upscale_path(rpair, gates, dev, ref=up)
    launches["upscale_lowest"] = low["launches"]
    held["upscale_lowest"] = hold_kernels(calls, gates, "up-scale lowest_scale=1.0")
    with capture("orientation_histogram_sample", "descriptor_sample") as calls:
        api, launches["module_api"] = module_api(
            torch.as_tensor(pair["img1"], device=dev), cfg.sift, gates)
    held["module_api"] = hold_kernels(calls, gates, "module API")
    with capture("fused_orient_descriptor_win") as calls:
        win = upscale_window_path(rpair, up, gates, dev)
    launches["upscale_window"] = win["launches"]
    held["upscale_window"] = hold_kernels(calls, gates, "up-scale sample_window=True")
    cli_res, launches["cli"] = cli_phase(pair, rpair, gates, dev)
    with capture("pnp_lo", "recover_pose") as calls:
        seq_res, launches["sequence"] = sequence_phase(gates, dev)
    held["sequence"] = hold_kernels(calls, gates, "sequence, the last frame registered")
    ring_res, launches["ring"] = ring_phase(gates, dev)
    dist_res, launches["distributed"] = distributed_phase(gates, dev)
    xla_res, launches["xla_route"], held_x = xla_phase(pair, rpair, up, gates, dev)
    held.update(held_x)
    # Together the main paths launch every kernel, and hold each against
    # its plain twin.
    by_kernel = {name: {p: n[name] for p, n in launches.items()} for name in _cuda.LAUNCHES}
    kernels = {name: {p: h[name] for p, h in held.items() if name in h}
               for name in _cuda.LAUNCHES}
    for name in _cuda.LAUNCHES:
        gates.check(sum(by_kernel[name].values()) > 0,
                    f"kernel {name} launched on no main path")
        gates.check(bool(kernels[name]), f"kernel {name} held on no main path")
    kernels = {name: {"max_abs_err": max(at.values(), default=None), "held_at": at}
               for name, at in kernels.items()}
    dino_res = dino(cfg, gates, dev)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump({"card": card, "launches": by_kernel, "kernels": kernels, "median": med,
                   "seeds": rows, "upscale": up, "upscale_lowest_scale_1": low,
                   "module_api": api, "upscale_window": win, "cli": cli_res,
                   "sequence": seq_res, "ring": ring_res, "distributed": dist_res,
                   "xla_route": xla_res, "dino": dino_res,
                   "gate_failures": gates.failures}, fh, indent=1, default=float)
    if gates.failures:
        log(f"{len(gates.failures)} gate(s) failed")
        return 1
    print(json.dumps({"launches": by_kernel}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
