#!/usr/bin/env python3
"""The JAX package's reference numbers that ``chip_smoke.py`` gates the
port against, measured on the CPU.

Every part runs the JAX package's XLA route: on the CPU its auto rules
resolve ``SiftConfig.use_pallas``, ``fused_detect`` and
``pyramid_pallas`` and ``MatchConfig.use_pallas`` to False (the dense
DoG detector, two-stage sampling, the f32 chunked top-2), and the
``xla`` part sets them to False explicitly.

Run from the repository root:

    JAX_PLATFORMS=cpu python3 tests/jax_cli_reference.py \\
        [--seeds 8] [--parts reconstruct,default,sift,upscale,incremental,turntable,xla]

Parts, each printing one JSON line per run:

- ``reconstruct``: ``synthetic_pair(576, 720, seed=0)`` written as 8-bit
  PGMs (``synthetic_pair.write_pgm``, the same files the CLI phase
  writes), ``sfm_tpu.cli.main(["--platform", "cpu", "reconstruct", a,
  b, "--focal", "792", "--seed", s, ...])`` in-process once per seed
  (the CLI's defaults otherwise: 1024 points per octave, 1024
  hypotheses, threshold 3e-6, ``tvote_rounds=1``): each seed's metrics,
  its rotation and translation-direction errors against the rendered
  pose, then the medians;
- ``default``: ``run_two_view`` at ``PipelineConfig()`` as it stands
  (seed 0) on the float pair;
- ``sift``: ``rotation_pair(960, 1280, seed=0)`` as PGMs through
  ``sift --max-pts 4096 --up-scale --homography`` (20,480 detection
  slots) and ``sift --octaves 9 --homography`` (18,432): features,
  matches, homography inliers and the H error against the pair's exact
  homography on a 16 x 12 grid;
- ``upscale``: tools/bench_upscale.py's up_t2.0 configuration with
  ``lowest_scale`` 0 and 1.0 on the float rotation pair: features,
  ratio-test matches, bench_upscale's H-fit (``PRNGKey(0)``: candidates,
  those > 3 px off the exact homography, the 3 px count) and the H
  error;
- ``incremental``: ``synthetic_sequence(576, 720)`` (12 frames on an
  arc, ``tests/synthetic_sequence.py``): the 12 frames as PGMs through
  ``reconstruct --focal 792 --checkpoint`` at the CLI's defaults (20 BA
  iterations, seed 0), then ``run_incremental`` on the float frames at
  the same configuration with ``closure_pairs=[(0, 11)]``: poses
  registered, points, reprojection px, the BA costs, and the
  Sim(3)-aligned ATE and the median and largest rotation error of the
  registered poses (projected onto SO(3) in float64,
  ``synthetic_sequence.nearest_rotations``) against the rendered ones;
- ``turntable``: ``synthetic_ring(576, 720)`` (36 frames of a turntable
  with k1 = -0.45, ``tests/synthetic_ring.py``) written as its 37
  ``viff.NNN.ppm`` files and read back, then what
  ``tools/reconstruct_dino.py --turntable`` computes at its defaults
  (512 points per octave, 1,024 hypotheses at 3e-6, chunk 256, 30 BA
  iterations, seed 0, f = 2360 at the frame centre): ``run_incremental``
  on the 36 frames, then ``reconstruct_turntable`` from its chain; the
  tool's metrics (the ``tt_*`` keys, steps, total, circle fit, the
  far-field-filtered PLY count), the per-step spread, and the median
  and largest rotation error of the final poses against the rendered
  ones (projected onto SO(3) first);
- ``xla``: ``two_view_pipeline`` at bench.py's configuration
  (``chip_smoke.slice_config``'s fields: 1,024 points per octave, 1,536
  hypotheses at 3e-6, chunk 256, ``tvote_rounds=0``) with
  ``SiftConfig(fused_detect=False, use_pallas=False)`` and
  ``MatchConfig(use_pallas=False)`` on the float
  ``synthetic_pair(576, 720, seed=0)``, ``PRNGKey(seed)`` for each seed:
  each seed's matches, inliers, valid points, reprojection px and pose
  errors against the rendered pose, then the medians.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import statistics
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

from synthetic_pair import (homography_grid_errors, pose_errors_deg,  # noqa: E402
                            rotation_pair, synthetic_pair, transfer_px, write_pgm)

PARTS = ("reconstruct", "default", "sift", "upscale", "incremental", "turntable",
         "xla")


def reconstruct(d, seeds):
    from sfm_tpu import cli

    pair = synthetic_pair(576, 720, seed=0)
    a, b = os.path.join(d, "a.pgm"), os.path.join(d, "b.pgm")
    write_pgm(a, pair["img1"])
    write_pgm(b, pair["img2"])
    rows = []
    for seed in range(seeds):
        js = os.path.join(d, f"m{seed}.json")
        cli.main(["--platform", "cpu", "reconstruct", a, b, "--focal", "792",
                  "--out", os.path.join(d, "c.ply"), "--metrics", js,
                  "--seed", str(seed)])
        with open(js) as fh:
            m = json.load(fh)
        rot, tdir = pose_errors_deg(np.array(m["R"]), np.array(m["t"]),
                                    pair["R"], pair["t"])
        rows.append({"seed": seed, "matches": m["num_matches"],
                     "inliers": m["num_inliers"], "valid": m["num_points"],
                     "px": m["mean_reproj_px"], "rot_deg": rot, "tdir_deg": tdir})
        print(json.dumps(rows[-1]), flush=True)
    if rows:
        med = {k: statistics.median(r[k] for r in rows)
               for k in ("matches", "inliers", "valid", "px", "rot_deg", "tdir_deg")}
        med["worst_rot_deg"] = max(r["rot_deg"] for r in rows)
        med["worst_tdir_deg"] = max(r["tdir_deg"] for r in rows)
        print(json.dumps({"jax_cli_medians": med}), flush=True)


def default():
    import jax.numpy as jnp

    from sfm_tpu.config import PipelineConfig
    from sfm_tpu.models import two_view

    pair = synthetic_pair(576, 720, seed=0)
    r = two_view.run_two_view(*(jnp.asarray(pair[k]) for k in ("img1", "img2", "K")),
                              PipelineConfig(), seed=0)
    rot, tdir = pose_errors_deg(np.array(r.R), np.array(r.t), pair["R"], pair["t"])
    print(json.dumps({"jax_pipeline_config_default": {
        "matches": int(r.num_matches), "inliers": int(r.num_inliers),
        "valid": int(np.array(r.point_valid).sum()),
        "px": float(np.sqrt(float(r.reproj_err) / 2) * pair["K"][0, 0]),
        "rot_deg": rot, "tdir_deg": tdir}}), flush=True)


# The sift runs of chip_smoke.py's CLI phase beyond its first.
SIFT_RUNS = {"max_pts_4096_up_scale": ["--max-pts", "4096", "--up-scale"],
             "octaves_9": ["--octaves", "9"]}


def sift(d):
    from sfm_tpu import cli

    rpair = rotation_pair(960, 1280, seed=0)
    ra, rb = os.path.join(d, "ra.pgm"), os.path.join(d, "rb.pgm")
    write_pgm(ra, rpair["img1"])
    write_pgm(rb, rpair["img2"])
    h, w = rpair["img1"].shape
    for name, extra in SIFT_RUNS.items():
        js = os.path.join(d, f"sift_{name}.json")
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["--platform", "cpu", "sift", ra, rb, *extra, "--homography",
                      "--metrics", js])
        with open(js) as fh:
            m = json.load(fh)
        grid = homography_grid_errors(np.array(m["H"]), rpair["H_gt"], h, w)
        print(json.dumps({f"jax_cli_sift_{name}": {
            "features": m["features"], "matches": m["num_matches"],
            "homography_inliers": m["homography_inliers"],
            "h_median_px": float(np.median(grid)), "h_max_px": float(grid.max())}}),
            flush=True)


def upscale():
    import jax
    import jax.numpy as jnp

    from sfm_tpu.config import MatchConfig, SiftConfig
    from sfm_tpu.geometry import homography
    from sfm_tpu.sift import frontend, match as match_mod

    rpair = rotation_pair(960, 1280, seed=0)
    img1, img2 = jnp.asarray(rpair["img1"]), jnp.asarray(rpair["img2"])
    per = 4096
    up_t2 = SiftConfig(num_octaves=5, max_pts_per_octave=per,
                       octave_caps=(per, per, per // 2, per // 4, per // 8),
                       sample_cap=16384, thresh=2.0, init_blur=1.0, up_scale=True)
    h, w = rpair["img1"].shape
    for lowest in (0.0, 1.0):
        cfg = dataclasses.replace(up_t2, lowest_scale=lowest)
        r1, r2 = frontend.extract_sift(img1, cfg), frontend.extract_sift(img2, cfg)
        m = match_mod.match(r1.descriptors, r2.descriptors, r1.keypoints.valid,
                            r2.keypoints.valid, MatchConfig())
        # tools/bench_upscale.py:116-134.
        kp1, kp2 = r1.keypoints, r2.keypoints
        uv1 = jnp.stack([kp1.x, kp1.y], axis=-1)
        uv2 = jnp.stack([kp2.x[m.index], kp2.y[m.index]], axis=-1)
        slot_ok = kp1.valid & kp2.valid[m.index]
        cand = slot_ok & (m.ambiguity < 0.80) & (m.score > 0.0)
        hres = homography.ransac_homography(jax.random.PRNGKey(0), uv1, uv2, cand,
                                            n_hyps=8192, threshold=25.0,
                                            refit_iters=0)
        H = homography.improve_homography(hres.H, uv1, uv2, cand, loops=5,
                                          threshold=9.0)
        errs = homography.transfer_errors(H, uv1, uv2)
        cand = np.asarray(cand)
        true_err = transfer_px(rpair["H_gt"], np.asarray(uv1), np.asarray(uv2))
        grid = homography_grid_errors(np.asarray(H), rpair["H_gt"], h, w)
        print(json.dumps({f"jax_upscale_lowest_scale_{lowest}": {
            "n1": int(kp1.valid.sum()), "n2": int(kp2.valid.sum()),
            "matches": int(m.valid.sum()), "candidates": int(cand.sum()),
            "wrong_candidates": int((cand & (true_err > 3.0)).sum()),
            "numfit": int(((errs < 9.0) & slot_ok).sum()),
            "h_median_px": float(np.median(grid)), "h_max_px": float(grid.max())}}),
            flush=True)


def incremental(d):
    import time

    import jax.numpy as jnp

    from sfm_tpu import cli
    from sfm_tpu.config import PipelineConfig, RansacConfig, SiftConfig
    from sfm_tpu.models import incremental as inc
    from sfm_tpu.utils import metrics
    from sfm_tpu.utils.checkpoint import load_map
    from synthetic_sequence import pose_quality, synthetic_sequence, write_pgms

    seq = synthetic_sequence(576, 720)
    paths = write_pgms(d, seq["images"])
    js, npz = os.path.join(d, "seq.json"), os.path.join(d, "seq.npz")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["--platform", "cpu", "reconstruct", *paths, "--focal", "792",
                  "--out", os.path.join(d, "seq.ply"), "--metrics", js,
                  "--checkpoint", npz])
    with open(js) as fh:
        m = json.load(fh)
    st, _ = load_map(npz)
    print(json.dumps({"jax_cli_incremental": {
        **{k: m[k] for k in ("poses_registered", "num_points", "mean_reproj_px",
                             "ba_cost_initial", "ba_cost_final")},
        **pose_quality(metrics, st.R, st.t, st.pose_valid, seq),
        "seconds": time.perf_counter() - t0}}), flush=True)
    # The module path: the float frames, one closure pair.
    cfg = PipelineConfig(sift=SiftConfig(max_pts_per_octave=1024),
                         ransac=RansacConfig(n_hyps=1024, threshold=3e-6))
    t0 = time.perf_counter()
    res = inc.run_incremental([jnp.asarray(im) for im in seq["images"]],
                              seq["K"], cfg, seed=0, ba_iters=20,
                              closure_pairs=[(0, 11)])
    st = res.state
    costs = np.asarray(res.ba_costs)
    print(json.dumps({"jax_run_incremental_closure_0_11": {
        "poses_registered": int(np.asarray(st.pose_valid).sum()),
        "num_points": int(np.asarray(st.X_valid).sum()),
        "mean_reproj_px": float(np.sqrt(float(res.mean_reproj) / 2) * seq["K"][0, 0]),
        "ba_cost_initial": float(costs[0]), "ba_cost_final": float(costs[-1]),
        **pose_quality(metrics, st.R, st.t, st.pose_valid, seq),
        "seconds": time.perf_counter() - t0}}), flush=True)


def turntable(d):
    import time

    import jax.numpy as jnp

    from sfm_tpu.config import PipelineConfig, RansacConfig, SiftConfig
    from sfm_tpu.io.image_io import load_gray
    from sfm_tpu.models import incremental as inc
    from sfm_tpu.models import turntable as tt
    from sfm_tpu.sift import frontend
    from sfm_tpu.utils import metrics
    from synthetic_ring import synthetic_ring
    from synthetic_sequence import nearest_rotations
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
    from reconstruct_dino import circle_fit_metrics

    t0 = time.perf_counter()
    ring = synthetic_ring(576, 720, directory=d)
    render_s = time.perf_counter() - t0
    n = len(ring["images"])
    cfg = PipelineConfig(sift=SiftConfig(max_pts_per_octave=512),
                         ransac=RansacConfig(n_hyps=1024, threshold=3e-6, chunk=256))
    imgs = [jnp.asarray(load_gray(p)) for p in ring["paths"][:n]]
    h, w = imgs[0].shape
    K = np.array([[2360.0, 0, w / 2], [0, 2360.0, h / 2], [0, 0, 1]], np.float32)
    t0 = time.perf_counter()
    feats = [frontend.extract_sift(im, cfg.sift) for im in imgs]
    res = inc.run_incremental(imgs, K, cfg, ba_iters=30, seed=0, feats=feats)
    st = res.state
    t_chain = time.perf_counter() - t0
    t0 = time.perf_counter()
    ttr = tt.reconstruct_turntable(feats, st.R, st.t, K, cfg,
                                   pose_valid=st.pose_valid)
    t_tt = time.perf_counter() - t0
    R, t, X = np.asarray(ttr.R), np.asarray(ttr.t), np.asarray(ttr.X)
    sd = np.asarray(ttr.step_deg)
    keep = np.asarray(ttr.keep)
    tv = np.zeros((X.shape[0],), bool)
    np.logical_or.at(tv, np.asarray(ttr.tracks.pt_idx), keep)
    med = np.median(np.abs(X[tv]), axis=0)
    ply = int((tv & (np.abs(X) < 20 * (med + 1e-6)).all(1)).sum())
    rot = metrics.rotation_errors_deg(nearest_rotations(R), ring["R"])
    print(json.dumps({"jax_turntable": {
        "frames": n, "chain_poses_registered": int(np.asarray(st.pose_valid).sum()),
        "chain_step_deg_mean": float(np.mean(tt._steps_deg_np(st.R))),
        "tt_rms_px": ttr.rms_px, "tt_f_px": ttr.f, "tt_k1": ttr.k1, "tt_k2": ttr.k2,
        "tt_tracks": int(ttr.tracks.n_tracks),
        "tt_obs": int(len(np.asarray(ttr.tracks.cam_idx))),
        "tt_obs_kept": int(keep.sum()), "tt_step_deg_mean": float(sd.mean()),
        "tt_step_deg_std": float(sd.std()), "tt_step_deg_min": float(sd.min()),
        "tt_step_deg_max": float(sd.max()), "tt_total_deg": ttr.total_deg,
        "n_points": int(tv.sum()), "ply_vertices": ply,
        **circle_fit_metrics(np.einsum("mji,mj->mi", R, -t)),
        "rot_median_deg": float(np.median(rot)), "rot_max_deg": float(rot.max()),
        "render_seconds": render_s, "chain_seconds": t_chain,
        "turntable_seconds": t_tt}}), flush=True)


def xla(seeds):
    import jax
    import jax.numpy as jnp

    from sfm_tpu.config import MatchConfig, PipelineConfig, RansacConfig, SiftConfig
    from sfm_tpu.models import two_view

    pair = synthetic_pair(576, 720, seed=0)
    cfg = PipelineConfig(
        sift=SiftConfig(max_pts_per_octave=1024, fused_detect=False, use_pallas=False),
        match=MatchConfig(use_pallas=False),
        ransac=RansacConfig(n_hyps=1536, threshold=3e-6, chunk=256),
        tvote_rounds=0)
    img1, img2, K = (jnp.asarray(pair[k]) for k in ("img1", "img2", "K"))
    rows = []
    for seed in range(seeds):
        r = two_view.two_view_pipeline(img1, img2, K, jax.random.PRNGKey(seed), cfg)
        rot, tdir = pose_errors_deg(np.array(r.R), np.array(r.t), pair["R"], pair["t"])
        rows.append({"seed": seed, "matches": int(r.num_matches),
                     "inliers": int(r.num_inliers),
                     "valid": int(np.array(r.point_valid).sum()),
                     "px": float(np.sqrt(float(r.reproj_err) / 2) * pair["K"][0, 0]),
                     "rot_deg": rot, "tdir_deg": tdir})
        print(json.dumps({"jax_xla_route": rows[-1]}), flush=True)
    if rows:
        med = {k: statistics.median(r[k] for r in rows)
               for k in ("matches", "inliers", "valid", "px", "rot_deg", "tdir_deg")}
        med["worst_rot_deg"] = max(r["rot_deg"] for r in rows)
        med["worst_tdir_deg"] = max(r["tdir_deg"] for r in rows)
        print(json.dumps({"jax_xla_route_medians": med}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--parts", default=",".join(PARTS),
                    help=f"comma-separated subset of {PARTS}")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if set(parts) - set(PARTS):
        ap.error(f"unknown parts {set(parts) - set(PARTS)}")
    with tempfile.TemporaryDirectory() as d:
        if "reconstruct" in parts:
            reconstruct(d, args.seeds)
        if "default" in parts:
            default()
        if "sift" in parts:
            sift(d)
        if "upscale" in parts:
            upscale()
        if "incremental" in parts:
            incremental(d)
        if "turntable" in parts:
            turntable(d)
        if "xla" in parts:
            xla(args.seeds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
