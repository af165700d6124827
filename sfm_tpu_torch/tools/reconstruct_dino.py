"""Full dino-sequence reconstruction: all turntable frames of a ring
(counterpart of ``tools/reconstruct_dino.py``).

Reconstructs the sequence ``viff.000.ppm`` ... with the incremental
pipeline and reports turntable-consistency metrics:

  * per-step relative rotation angles (ideal: ~10 deg each)
  * total swept rotation
  * circle-fit RMS of camera centers / fitted radius (turntable
    cameras lie on a circle; dimensionless, gauge-invariant)
  * mean reprojection error over all retained observations

With --turntable, the ring's entry point (models/turntable.py:
reconstruct_ring) runs the chain and the circular-motion pipeline:
model-free ring tracks with wrap loop-closure edges,
uniform-phase turntable init, annealed variable-projected LM with
shared (f, k1) estimation, then annealed UNCONSTRAINED bundle
adjustment plus a snap-to-ring re-polish.

The JAX tool's flags and defaults, with two changes: ``--device``
(default ``cuda``; without a card the command raises, and it runs on
the CPU only with ``--device cpu``) in place of ``--cpu``, and ``--dir``
(default ``$SFM_DINO_DIR``) for the directory of the frames.

Usage:
  python -m sfm_tpu_torch.tools.reconstruct_dino --dir DIR [--frames N]
      [--step S] [--device cpu] [--out PREFIX] [--pts-per-octave K]
      [--turntable] [--save-feats F.npz | --load-feats F.npz]

Writes <out>.ply and <out>.metrics.json.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np


def circle_fit_metrics(centers: np.ndarray) -> dict:
    """Fit a plane + circle to camera centers; return relative RMS."""
    if not np.isfinite(centers).all():
        return {"circle_fit": "nonfinite centers"}
    c0 = centers.mean(0)
    X = centers - c0
    # plane normal = smallest right singular vector
    _, _, Vt = np.linalg.svd(X, full_matrices=False)
    n = Vt[-1]
    u, v = Vt[0], Vt[1]
    p = np.stack([X @ u, X @ v], 1)  # in-plane coords
    # algebraic circle fit (Kasa): |p - c|^2 = r^2
    A = np.concatenate([2 * p, np.ones((len(p), 1))], 1)
    b = (p ** 2).sum(1)
    sol, *_ = np.linalg.lstsq(A, b, rcond=None)
    cx, cy, k = sol
    r = math.sqrt(max(k + cx * cx + cy * cy, 1e-12))
    radial = np.sqrt(((p - [cx, cy]) ** 2).sum(1))
    oop = X @ n  # out-of-plane offsets
    return {
        "radius": float(r),
        "radial_rms_rel": float(np.sqrt(((radial - r) ** 2).mean()) / r),
        "out_of_plane_rms_rel": float(np.sqrt((oop ** 2).mean()) / r),
    }


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=os.environ.get("SFM_DINO_DIR"),
                    help="directory of the viff.NNN.ppm frames (default "
                    "$SFM_DINO_DIR)")
    ap.add_argument("--frames", type=int, default=37)
    ap.add_argument("--step", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; the command "
                    "raises without a card unless --device cpu)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "dino_seq"))
    ap.add_argument("--pts-per-octave", type=int, default=512)
    ap.add_argument("--ba-iters", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    # Intrinsics overrides: the reference hard-codes f=2360 centered; the
    # published VGG dinosaur calibration is fx=3310.4 fy=3325.5
    # c=(316.7, 200.6).
    ap.add_argument("--fx", type=float, default=2360.0)
    ap.add_argument("--fy", type=float, default=0.0, help="0 = same as fx")
    ap.add_argument("--cx", type=float, default=-1.0, help="<0 = w/2")
    ap.add_argument("--cy", type=float, default=-1.0, help="<0 = h/2")
    ap.add_argument("--turntable", action="store_true",
                    help="circular-motion constrained reconstruction")
    ap.add_argument("--save-feats", default=None,
                    help="save extracted features to this npz and continue "
                    "(device/CPU divergence forensics)")
    ap.add_argument("--load-feats", default=None,
                    help="skip extraction; load features from npz "
                    "(replay another backend's frontend)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.dir:
        raise SystemExit("reconstruct_dino: no frame directory: pass --dir or set "
                         "SFM_DINO_DIR")
    from sfm_tpu_torch.utils.precision import f32_precision

    # TF32 off for the whole drive, its own eager ops included (the
    # JAX package's eager driver ran at bf16 on its TPU: NOTES_R5.md).
    with f32_precision():
        return _run(args)


def _run(args) -> int:
    import torch

    from sfm_tpu_torch.cli import _device
    from sfm_tpu_torch.config import PipelineConfig, RansacConfig, SiftConfig
    from sfm_tpu_torch.io.image_io import iter_gray_frames, save_ply
    from sfm_tpu_torch.models import incremental
    from sfm_tpu_torch.sift import frontend

    dev = _device(args.device)
    n_frames = args.frames
    if args.turntable:
        # viff.036 is identical to viff.000: 36 unique ring views.
        n_frames = min(n_frames, 36)
    idxs = list(range(0, n_frames, args.step))
    paths = [os.path.join(args.dir, f"viff.{i:03d}.ppm") for i in idxs]
    fx = args.fx
    fy = args.fy if args.fy > 0 else fx
    cfg = PipelineConfig(
        sift=SiftConfig(max_pts_per_octave=args.pts_per_octave),
        ransac=RansacConfig(n_hyps=1024, threshold=3e-6, chunk=256),
    )
    t0 = time.time()
    # Decode-ahead ingest: frames decode on worker threads while the
    # card extracts the previous frame.
    imgs = [None] * len(paths)
    feats = [None] * len(paths)
    if args.load_feats:
        d = np.load(args.load_feats)
        nfr = int(d["n_frames"])
        if nfr != len(paths):
            raise SystemExit(f"{args.load_feats} holds {nfr} frames, the run "
                             f"{len(paths)}")
        for i, im in iter_gray_frames(paths, depth=4):
            imgs[i] = torch.as_tensor(im, device=dev)
        for i in range(nfr):
            kp = frontend.Keypoints(*[torch.as_tensor(d[f"f{i}_{f}"], device=dev)
                                      for f in frontend.Keypoints._fields])
            feats[i] = frontend.SiftResult(
                keypoints=kp, descriptors=torch.as_tensor(d[f"f{i}_desc"], device=dev))
    else:
        for i, im in iter_gray_frames(paths, depth=4):
            imgs[i] = torch.as_tensor(im, device=dev)
            feats[i] = frontend.extract_sift(imgs[i], cfg.sift)
    h, w = imgs[0].shape
    if args.save_feats:
        out = {"n_frames": len(paths)}
        for i, ft in enumerate(feats):
            for f in ft.keypoints._fields:
                out[f"f{i}_{f}"] = getattr(ft.keypoints, f).cpu().numpy()
            out[f"f{i}_desc"] = ft.descriptors.cpu().numpy()
        np.savez(args.save_feats, **out)
        print(f"saved features to {args.save_feats}", file=sys.stderr)
    cx = args.cx if args.cx >= 0 else w / 2
    cy = args.cy if args.cy >= 0 else h / 2
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    tt_metrics = {}
    if args.turntable:
        from sfm_tpu_torch.models import turntable as tt

        ttr = tt.reconstruct_ring(imgs, K, cfg, feats=feats, seed=args.seed,
                                  chain_ba_iters=args.ba_iters, device=dev)
        res = ttr.chain
        st = res.state
        elapsed = time.time() - t0
        sd = ttr.step_deg.cpu().numpy()
        tt_metrics = {
            "turntable": True,
            "tt_rms_px": round(ttr.rms_px, 3),
            "tt_f_px": round(ttr.f, 1),
            "tt_k1": round(ttr.k1, 4),
            "tt_k2": round(ttr.k2, 4),
            "tt_tracks": int(ttr.tracks.n_tracks),
            "tt_obs": int(ttr.tracks.cam_idx.shape[0]),
            "tt_obs_kept": int(ttr.keep.sum()),
            "tt_step_deg_mean": float(sd.mean()),
            "tt_step_deg_std": float(sd.std()),
            "tt_total_deg": round(ttr.total_deg, 2),
        }
        # Per-track validity: a track survives if any observation is kept.
        tv = torch.zeros((ttr.X.shape[0],), dtype=torch.bool, device=dev)
        tv[ttr.tracks.pt_idx[ttr.keep]] = True
        st = st._replace(
            R=ttr.R, t=ttr.t, X=ttr.X, X_valid=tv, n_points=tv.sum(),
            pose_valid=torch.ones((len(idxs),), dtype=torch.bool, device=dev))
    else:
        res = incremental.run_incremental(
            imgs, K, cfg, ba_iters=args.ba_iters, seed=args.seed, feats=feats, device=dev)
        st = res.state
        elapsed = time.time() - t0

    R = st.R.cpu().numpy()
    t = st.t.cpu().numpy()
    M = len(imgs)
    angles = []
    for i in range(1, M):
        dR = R[i] @ R[i - 1].T
        angles.append(math.degrees(math.acos(np.clip((np.trace(dR) - 1) / 2, -1, 1))))
    centers = np.einsum("mji,mj->mi", R, -t)  # C = -R^T t
    circ = circle_fit_metrics(centers) if M >= 5 else {}
    metrics = {
        "frames": M,
        "step_deg_ideal": 10.0 * args.step,
        "angles_deg": [round(a, 3) for a in angles],
        "angle_mean_deg": float(np.mean(angles)),
        "angle_std_deg": float(np.std(angles)),
        "total_rotation_deg": float(np.sum(angles)),
        "poses_valid": int(st.pose_valid.sum()),
        "n_points": int(st.n_points),
        "mean_reproj_norm2": float(res.mean_reproj),
        "mean_reproj_px": math.sqrt(max(float(res.mean_reproj), 0) / 2)
        * math.sqrt(fx * fy),
        "elapsed_s": round(elapsed, 1),
        **circ,
        **tt_metrics,
    }
    X = st.X.cpu().numpy()
    valid = st.X_valid.cpu().numpy()
    # Drop far-field stragglers for the viewable cloud.
    if valid.any():
        med = np.median(np.abs(X[valid]), axis=0)
        keep = valid & (np.abs(X) < 20 * (med + 1e-6)).all(1)
    else:
        keep = valid
    n_written = save_ply(args.out + ".ply", X, valid=keep)
    metrics["ply_vertices"] = int(n_written)
    with open(args.out + ".metrics.json", "w") as f:
        json.dump(metrics, f, indent=1)
    print(json.dumps(metrics, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
