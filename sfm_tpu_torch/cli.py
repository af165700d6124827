"""Command-line driver of the port (counterpart of ``sfm_tpu/cli.py``):
reconstruct from image files (two views, or incremental SfM over 3+)
and export a PLY, JSON metrics and a map checkpoint, or run the
standalone SIFT demo.  The same subcommands and options as the JAX
package's driver, with ``--device`` (default ``cuda``) in place of its
``--platform`` backend switch: without a card the command raises, and
it runs on the CPU only when asked to with ``--device cpu``.

Usage:
  python -m sfm_tpu_torch reconstruct IMG1 IMG2 [IMG...] \\
      --focal 2360 [--cx CX --cy CY] --out cloud.ply [--metrics m.json] \\
      [--checkpoint map.npz] [--ba-iters 20] [--closure I,J] [--mesh N]
  torchrun --nproc-per-node N -m sfm_tpu_torch reconstruct ... --distributed
  python -m sfm_tpu_torch sift IMG [IMG2] [--thresh 2.0] [--up-scale] \\
      [--out feats.npz] [--metrics out.json] [--homography]

``--checkpoint`` writes the incremental map (3+ images); a two-image
run has no map state and, as in the JAX package, writes none.
``--mesh N`` and ``--distributed`` shard the incremental path's
matching and global BA over a mesh of ranks (``parallel/``): one
process and one device per rank, so ``--mesh`` forms a mesh of 1 in
this process and refuses more, and ``--distributed`` joins the
processes a launcher started (``cuda:LOCAL_RANK`` each; one process
without a launcher).  Rank 0 writes the outputs.
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def _device(name):
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device; pass --device cpu "
                           "to run on the CPU")
    return dev


def _device_name(dev):
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _build_K(args, w, h):
    import numpy as np

    cx = args.cx if args.cx is not None else w / 2.0
    cy = args.cy if args.cy is not None else h / 2.0
    return np.array([[args.focal, 0, cx], [0, args.focal, cy], [0, 0, 1]],
                    np.float32)


def _load_images(paths):
    from sfm_tpu_torch.io import image_io, native

    if native.available() and all(
            str(p).lower().endswith((".ppm", ".pgm")) for p in paths):
        batch = native.load_gray_batch(paths)
        return [batch[i] for i in range(batch.shape[0])]
    return [image_io.load_gray(p) for p in paths]


def _emit(metrics, timer, path):
    metrics["stage_times"] = timer.summary()
    out = json.dumps(metrics, indent=2)
    print(out)
    if path:
        with open(path, "w") as f:
            f.write(out)


def _mesh(args, dev):
    """The mesh of ``--distributed`` or ``--mesh N`` (None without
    either), formed before any CUDA work."""
    if not (args.distributed or args.mesh):
        return None
    from sfm_tpu_torch.parallel import mesh as meshmod

    if args.distributed:
        n_proc = meshmod.init_distributed(backend="gloo" if dev.type == "cpu" else "nccl")
        mesh = meshmod.make_global_mesh(device=dev)
        print(f"distributed: {n_proc} processes, mesh over {mesh.size} devices",
              file=sys.stderr)
        return mesh
    return meshmod.make_mesh(args.mesh if args.mesh > 0 else None, device=dev)


def cmd_reconstruct(args):
    if len(args.images) < 2:
        raise ValueError("reconstruct needs at least two images")
    dev = _device(args.device)
    mesh = _mesh(args, dev)
    if mesh is None:
        return _reconstruct(args, dev, None)
    with mesh:
        return _reconstruct(args, mesh.device, mesh)


def _reconstruct(args, dev, mesh):
    import numpy as np
    import torch

    from sfm_tpu_torch.config import PipelineConfig, RansacConfig, SiftConfig
    from sfm_tpu_torch.utils.timing import StageTimer, span

    timer = StageTimer()
    with span("load_images", timer=timer):
        imgs = _load_images(args.images)
        h, w = imgs[0].shape
        K = _build_K(args, w, h)
        cfg = PipelineConfig(
            sift=SiftConfig(max_pts_per_octave=args.max_pts, thresh=args.thresh,
                            num_octaves=args.octaves),
            ransac=RansacConfig(n_hyps=args.ransac_hyps, threshold=args.ransac_thresh),
        )

    if len(imgs) == 2:
        from sfm_tpu_torch.models import two_view

        with span("pipeline", timer=timer):
            res = two_view.run_two_view(*(torch.as_tensor(a, device=dev)
                                          for a in (imgs[0], imgs[1], K)),
                                        cfg, seed=args.seed)
        points = res.points.cpu().numpy()
        valid = res.point_valid.cpu().numpy()
        err_px = math.sqrt(max(float(res.reproj_err), 0.0) / 2) * float(args.focal)
        metrics = {
            "mode": "two_view",
            "device": _device_name(dev),
            "num_matches": int(res.num_matches),
            "num_inliers": int(res.num_inliers),
            "num_points": int(valid.sum()),
            "mean_reproj_px": round(err_px, 4),
            "R": np.round(res.R.cpu().numpy(), 6).tolist(),
            "t": np.round(res.t.cpu().numpy(), 6).tolist(),
        }
        state = None
    else:
        from sfm_tpu_torch.models import incremental

        with span("pipeline", timer=timer):
            res = incremental.run_incremental(
                [torch.as_tensor(im, device=dev) for im in imgs], K, cfg,
                seed=args.seed, ba_iters=args.ba_iters, closure_pairs=args.closure,
                mesh=mesh)
        state = res.state
        points = state.X.cpu().numpy()
        valid = state.X_valid.cpu().numpy()
        err_px = math.sqrt(max(float(res.mean_reproj), 0.0) / 2) * float(args.focal)
        costs = res.ba_costs.cpu().numpy()
        metrics = {
            "mode": "incremental",
            "device": _device_name(dev),
            "num_images": len(imgs),
            "poses_registered": int(state.pose_valid.sum()),
            "num_points": int(valid.sum()),
            "mean_reproj_px": round(err_px, 4),
            "ba_cost_initial": float(costs[0]),
            "ba_cost_final": float(costs[-1]),
        }
    if mesh is not None:
        metrics["mesh"] = {"size": mesh.size, "backend": mesh.backend}
        if mesh.rank != 0:
            return 0
    if args.out:
        from sfm_tpu_torch.io import image_io

        with span("export", timer=timer):
            image_io.save_ply(args.out, points, valid=valid.astype(np.uint8))
        metrics["ply"] = args.out
    if args.checkpoint and state is not None:
        from sfm_tpu_torch.utils.checkpoint import save_map

        save_map(args.checkpoint, state, extra={"K": K.tolist()})
        metrics["checkpoint"] = args.checkpoint
    _emit(metrics, timer, args.metrics)
    return 0


def cmd_sift(args):
    """Standalone SIFT demo: extract (+ match + homography on a pair)."""
    dev = _device(args.device)
    import numpy as np
    import torch

    from sfm_tpu_torch.config import MatchConfig, SiftConfig
    from sfm_tpu_torch.sift import frontend, match as match_mod
    from sfm_tpu_torch.utils.timing import StageTimer, span

    timer = StageTimer()
    with span("load_images", timer=timer):
        imgs = _load_images(args.images)
    cfg = SiftConfig(num_octaves=args.octaves, thresh=args.thresh,
                     max_pts_per_octave=args.max_pts, up_scale=args.up_scale)

    with span("extract", timer=timer):
        results = [frontend.extract_sift(torch.as_tensor(im, device=dev), cfg)
                   for im in imgs]
        counts = [int(r.keypoints.valid.sum()) for r in results]
    metrics = {"mode": "sift", "device": _device_name(dev),
               "num_images": len(imgs), "features": counts}

    if len(imgs) == 2:
        f1, f2 = results
        with span("match", timer=timer):
            m = match_mod.match(f1.descriptors, f2.descriptors, f1.keypoints.valid,
                                f2.keypoints.valid, MatchConfig())
            n_match = int(m.valid.sum())
        metrics["num_matches"] = n_match
        metrics["match_pct"] = round(100.0 * n_match / max(counts[0], 1), 1)

        if args.homography:
            from sfm_tpu_torch.geometry import homography

            with span("homography", timer=timer):
                uv1 = torch.stack([f1.keypoints.x, f1.keypoints.y], dim=-1)
                uv2 = torch.stack([f2.keypoints.x, f2.keypoints.y], dim=-1)[m.index]
                gen = torch.Generator(device=dev)
                gen.manual_seed(args.seed)
                res = homography.ransac_homography(
                    uv1, uv2, m.valid, generator=gen, n_hyps=1024,
                    threshold=float(args.homography_thresh) ** 2)
                n_inl = int(res.num_inliers)
            metrics["homography_inliers"] = n_inl
            metrics["H"] = np.round(res.H.cpu().numpy(), 6).tolist()

    if args.out:
        with span("export", timer=timer):
            arrays = {}
            for i, r in enumerate(results):
                kp = r.keypoints
                v = kp.valid.cpu().numpy()
                arrays.update({
                    f"x{i}": kp.x.cpu().numpy()[v],
                    f"y{i}": kp.y.cpu().numpy()[v],
                    f"scale{i}": kp.scale.cpu().numpy()[v],
                    f"orientation{i}": kp.orientation.cpu().numpy()[v],
                    f"descriptors{i}": r.descriptors.cpu().numpy()[v],
                })
            np.savez_compressed(args.out, **arrays)
        metrics["out"] = args.out
    _emit(metrics, timer, args.metrics)
    return 0


def build_parser():
    p = argparse.ArgumentParser(prog="sfm_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_option(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; the command "
                             "raises without a card unless given cpu)")

    r = sub.add_parser("reconstruct", help="reconstruct from 2+ images")
    r.add_argument("images", nargs="+",
                   help="input images (2 = two-view; 3+ = incremental)")
    r.add_argument("--focal", type=float, default=2360.0,
                   help="focal length in px (reference dino default 2360)")
    r.add_argument("--cx", type=float, default=None)
    r.add_argument("--cy", type=float, default=None)
    r.add_argument("--out", default=None, help="output PLY path")
    r.add_argument("--metrics", default=None, help="write metrics JSON here")
    r.add_argument("--checkpoint", default=None,
                   help="save the map checkpoint (npz; 3+ images, the only "
                        "runs with map state)")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--octaves", type=int, default=5)
    r.add_argument("--thresh", type=float, default=1.0)
    r.add_argument("--max-pts", type=int, default=1024)
    r.add_argument("--ransac-hyps", type=int, default=1024)
    r.add_argument("--ransac-thresh", type=float, default=3e-6)
    r.add_argument("--ba-iters", type=int, default=20,
                   help="bundle-adjustment iterations (incremental)")

    def _pair(s):
        a, b = s.split(",")
        return (int(a), int(b))

    r.add_argument("--closure", type=_pair, action="append", default=[],
                   metavar="I,J",
                   help="loop-closure frame pair (incremental)")
    r.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="shard matching + global BA over a local N-device mesh "
                        "(-1 = all local devices; one process is one device)")
    r.add_argument("--distributed", action="store_true",
                   help="multi-process: torch.distributed from torchrun's env "
                        "(MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK / "
                        "LOCAL_RANK) and shard over ALL ranks")
    device_option(r)
    r.set_defaults(fn=cmd_reconstruct)

    s = sub.add_parser("sift", help="standalone SIFT extract/match demo")
    s.add_argument("images", nargs="+", help="1 image = extract only; "
                   "2 = extract + ratio-test match")
    s.add_argument("--octaves", type=int, default=5)
    s.add_argument("--thresh", type=float, default=2.0, help="DoG threshold")
    s.add_argument("--max-pts", type=int, default=2048,
                   help="keypoint capacity per octave")
    s.add_argument("--up-scale", action="store_true",
                   help="2x upscale before the pyramid")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--homography", action="store_true",
                   help="fit a RANSAC homography to the matches")
    s.add_argument("--homography-thresh", type=float, default=3.0,
                   help="inlier gate in px")
    s.add_argument("--out", default=None,
                   help="write features (x/y/scale/orientation/descriptors "
                        "per image) to this .npz")
    s.add_argument("--metrics", default=None, help="write stats JSON here")
    device_option(s)
    s.set_defaults(fn=cmd_sift)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
