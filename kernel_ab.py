#!/usr/bin/env python3
"""Times and bounds of the port's hand-written kernels (K1-K12) on one
card, for one or more checkouts of the repository: the source of
PERF.md §6's table.

Run from the repository root on a machine with an NVIDIA card:

    python3 kernel_ab.py [--k6] TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one); ``--k6`` times
K6 alone (its rows below), for variants of the matcher.  First every
distinct tree builds its kernels, all at once, one process each; then
the trees run in the order given, each in a process of its own (the
package has one name), so ``OLD NEW NEW OLD`` alternates them on the
same card.  Every tree gets this checkout's scenes, configurations
(``tests/path_configs.py``) and clocks.  Per tree: the ``-Xptxas -v`` lines of
its kernels (registers, shared memory, spills) and the tensor-core
instructions (HGMMA) of K6's kernels in their SASS, the sampling
kernels' resident blocks per SM where the tree reports them, then one
record per row:

- ``ms``: CUDA-event milliseconds per call, the mean of 20 after 3
  warm-ups (of 5 after 1 for K10, K11, K12 and ``ransac_pnp``);
  ``device_ms``: the same calls queued behind a spin kernel, so the
  events bracket device work only;
- ``launches``: the launches of one call: PyTorch's device operations
  in a ``torch.profiler`` trace of it (the hand kernels, which the
  trace's ``events()`` hold only at times, left out by name), plus the
  hand-kernel calls ``ops/_cuda.LAUNCHES`` counts around it (one per C
  entry point: K6's launches its match and merge kernels, and in f32 a
  split too); ``plain_launches``, ``plain_device_ms``: the same, and
  the trace's device time, for the kernel's plain PyTorch route
  (``*_plain``);
- ``bound_ms``, ``bound_by``: the least time of the call on one H100,
  the larger of its ``bytes`` over the memory rate and its ``ops`` over
  the peak for their type (``portbench/harness/roofline.py``'s peaks;
  TF32 below), and which of the two it is;
- ``library_ms``: CUDA-event ms of PyTorch's own calls computing the
  same function, where there are such (the base chain's composed
  ``Conv2d``, K7's ``F.interpolate``, K6's two-call ``topk(a @ b.T, 2)``);
- ``digest``: SHA-256 of the kernel's outputs, so that one call shows
  whether the trees' outputs are equal bit for bit as well as their
  times.

The rows, at the bench path's shapes (bench.py's config on the 576 x 720
synthetic image) and the up-scale path's (up_t2.0 on the 960 x 1280
rotation pair's first image, a 1920 x 2560 base):

- the base chain (K1 + K2: the prefilter and 4 descents) of one image,
  and K7 (the 2x up-scale) of the up-scale image;
- K3 on the 5 octave bases, however the tree launches it, lean and in
  the gated mode at ``lowest_scale=1.0``'s gates; at the bench shape
  also at 14 and 19 planes (its run-time-plane route);
- K4 and K9 on the capped sample slots of the image's ``detect_stage``
  (2,560; 11,776), and at the bench shape with 0 and 1 of them live (a
  launch's floor, one warp's latency); K5 on their duplicates;
- K8 as the module API runs it on the bench image (all 5,120 detection
  slots, compacted valid-first) and on the up-scale image's capped
  slots;
- on the XLA route (``fused_detect=False``, ``use_pallas=False``): K8 on
  the capped slots and K5 on two-stage sampling's 2K compacted slots;
- K6 ``match_top2`` on seeded unit descriptors at 5,120^2 x 128 and
  23,552^2 x 128 (all columns valid), bf16 and f32;
- K10 (``refine_relative_pose``, however the tree runs it: the plain
  ``jvp`` route before K10) at the bench pair's shapes, 8 starts x 6
  steps and 1 x 10 at 2,560 seeded correspondences
  (``tests/synthetic_pair.py:refine_problem``);
- ``ransac_pnp`` whole, however the tree runs its LO stage, and K11
  (``pnp_lo``) alone where the tree has it, on the LO inputs
  ``ransac_pnp`` hands it, at the sequence cell's shape: 15,360 rows (3
  frames x 5,120 slots), 40% of them live, 1,024 hypotheses, the prior
  winning (``pnp_problem``);
- K12 (``recover_pose``, however the tree runs it: the plain route
  before K12) at 512, 2,560 and 5,120 rows (the bench pair's refine rounds and final vote, the
  sequence bootstrap) with 0/1 weights (``pose_problem``).

Prints one JSON line per tree, then whether the digests agree across
the trees (and which differ) and whether K9's equal K4's in every tree,
and writes the trees' records to ``chiprun_out/kernel_ab.json``.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

from portbench.harness.roofline import BF16_FLOPS, F32_FLOPS, HBM_BYTES_PER_S

ROOT = os.path.dirname(os.path.abspath(__file__))

# TF32 tensor cores with f32 accumulation (NVIDIA's H100 SXM data sheet,
# dense, 700 W).  An f32-accurate product: one exact f32 pass on the CUDA
# cores, or three TF32 passes over an error-compensated split (x = hi +
# lo), whichever the card does faster (the latter); the bound reads the
# work, not the kernel.
TF32_FLOPS = 495e12
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

# Operations of K3's gated mode per candidate beyond the lean mode's,
# counted from the source: the edge ratio, the adjugate (15), its
# determinant (5), the reciprocal, the three offsets (18), the fallback
# test and divisions (8), the clamps (6), the scale gate (4, exp2 as
# one) and the sharpness (6).
GATED_SOLVE_OPS = 70

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


# Operations per row and branch of K12, counted from csrc/pose.cu the
# same way: the two DLT rows of the second view 16, the 4 x 4 Gram 112
# (16 entries of a product and three FMAs), a Jacobi rotation 85 (its
# (c, s) 13, then 4 x 6 on A's columns, A's rows and V's columns) x 6 a
# sweep x 8 sweeps, the eigenvector's pick, norm and division 19, X,
# finite and the depths 21.  A call needs it for 4 branches of n rows
# (the kernel computes the winner's rows twice; the bound does not).
POSE_ROW_OPS = 16 + 112 + 85 * 6 * 8 + 19 + 21


def lo_ops(n: int, iters: int, rounds: int = 3) -> int:
    """Operations of one K11 call on n rows."""
    return n * (rounds * ((2 * iters + 2) * LO_NORMAL_OPS + LO_GRAM_OPS + LO_COUNT_OPS)
                + LO_FINAL_OPS)


def k3_work(bases, planes: int, ntap: int, lean: bool, candidates: int = 0):
    """(bytes, operations) of K3 on ``bases``: each pixel read once and
    its maps written (resp + 11 aux lean, resp + 6 gated); the separable
    blur bank, the DoG differences and the 26-neighbour test on each
    interior DoG plane; the gated mode's solve per candidate."""
    n_px = sum(b.numel() for b in bases)
    ops = n_px * (4 * planes * ntap + (planes - 1) + 26 * (planes - 3))
    return (4 * n_px * (1 + (12 if lean else 7)),
            ops + (0 if lean else GATED_SOLVE_OPS * candidates))


def patch_bytes(atlas, live: int, P: int) -> int:
    """Atlas bytes a sampling kernel must read: each live keypoint's
    (P + 8) x P f32 patch (P = 40 for K4, K5 and K9, 16 for K8), or the
    whole atlas where that is less."""
    return min(4 * atlas.numel(), live * (P + 8) * P * 4)


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


def hand_kernels() -> set:
    """The names of the ``__global__`` functions in ``sfm_tpu_torch/csrc``
    of the tree in the working directory."""
    import glob
    import re

    names = set()
    for path in glob.glob(os.path.join("sfm_tpu_torch", "csrc", "*.cu")):
        with open(path) as fh:
            names |= set(re.findall(r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s+)*(\w+)\s*\(",
                                    fh.read()))
    return names


def profile_launches(fn):
    """(launches, device ms) of one call of ``fn``: PyTorch's device
    operations in a ``torch.profiler`` trace of it (the profiler's own
    buffers left out, and the hand kernels, which the trace's
    ``events()`` hold only at times, H100, torch 2.11) plus the calls of
    hand kernels ``ops/_cuda.LAUNCHES`` counts around it; the device ms
    of the operations the trace holds."""
    import re

    import torch

    from sfm_tpu_torch.ops import _cuda

    hand = hand_kernels()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    before = sum(_cuda.LAUNCHES.values())
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    n_hand = sum(_cuda.LAUNCHES.values()) - before
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and "Buffer" not in e.name]
    ops = [e for e in kern if not hand & set(re.findall(r"\w+", e.name))]
    return len(ops) + n_hand, sum(e.time_range.elapsed_us() for e in kern) / 1e3


def bound(nbytes: float, ops: float, peak: float = F32_FLOPS):
    """(least ms on the card, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def digest(tensors) -> str:
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in tensors)
                          ).hexdigest()[:16]


def record(fn, plain=None, work=None, peak=F32_FLOPS, library=None, reps=20, warmup=3):
    """One row: ``fn``'s digest, CUDA-event and device ms and launches;
    the plain route's launches and device ms; the bound of ``work``
    (bytes, operations) at ``peak``; ``library``'s CUDA-event ms."""
    from sfm_tpu_torch.utils.precision import f32_precision

    out = fn()
    if isinstance(out, dict):
        out = tuple(out.values())
    rec = {"digest": digest(out if isinstance(out, (tuple, list)) else (out,)),
           "ms": cuda_ms(fn, reps, warmup), "device_ms": device_ms(fn, reps, warmup)}
    rec["launches"], _ = profile_launches(fn)
    if plain is not None:
        with f32_precision():
            plain()   # warm-up: the plain route's first call allocates
            rec["plain_launches"], rec["plain_device_ms"] = profile_launches(plain)
    if work is not None:
        rec["bytes"], rec["ops"] = work
        rec["bound_ms"], rec["bound_by"] = bound(*work, peak)
    if library is not None:
        with f32_precision():
            rec["library_ms"] = cuda_ms(library)
    return rec


def rows(dev, k6_only: bool) -> dict:
    """{row name: record} of this process's tree (module docstring)."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F

    import synthetic_pair as scene
    from path_configs import slice_config, upscale_config
    from sfm_tpu_torch.geometry import pnp, pose, refine
    from sfm_tpu_torch.ops import compact, detect, match, sample
    from sfm_tpu_torch.ops import pyramid as pyr
    from sfm_tpu_torch.sift import frontend, orient, pyramid

    out = {}
    rng = np.random.default_rng(0)
    for n in (5120, 23552):
        d = np.abs(rng.normal(size=(2 * n, 128))).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        a, b = torch.as_tensor(d[:n], device=dev), torch.as_tensor(d[n:], device=dev)
        v = torch.ones(n, dtype=torch.bool, device=dev)
        ab, bb = a.to(torch.bfloat16), b.to(torch.bfloat16)
        for mode, nbytes, peak, lib in (
                ("bf16", 2 * 128 * 2 * n + n + 12 * n, BF16_FLOPS,
                 lambda: torch.topk(ab @ bb.T, 2)),
                ("f32", 4 * 128 * 2 * n + 4 * n + 12 * n, F32_ACCURATE_FLOPS,
                 lambda: torch.topk(a @ b.T, 2))):
            bf16 = mode == "bf16"
            out[f"K6 {mode} {n}^2 x 128"] = record(
                lambda: match.match_top2(a, b, v, bf16=bf16),
                lambda: match.match_top2_plain(a, b, v, bf16=bf16),
                (nbytes, 2.0 * n * n * 128), peak, library=lib)
        del ab, bb
    if k6_only:
        return out

    multi = getattr(detect, "detect_maps_octaves", None)
    bench_img = torch.as_tensor(scene.synthetic_pair(576, 720, seed=0)["img1"], device=dev)
    up_img = torch.as_tensor(scene.rotation_pair(960, 1280, seed=0)["img1"], device=dev)
    n_in = up_img.numel()
    out[f"K7 {tuple(up_img.shape)} -> 2x"] = record(
        lambda: pyr.scale_up(up_img), lambda: pyr.scale_up_plain(up_img),
        (4 * (n_in + 4 * n_in), 8 * n_in),
        library=lambda: F.interpolate(up_img[None, None], scale_factor=2, mode="bilinear",
                                      align_corners=False))
    paths = {"bench": (bench_img, slice_config().sift),
             "upscale": (pyr.scale_up(up_img),
                         dataclasses.replace(upscale_config(), up_scale=False))}
    for name, (img, cfg) in paths.items():
        # The base chain; its yardstick, a Conv2d 9x9 and L - 1 strided 5x5.
        lp, sd = pyramid.chain_taps(cfg.lowpass_radius, cfg.init_blur)
        L = cfg.num_octaves
        bases = pyramid.base_chain(img, cfg)
        H, W = img.shape
        convs = [_conv(taps, stride, dev) for taps, stride in ((lp, 1), (sd, 2))]

        def composed():
            x = convs[0](img[None, None])
            for _ in range(L - 1):
                x = convs[1](x)
            return x

        # Bytes: the source read once, every level written once.  Operations:
        # the prefilter's column and row passes (a multiply and an add per
        # tap), then per descent [h, w] -> [h/2, w/2] the 5 vertical taps on
        # the kept rows at full width and the 5 horizontal taps on the kept
        # columns.
        levels = [tuple(b.shape) for b in bases]
        out[f"K1+K2 {name} {H}x{W}, {L} levels"] = record(
            lambda: pyramid.base_chain(img, cfg),
            lambda: pyr.base_chain_plain(img, lp, sd, L),
            (4 * (H * W + sum(h * w for h, w in levels)),
             4 * len(lp) * H * W + sum(10 * (h // 2) * w + 10 * (h // 2) * (w // 2)
                                       for h, w in levels[:-1])),
            library=composed)

        # K3, lean and gated (octave o at 1 / 2**o); at the bench shape
        # also past 13 planes.
        scales = (cfg.num_scales, 11, 16) if name == "bench" else (cfg.num_scales,)
        for S in scales:
            c = dataclasses.replace(cfg, num_scales=S)
            bs = bases if S == cfg.num_scales else pyramid.base_chain(img, c)
            taps = [pyramid.octave_kernel_bank(c, o) for o in range(c.num_octaves)]
            planes, ntap = taps[0].shape
            gates = [1.0 / 2 ** o for o in range(c.num_octaves)]
            for lean in (True, False):
                if multi is None and not lean:
                    continue
                g = [0.0] * len(bs) if lean else gates
                if multi is None:
                    fn = (lambda: [detect.detect_maps(b, t, c.thresh, c.edge_limit)
                                   for b, t in zip(bs, taps)])
                else:
                    fn = (lambda: multi(bs, taps, c.thresh, c.edge_limit, g, lean=lean))
                cand = sum(int((r > 0).sum()) for r, _ in fn())
                out[f"K3 {'lean' if lean else 'gated'} {name} {levels[0]}, {planes} "
                    f"planes"] = record(
                    lambda: [t for r, a in fn() for t in (r, a)],
                    lambda: [detect.detect_maps_plain(b, t, c.thresh, c.edge_limit, gg,
                                                      lean=lean)
                             for b, t, gg in zip(bs, taps, g)],
                    k3_work(bs, planes, ntap, lean, cand))

    for name, img, sc in (("bench", bench_img, slice_config().sift),
                          ("upscale", up_img, upscale_config())):
        atlas, dets = frontend.detect_stage(img, sc)
        x, y, s, v, sharp = (torch.cat([getattr(d, f) for d in dets])
                             for f in ("x", "y", "scale", "valid", "sharpness"))
        seg = [d.x.shape[0] for d in dets]
        oc = compact.compaction_order(v)   # the module API's K8 input
        k8 = (x[oc], y[oc], s[oc], v.sum().to(torch.int32))
        order = frontend._sample_order(v, sharp, sc.sample_cap, seg)
        x, y, s, v = x[order], y[order], s[order], v[order]
        count = v.sum().to(torch.int32)
        if name == "upscale":
            k8 = (x, y, s, count)
        K, n = x.shape[0], int(count)
        # Bytes: the live keypoints' inputs and patches, every slot's outputs.
        fused = (patch_bytes(atlas, n, 40) + 3 * 4 * n + K * (128 * 4 + 4 + 4 + 1),
                 n * (ORI_OPS + PEAK_OPS + DESC_OPS))
        for k, kern in (("K4", sample.fused_orient_descriptor),
                        ("K9", sample.fused_orient_descriptor_win)):
            for c, live in ((count, n), *((torch.tensor(i, dtype=torch.int32, device=dev), i)
                                          for i in ((0, 1) if name == "bench" else ()))):
                out[f"{k} {name} {K} slots, {live} live"] = record(
                    lambda: kern(atlas, x, y, s, c),
                    lambda: sample.fused_orient_descriptor_plain(atlas, x, y, s, c),
                    fused if live == n else None)
        _, _, o2, dup = sample.fused_orient_descriptor(atlas, x, y, s, count)
        od = compact.compaction_order(dup & v)
        d5 = (x[od], y[od], s[od], o2[od], (dup & v).sum().to(torch.int32))
        out[f"K5 {name} {K} slots, {int(d5[4])} live"] = _k5(record, sample, atlas, d5)
        K8, n8 = k8[0].shape[0], int(k8[3])
        for c, live in ((k8[3], n8), *((torch.tensor(i, dtype=torch.int32, device=dev), i)
                                       for i in ((0, 1) if name == "bench" else ()))):
            out[f"K8 {name} {K8} slots, {live} live"] = record(
                lambda: sample.orientation_histogram_sample(atlas, *k8[:3], c),
                lambda: sample.orientation_histogram_sample_plain(atlas, *k8[:3], c),
                (patch_bytes(atlas, live, 16) + 3 * 4 * live + K8 * 32 * 4, live * ORI_OPS)
                if live == n8 else None)

        # The XLA route: the dense detector's capped slots, K8 on them, K5
        # on two-stage sampling's 2K slots compacted valid-first.
        xc = dataclasses.replace(sc, fused_detect=False, use_pallas=False)
        atlas, dets = frontend.detect_stage(img, xc)
        x, y, s, v, sharp = (torch.cat([getattr(d, f) for d in dets])
                             for f in ("x", "y", "scale", "valid", "sharpness"))
        order = frontend._sample_order(v, sharp, xc.sample_cap, [d.x.shape[0] for d in dets])
        x, y, s, v = x[order], y[order], s[order], v[order]
        count = v.sum().to(torch.int32)
        K, n = x.shape[0], int(count)
        out[f"K8 XLA route {name} {K} slots, {n} live"] = record(
            lambda: sample.orientation_histogram_sample(atlas, x, y, s, count),
            lambda: sample.orientation_histogram_sample_plain(atlas, x, y, s, count),
            (patch_bytes(atlas, n, 16) + 3 * 4 * n + K * 32 * 4, n * ORI_OPS))
        o1, o2, v2 = orient.orientations_from_histograms(
            sample.orientation_histogram_sample(atlas, x, y, s, count), v)
        valid2 = torch.cat([v, v2])
        o = compact.compaction_order(valid2)
        d5 = (*(torch.cat([p, q])[o] for p, q in ((x, x), (y, y), (s, s), (o1, o2))),
              valid2.sum().to(torch.int32))
        out[f"K5 XLA route {name} {2 * K} slots, {int(d5[4])} live"] = _k5(
            record, sample, atlas, d5)

    # K10 at the bench pair's shapes, with float [B, N] weights as the
    # probe has them.
    n = 2560
    R0, t0, x1, x2, _, w0 = (torch.as_tensor(a, device=dev)
                             for a in scene.refine_problem(17, n, 8))
    for B, iters in ((8, 6), (1, 10)):
        args = (R0[:B], t0[:B], x1, x2)
        kw = dict(weights=w0[:B], iters=iters)
        out[f"K10 B {B} x {iters} steps, N {n}"] = record(
            lambda: refine.refine_relative_pose(*args, **kw),
            lambda: refine.refine_relative_pose_plain(*args, **kw),
            (n * (24 + 4 * B) + B * 4 * (2 * 12 + 11),
             B * n * (REFINE_STEP_OPS * iters + REFINE_START_OPS)), reps=5, warmup=1)

    # ransac_pnp at the sequence cell's shape, and K11 on the LO inputs
    # it hands over.
    n = 15360
    x, X, Ri, ti, mask, sets = (torch.as_tensor(a, device=dev)
                                for a in scene.pnp_problem(19, n, 0.4, True, n_hyps=1024))

    def ransac():
        return pnp.ransac_pnp(x, X, mask, minimal_sets=sets, n_hyps=1024,
                              threshold=1.2e-5, R_init=Ri, t_init=ti)

    out[f"ransac_pnp N {n}, {int(mask.sum())} live, 1024 hypotheses"] = record(
        ransac, reps=5, warmup=1)
    if hasattr(pnp, "pnp_lo"):
        lo, calls = pnp.pnp_lo, []
        pnp.pnp_lo = lambda *a, **k: (calls.append((a, k)), lo(*a, **k))[1]
        try:
            ransac()
        finally:
            pnp.pnp_lo = lo
        (a, k), = calls
        out[f"K11 N {n}, {int(mask.sum())} live"] = record(
            lambda: pnp.pnp_lo(*a, **k), lambda: pnp.pnp_lo_plain(*a, **k),
            (n * (24 + 1 + 1) + 4 * (9 + 3 + 9 + 3 + 1), lo_ops(n, k["refine_iters"])),
            reps=5, warmup=1)

    # K12 (recover_pose, however the tree runs it: the plain route before
    # K12) at the bench pair's two sizes (the refine rounds' 512 vote
    # rows, the final vote's 2,560) and the sequence bootstrap's 5,120
    # slots, with 0/1 weights as the paths hand them.
    plain = getattr(pose, "recover_pose_plain", None)
    for n in (512, 2560, 5120):
        E, x1, x2, w = (torch.as_tensor(a, device=dev) for a in scene.pose_problem(21, n)[:4])
        out[f"K12 N {n}"] = record(
            lambda: pose.recover_pose(E, x1, x2, weights=w),
            plain and (lambda: plain(E, x1, x2, w)),
            (n * (2 * 12 + 4 + 12 + 2) + 4 * (9 + 9 + 3 + 2 + 4), 4 * n * POSE_ROW_OPS),
            reps=5, warmup=1)
    return out


def _k5(record_fn, sample, atlas, d5):
    """K5's row on (x, y, scale, ori, count), rows compacted valid-first."""
    rows_, n = d5[0].shape[0], int(d5[4])
    return record_fn(lambda: sample.descriptor_sample(atlas, *d5),
                     lambda: sample.descriptor_sample_plain(atlas, *d5),
                     (patch_bytes(atlas, n, 40) + 4 * 4 * n + rows_ * 128 * 4, n * DESC_OPS))


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
    return conv.requires_grad_(False)


def child(k6_only: bool) -> int:
    """The records of the tree in the working directory, as one JSON
    line: this checkout's scenes and configurations, the tree's package."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import synthetic_pair  # noqa: F401  (this checkout's, before the tree's path)
    from path_configs import card_line

    sys.path.insert(0, os.getcwd())
    import ctypes

    import torch

    from sfm_tpu_torch.ops import _cuda

    dev = torch.device("cuda", 0)
    lib = _cuda.library()
    res = {"tree": os.getcwd(), "card": card_line()}
    bps = getattr(lib.lib, "sfm_sample_blocks_per_sm", None)
    if bps is not None:
        n = (ctypes.c_int * 4)()
        _cuda.check(bps(ctypes.addressof(n)), "sfm_sample_blocks_per_sm")
        res["blocks_per_sm"] = dict(zip(("K4", "K5", "K8", "K9"), list(n)))
    res["rows"] = rows(dev, k6_only)
    print(json.dumps(res))
    return 0


def build_child() -> int:
    """Build the tree's kernels; print its ptxas lines and the HGMMA
    instructions of its matcher kernels as one JSON line."""
    import collections

    sys.path.insert(0, os.getcwd())
    from sfm_tpu_torch.ops import _cuda

    keep, lines = False, []
    for line in _cuda.library().build_log.splitlines():
        if "Compiling entry function" in line:
            keep = any(k in line for k in ("detect", "match", "fused", "descriptor",
                                           "orientation", "chain", "blur", "decim", "refine",
                                           "pnp_lo", "recover_pose"))
        if (keep and ("entry" in line or "registers" in line or "spill" in line)
                or "Performance Loss" in line):
            lines.append(line.strip())
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    if os.path.exists(tool):
        sass = subprocess.run([tool, "-sass", str(_cuda.library().path)],
                              capture_output=True, text=True).stdout
        fn, hgmma = None, collections.Counter()
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
            elif "HGMMA" in line and "match" in (fn or ""):
                hgmma[(fn, next(w for w in line.split() if w.startswith("HGMMA")))] += 1
        lines += [f"SASS {f}: {n} x {op}" for (f, op), n in sorted(hgmma.items())]
    print(json.dumps(lines))
    return 0


def build(trees) -> dict | None:
    """Build every distinct tree's kernels at once, one process each;
    returns {tree: its ptxas lines}, or None if a build failed."""
    procs = {t: subprocess.Popen([sys.executable, __file__, "--build"],
                                 cwd=os.path.abspath(t), stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for t in dict.fromkeys(trees)}
    lines = {}
    for tree, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=900)
        if proc.returncode != 0:
            print(stdout + stderr, file=sys.stderr)
            return None
        lines[tree] = json.loads(stdout.strip().splitlines()[-1])
    return lines


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--build"]:
        return build_child()
    if args[:1] == ["--child"]:
        return child(args[1:] == ["--k6"])
    k6_only = args[:1] == ["--k6"]
    trees = args[k6_only:] or ["."]
    ptxas = build(trees)
    if ptxas is None:
        return 1
    results = []
    for i, tree in enumerate(trees):
        proc = subprocess.run([sys.executable, __file__, "--child"] + ["--k6"] * k6_only,
                              cwd=os.path.abspath(tree), capture_output=True, text=True,
                              timeout=1800)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["ptxas"] = ptxas[tree] if tree not in trees[:i] else []
        for line in res["ptxas"]:
            print("  ptxas:", line)
        print(json.dumps({k: res[k] for k in ("card", "blocks_per_sm", "rows") if k in res}
                         | {"tree": tree}), flush=True)
        results.append(res)
    digests = [{k: r["digest"] for k, r in res["rows"].items()} for res in results]
    differ = sorted({k for d in digests for k, v in d.items() if digests[0].get(k) != v})
    print(f"output digests equal across the trees: "
          f"{not differ}{'; differing: ' + ', '.join(differ) if differ else ''}", flush=True)
    k9_k4 = all(v == d[k.replace("K9", "K4", 1)] for d in digests
                for k, v in d.items() if k.startswith("K9"))
    print(f"K9's digests equal K4's in every tree: {k9_k4}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "kernel_ab.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
