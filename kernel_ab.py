#!/usr/bin/env python3
"""A/B times of the port's base chain (K1 + K2), K3 (detection maps),
K4, K5, K8 and K9 (keypoint sampling), K6 (matcher), K10 (pose
refinement) and K11 (PnP's LO stage) kernels for two or more checkouts
of the repository, on one card.

Run from the repository root on a machine with an NVIDIA card:

    python3 kernel_ab.py [--k6] TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one); ``--k6`` times
K6 alone (its rows below), for variants of the matcher.  First every
distinct tree builds its kernels, all at once, one process each; then
the trees run in the order given, each in a process of its own (the
package has one name), so ``OLD NEW NEW OLD`` alternates them on the
same card.  Per tree: the ``-Xptxas -v`` lines of its pyramid, K3, K4,
K5, K6, K8 and K9 kernels (registers, shared memory, spills) and the
tensor-core instructions (HGMMA) of K6's kernels in their SASS, the
sampling kernels' resident blocks per SM where the tree reports them,
then CUDA-event milliseconds per call (mean of 20 after 3 warm-ups) and
device milliseconds alone (the calls queued behind a spin kernel) of

- the base chain (``sift.pyramid.base_chain``: the prefilter and 4
  descents) of one image, the bench path's 576 x 720 synthetic image
  and the up-scale path's 1920 x 2560 base (the 960 x 1280 rotation
  pair's first image up-scaled), however the tree launches it (one
  launch per image, or one per level), with a digest of its levels;
- K3 on the 5 octave bases of the same images, however the tree
  launches it (one launch per image, or one per octave), lean and in
  the gated mode at ``lowest_scale=1.0``'s gates, with a digest of its
  maps;
- K6 ``match_top2`` on seeded unit descriptors at 5,120^2 x 128 and
  23,552^2 x 128 (all columns valid) in both modes, bf16 and f32, with
  the f32 ``torch.topk(a @ b.T, 2)`` (TF32 off) beside them;
- K4 and K9 on the capped sample slots of that image's ``detect_stage``
  and K5 on their duplicate subset, as ``chip_smoke.py`` builds them
  (the bench path's config on the 576 x 720 image: 2,560 slots; up_t2.0
  on the 960 x 1280 one: 11,776);
- K8 as the module API runs it on the bench image (all 5,120 detection
  slots, compacted valid-first) and on the up-scale image's capped
  slots; and K4, K8 and K9 on the bench slots with 0 and 1 of them live
  (a launch's floor, and one warp's latency);
- K10 (``refine_relative_pose``, however the tree runs it: the plain
  ``jvp`` route before K10) at the bench pair's shapes, 8 starts x 6
  steps and 1 x 10 at 2,560 seeded correspondences, also profiled
  (device operations and their device ms; ``launches`` in the record);
- ``ransac_pnp`` whole, however the tree runs its LO stage (the plain
  route inside it before K11), and K11 (``pnp_lo``) alone where the
  tree has it, on its own LO inputs there, at the sequence cell's shape:
  15,360 rows (3 frames x 5,120 slots), 40% of them live, 1,024
  hypotheses, the prior winning (``tests/synthetic_pair.py:pnp_problem``),
  also profiled,

with a digest (SHA-256) of each kernel's outputs there, so that one
call shows whether the trees' outputs are equal bit for bit as well as
their times.

Prints one JSON line per tree, then whether the digests agree across
the trees (and which differ) and whether K9's equal K4's in every tree,
and writes the trees' records to ``chiprun_out/kernel_ab.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

_BUILD = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
from sfm_tpu_torch.ops import _cuda
keep, lines = False, []
for line in _cuda.library().build_log.splitlines():
    if "Compiling entry function" in line:
        keep = any(k in line for k in ("detect", "match", "fused", "descriptor",
                                       "orientation", "chain", "blur", "decim", "refine",
                                       "pnp_lo"))
    if (keep and ("entry" in line or "registers" in line or "spill" in line)
            or "Performance Loss" in line):
        lines.append(line.strip())
# SASS: tensor-core instructions (HGMMA) per matcher kernel
import collections, subprocess
tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
if os.path.exists(tool):
    sass = subprocess.run([tool, "-sass", str(_cuda.library().path)], capture_output=True,
                          text=True).stdout
    fn, hgmma = None, collections.Counter()
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif "HGMMA" in line and "match" in (fn or ""):
            hgmma[(fn, next(w for w in line.split() if w.startswith("HGMMA")))] += 1
    lines += [f"SASS {f}: {n} x {op}" for (f, op), n in sorted(hgmma.items())]
print(json.dumps(lines))
'''

_CHILD = r'''
import ctypes, hashlib, importlib.util, json, os, sys
sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "tests")]
import numpy as np, torch
spec = importlib.util.spec_from_file_location("ab_timing", sys.argv[1])
timing = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timing)   # this checkout's chip_smoke.py: the same clocks for every tree
card_line, cuda_ms, device_ms = timing.card_line, timing.cuda_ms, timing.device_ms
from sfm_tpu_torch.config import SiftConfig
from sfm_tpu_torch.ops import _cuda, compact, detect, match, sample
from sfm_tpu_torch.ops import pyramid as pyr
from sfm_tpu_torch.sift import frontend, pyramid
from synthetic_pair import rotation_pair, synthetic_pair

dev = torch.device("cuda", 0)
lib = _cuda.library()
out = {"tree": os.getcwd(), "card": card_line(), "ms": {}, "digest": {}}
bps = getattr(lib.lib, "sfm_sample_blocks_per_sm", None)
if bps is not None:
    n = (ctypes.c_int * 4)()
    _cuda.check(bps(ctypes.addressof(n)), "sfm_sample_blocks_per_sm")
    out["blocks_per_sm"] = dict(zip(("K4", "K5", "K8", "K9"), list(n)))


def digest(tensors):
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in tensors)
                          ).hexdigest()[:16]


K6_ONLY = sys.argv[2] == "1"
multi = getattr(detect, "detect_maps_octaves", None)
images = {} if K6_ONLY else {"bench": torch.as_tensor(synthetic_pair(576, 720, seed=0)["img1"], device=dev),
          "upscale": pyr.scale_up(torch.as_tensor(
              rotation_pair(960, 1280, seed=0)["img1"], device=dev))}
for name, img in images.items():
    cfg = SiftConfig(thresh=2.0, init_blur=1.0) if name == "upscale" else SiftConfig()
    chain = lambda: pyramid.base_chain(img, cfg)
    key = f"K1+K2 {name} {tuple(img.shape)}, {cfg.num_octaves} levels"
    out["ms"][key] = (cuda_ms(chain), device_ms(chain))
    bases = chain()
    out["digest"][key] = digest(bases)
    taps = [pyramid.octave_kernel_bank(cfg, o) for o in range(cfg.num_octaves)]
    gates = [1.0 / 2 ** o for o in range(cfg.num_octaves)]
    modes = {"lean": lambda: multi(bases, taps, cfg.thresh, cfg.edge_limit),
             "gated": lambda: multi(bases, taps, cfg.thresh, cfg.edge_limit, gates,
                                    lean=False)}
    if multi is None:
        modes = {"lean": lambda: [detect.detect_maps(b, t, cfg.thresh, cfg.edge_limit)
                                  for b, t in zip(bases, taps)]}
    for mode, fn in modes.items():
        key = f"K3 {mode} {name} {tuple(bases[0].shape)}"
        out["ms"][key] = (cuda_ms(fn), device_ms(fn))
        out["digest"][key] = digest([t for r, a in fn() for t in (r, a)])
rng = np.random.default_rng(0)
for n in (5120, 23552):
    d = np.abs(rng.normal(size=(2 * n, 128))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    a, b = torch.as_tensor(d[:n], device=dev), torch.as_tensor(d[n:], device=dev)
    v = torch.ones(n, dtype=torch.bool, device=dev)
    for mode in ("bf16", "f32"):
        fn = lambda: match.match_top2(a, b, v, bf16=mode == "bf16")
        key = f"K6 {mode} {n}^2 x 128"
        out["ms"][key] = (cuda_ms(fn), device_ms(fn))
        out["digest"][key] = digest(fn())
    torch.backends.cuda.matmul.allow_tf32 = False
    out["ms"][f"topk(a @ b.T, 2) f32 {n}^2 x 128"] = cuda_ms(lambda: torch.topk(a @ b.T, 2))

for name, img, sc in () if K6_ONLY else (
        ("bench", synthetic_pair(576, 720, seed=0)["img1"], timing.slice_config().sift),
        ("upscale", rotation_pair(960, 1280, seed=0)["img1"], timing.upscale_config())):
    atlas, dets = frontend.detect_stage(torch.as_tensor(img, device=dev), sc)
    x, y, s, v, sharp = (torch.cat([getattr(d, f) for d in dets])
                         for f in ("x", "y", "scale", "valid", "sharpness"))
    oc = compact.compaction_order(v)   # the module API's K8 input
    k8 = (x[oc], y[oc], s[oc], v.sum().to(torch.int32))
    order = frontend._sample_order(v, sharp, sc.sample_cap)
    x, y, s, v = x[order], y[order], s[order], v[order]
    count = v.sum().to(torch.int32)
    if name == "upscale":
        k8 = (x, y, s, count)
    for k, fn in (("K4", lambda: sample.fused_orient_descriptor(atlas, x, y, s, count)),
                  ("K9", lambda: sample.fused_orient_descriptor_win(atlas, x, y, s,
                                                                     count))):
        key = f"{k} {name} {x.shape[0]} slots, {int(count)} live"
        out["digest"][key] = digest(fn())
        out["ms"][key] = (cuda_ms(fn), device_ms(fn))
    d1, o1, o2, dup = sample.fused_orient_descriptor(atlas, x, y, s, count)
    fn = lambda: sample.orientation_histogram_sample(atlas, *k8)
    key = f"K8 {name} {k8[0].shape[0]} slots, {int(k8[3])} live"
    out["digest"][key] = digest((fn(),))
    out["ms"][key] = (cuda_ms(fn), device_ms(fn))
    for live in (0, 1) if name == "bench" else ():  # a launch's floor; one warp's chain
        c = torch.tensor(live, dtype=torch.int32, device=dev)
        for k, n, fn in (
                ("K4", x.shape[0], lambda: sample.fused_orient_descriptor(atlas, x, y, s, c)),
                ("K9", x.shape[0], lambda: sample.fused_orient_descriptor_win(atlas, x, y, s,
                                                                              c)),
                ("K8", k8[0].shape[0], lambda: sample.orientation_histogram_sample(
                    atlas, *k8[:3], c))):
            out["ms"][f"{k} {name} {n} slots, {live} live"] = (cuda_ms(fn), device_ms(fn))
    v2 = dup & v
    od = compact.compaction_order(v2)
    xd, yd, sd, od2 = x[od], y[od], s[od], o2[od]
    c2 = v2.sum().to(torch.int32)
    fn = lambda: sample.descriptor_sample(atlas, xd, yd, sd, od2, c2)
    key = f"K5 {name} {x.shape[0]} slots, {int(c2)} live"
    out["ms"][key] = (cuda_ms(fn), device_ms(fn))
    out["digest"][key] = digest((fn(),))
# K10 (refine_relative_pose) at the bench pair's shapes, however the tree
# runs it (the plain jvp route before K10): the tests' seeded scene of
# 2,560 correspondences (tests/synthetic_pair.py:refine_problem, of this
# checkout), the probe's 8 starts x 6 steps and a round's 1 x 10, with
# float [B, N] weights as the probe has them.
from sfm_tpu_torch.geometry import refine
spec = importlib.util.spec_from_file_location(
    "ab_scene", os.path.join(os.path.dirname(sys.argv[1]), "tests", "synthetic_pair.py"))
scene = importlib.util.module_from_spec(spec)
spec.loader.exec_module(scene)
n = 2560
R0, t0, x1, x2, _, w0 = (torch.as_tensor(a, device=dev)
                         for a in scene.refine_problem(17, n, 8))
out["launches"] = {}
for B, iters in () if K6_ONLY else ((8, 6), (1, 10)):
    fn = lambda: refine.refine_relative_pose(R0[:B], t0[:B], x1, x2, weights=w0[:B],
                                             iters=iters)
    key = f"K10 B {B} x {iters} steps, N {n}"
    out["digest"][key] = digest(fn())
    out["ms"][key] = (cuda_ms(fn, reps=5, warmup=1), device_ms(fn, reps=5, warmup=1))
    out["launches"][key] = timing.profile_launches(fn)
# ransac_pnp at the sequence cell's shape, however the tree runs its LO
# stage, and K11 (pnp_lo) alone on the LO inputs it hands over where the
# tree has it: the tests' seeded registration (pnp_problem, of this
# checkout), 15,360 rows, 40% live, 1,024 hypotheses, the prior winning.
from sfm_tpu_torch.geometry import pnp
n = 15360
x, X, Ri, ti, mask, sets = (torch.as_tensor(a, device=dev)
                            for a in scene.pnp_problem(19, n, 0.4, True, n_hyps=1024))
ransac = lambda: pnp.ransac_pnp(x, X, mask, minimal_sets=sets, n_hyps=1024, threshold=1.2e-5,
                                R_init=Ri, t_init=ti)
lo_calls = []
if not K6_ONLY and hasattr(pnp, "pnp_lo"):
    lo = pnp.pnp_lo
    pnp.pnp_lo = lambda *a, **k: (lo_calls.append((a, k)), lo(*a, **k))[1]
    ransac()
    pnp.pnp_lo = lo
for key, fn in () if K6_ONLY else (
        (f"ransac_pnp N {n}, {int(mask.sum())} live, 1024 hypotheses", ransac),
        *((f"K11 N {n}, {int(mask.sum())} live", lambda: pnp.pnp_lo(*a, **k))
          for a, k in lo_calls[:1])):
    out["digest"][key] = digest(fn())
    out["ms"][key] = (cuda_ms(fn, reps=5, warmup=1), device_ms(fn, reps=5, warmup=1))
    out["launches"][key] = timing.profile_launches(fn)
print(json.dumps(out))
'''


def build(trees) -> dict | None:
    """Build every distinct tree's kernels at once, one process each;
    returns {tree: its ptxas lines}, or None if a build failed."""
    procs = {t: subprocess.Popen([sys.executable, "-c", _BUILD], cwd=os.path.abspath(t),
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True)
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
    k6_only = sys.argv[1:2] == ["--k6"]
    trees = sys.argv[1 + k6_only:] or ["."]
    ptxas = build(trees)
    if ptxas is None:
        return 1
    results = []
    for i, tree in enumerate(trees):
        proc = subprocess.run([sys.executable, "-c", _CHILD,
                               os.path.join(ROOT, "chip_smoke.py"), str(int(k6_only))],
                              cwd=os.path.abspath(tree),
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["ptxas"] = ptxas[tree] if tree not in trees[:i] else []
        for line in res["ptxas"]:
            print("  ptxas:", line)
        print(json.dumps({k: res[k] for k in ("card", "blocks_per_sm", "ms", "digest",
                                              "launches")
                          if k in res} | {"tree": tree}), flush=True)
        results.append(res)
    differ = sorted({k for r in results for k, v in r["digest"].items()
                     if results[0]["digest"].get(k) != v})
    print(f"output digests (base chain, K3, K4, K5, K6, K8, K9, K10, ransac_pnp, K11) equal "
          f"across the trees: "
          f"{not differ}{'; differing: ' + ', '.join(differ) if differ else ''}",
          flush=True)
    k9_k4 = all(v == r["digest"][k.replace("K9", "K4", 1)] for r in results
                for k, v in r["digest"].items() if k.startswith("K9"))
    print(f"K9's digests equal K4's in every tree: {k9_k4}", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "kernel_ab.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
