"""Entry ``incremental_sequence``: one request is one whole incremental
reconstruction, ``models/incremental.run_incremental`` on the pool
item's frames at the configuration's ``sequence`` settings (SIFT on
every frame, the top-2 matcher on each pair, the two-view bootstrap,
PnP registration against ``n_back`` frames, the windowed local BA, the
closure pairs, the global BA with its pruning), with every RANSAC's
minimal sets handed in as uniforms mapped onto the rows the port draws
over (``run_incremental``'s callable ``minimal_sets``).  The pool holds
``pool`` sequences of the configuration's size, each the arc of the
traffic's fixed ``scene_seed`` with sensor noise drawn from the run's
seed (``gen.sequence``); the seed also orders the pool, and request r
takes its sequence r mod pool and uniforms drawn from its own seed.

In a traced run the requests after the profiled slice hand
``run_incremental`` a timer whose synchronized stages (``register``,
``local_ba``, ``global_ba``, ...) become the harness's spans; the
profiled slice runs without it, so its syncs are the program's own.

The check makes each frame's keypoints and each pair's matches with the
frozen plain twins of the frontend and the matcher (``reference/sfm``),
maps the same uniforms onto its own rows and runs the multi-view path
written apart from the port in float64 (``reference/sequence.py``).
"""

from __future__ import annotations

import contextlib
import math
import sys
import time

import numpy as np
import torch

from portbench.gen import scene as render
from portbench.gen import sequence as gen
from portbench.harness import compare as cmp
from portbench.harness import draws
from portbench.harness import trace as tr
from portbench.harness.pipeline import pipeline_config, span, to_host

_STATE = ("R", "t", "pose_valid", "X", "X_valid", "point_id")


def sequence_pairs(frames: int, n_back: int, closures) -> list:
    """The (p, i) frame pairs ``run_incremental`` matches, in its order."""
    pairs = [(0, 1)]
    for i in range(2, frames):
        pairs += [(p, i) for p in range(i - 1, max(i - 1 - n_back, -1), -1)]
    return pairs + [tuple(c) for c in closures]


class _Timer:
    """A ``StageTimer`` in the port's ``timer=`` place: each synchronized
    stage it records becomes one of the harness's spans."""

    def __init__(self, spans):
        self.spans = spans

    def record(self, name, seconds):
        t1 = time.perf_counter()
        self.spans.items.append(tr.Span(name, self.spans.request, t1 - seconds, t1))


class Entry:
    span_names = ("sequence",)
    compared = ("corr_miss", "rot_gap_deg", "centre_gap", "track_gap", "ba_descent")
    by_median = ()

    def __init__(self, config, traffic, seed, dev):
        from sfm_tpu_torch import config as cfgmod

        self.dev, self.seed = dev, seed
        self.config, self.traffic = config, traffic
        self.seq = config["sequence"]
        self.units_per_request = self.seq["frames"]
        self.cfg = pipeline_config(cfgmod, config, traffic)
        self.n_hyps = self.cfg.ransac.n_hyps
        self.pairs = sequence_pairs(self.seq["frames"], self.seq["n_back"],
                                    self.seq["closure_pairs"])
        self.pool, self.truth = [], []
        for i in range(traffic["pool"]):
            s = gen.synthetic_sequence(
                config["height"], config["width"], self.seq["frames"], self.seq["step_deg"],
                scene=render.TorchDraws(draws.derive(traffic["scene_seed"], "scene", i), dev),
                noise=render.TorchDraws(draws.derive(seed, "noise", i), dev), device=dev)
            self.pool.append(list(s["images"]))
            self.truth.append((s["R"].astype(np.float64), s["t"].astype(np.float64)))
        self.order = draws.order(seed, len(self.pool))
        self.K = s["K"]
        self.u = None
        self._front = {}

    def _uniforms(self, r) -> dict:
        """Frame -> [n_hyps, k] uniforms: 0 the bootstrap's (k = 8), i >= 2
        frame i's PnP (k = 6)."""
        out = {0: draws.uniforms(draws.derive(self.seed, "ransac", r, 0), self.n_hyps, 8,
                                 self.dev)}
        for i in range(2, self.seq["frames"]):
            out[i] = draws.uniforms(draws.derive(self.seed, "ransac", r, i), self.n_hyps, 6,
                                    self.dev)
        return out

    def _item(self, r) -> int:
        return self.order[r % len(self.order)] if isinstance(r, int) else self.order[0]

    def _settings(self) -> dict:
        s = self.seq
        return {"n_back": s["n_back"], "local_ba_iters": s["local_ba_iters"],
                "local_ba_window": s["local_ba_window"], "ba_iters": s["ba_iters"],
                "closure_pairs": [tuple(c) for c in s["closure_pairs"]]}

    def warm(self):
        if self.dev.type == "cuda":
            from sfm_tpu_torch.ops import _cuda

            _cuda.library()
        for w in range(self.traffic.get("warm_requests", 1)):
            self.prepare(f"warm{w}")
            self.request(w, None, keep=False)

    def prepare(self, r):
        self.u = self._uniforms(r)

    def request(self, r, spans, keep):
        from sfm_tpu_torch.models import incremental

        sets = {i: (lambda mask, u=u: draws.minimal_sets(u, mask)) for i, u in self.u.items()}
        # The profiled slice runs without the timer: its syncs are the program's.
        timed = (spans is not None and isinstance(r, int)
                 and r >= self.traffic["profile_requests"])
        with span(spans, "sequence"):
            res = incremental.run_incremental(
                self.pool[self._item(r)], self.K, self.cfg,
                timer=_Timer(spans) if timed else None, minimal_sets=sets, device=self.dev,
                **self._settings())
        st = res.state
        out = {"item": self._item(r), "pose_valid": st.pose_valid, "X_valid": st.X_valid,
               "mean_reproj": res.mean_reproj}
        if keep:
            out.update({k: getattr(st, k) for k in _STATE})
            out.update(uv=res.uv, kp_valid=res.kp_valid, kept=res.kept, matches=res.matches)
        return to_host(out)

    def work(self, out) -> dict:
        return {"registered": int(out["pose_valid"].sum()),
                "points": int(out["X_valid"].sum()),
                "mean_reproj": float(out["mean_reproj"])}

    def release(self):
        self.u = None

    # --- the check ---

    def _frontend(self, item, control):
        """Keypoints (uv [M, K, 2], valid [M, K]) and the matches {(p, i):
        (index, valid)} of the pool item by the frozen twins of the
        frontend and the matcher (one precision down under ``control``)."""
        if (item, control) in self._front:
            return self._front[(item, control)]
        from portbench.reference.sfm import config as refcfg
        from portbench.reference.sfm.sift import frontend, match
        from portbench.reference.sfm.utils import precision

        cfg = pipeline_config(refcfg, self.config, self.traffic)
        with precision.control() if control else contextlib.nullcontext():
            feats = [frontend.extract_sift(im, cfg.sift) for im in self.pool[item]]
            matches = {}
            for p, i in self.pairs:
                m = match.match(feats[p].descriptors, feats[i].descriptors,
                                feats[p].keypoints.valid, feats[i].keypoints.valid, cfg.match)
                matches[(p, i)] = to_host((m.index, m.valid))
        uv = torch.stack([torch.stack([f.keypoints.x, f.keypoints.y], -1) for f in feats])
        valid = torch.stack([f.keypoints.valid for f in feats])
        self._front[(item, control)] = (to_host(uv), to_host(valid), matches)
        return self._front[(item, control)]

    def reference(self, r, control=False):
        from portbench.reference import sequence
        from portbench.reference.sfm import config as refcfg

        item = self._item(r)
        uv, valid, matches = self._frontend(item, control)
        u = self._uniforms(r)
        sets = {i: (lambda mask, u=v: draws.minimal_sets(u, mask.to(u.device)).cpu())
                for i, v in u.items()}
        cfg = pipeline_config(refcfg, self.config, self.traffic)
        s = sequence.run(uv, valid, matches, self.K, cfg, sets, control=control,
                         **self._settings())
        out = {k: getattr(s, k) for k in _STATE}
        out.update(item=item, uv=uv, kp_valid=valid, kept=s.kept, mean_reproj=s.mean_reproj,
                   matches=matches)
        return out

    def compare(self, got, ref) -> dict:
        """corr_miss: over every pair the sequence matches, the largest of
        the pair cell's measure (the larger share of either side's valid
        correspondences with no partner within 0.01 px in both frames);
        the port's correspondences are the judged request's own (its
        keypoints and the matches it registered and closed with), the
        check's the frozen twins';
        rot_gap_deg: the largest over frames 1.. of the angle between the
        rotations (frame 0 is the identity on both); centre_gap: the
        largest over those frames of the distance between the camera
        centres, the judged ones scaled by the least-squares factor (the
        map's scale is free), over the reference sequence's extent (its
        centres' largest distance from frame 0's); the worst frame, so
        that one misregistered frame shows; both read infinity where a
        frame is registered on one side only (a count of such frames
        never separated the port from the control: both register every
        frame);
        track_gap: the map's tracks, which no pose reads: the share of
        the track links (two kept observations, frame and slot, of one
        point) that one side has and the other lacks, over both sides'
        links (``track_links``); a closure that merges or passes on no
        id, or a registration that drops ids, loses links;
        ba_descent: at the judged final state, the relative cost drop that
        5 float64 LM steps of the reference make over the judged kept
        observations (``reference/sequence.ba_descent``): whether the
        judged BA ended at the float64 optimum of its own problem, which
        no tipped count upstream moves.
        A run compares each number's worst over the judged requests."""
        from portbench.reference import sequence

        miss = 0.0
        for p, i in self.pairs:
            def corr(o):
                index, ok = o["matches"][(p, i)]
                ok = ok & o["kp_valid"][p] & o["kp_valid"][i][index]
                return np.concatenate([o["uv"][p][ok], o["uv"][i][index][ok]], 1)

            cg, cr = corr(got), corr(ref)
            tol = [0.01] * 4
            miss = max(miss, cmp.unpaired_share(cmp.pair_rows(cg, cr, tol, self.dev),
                                                cmp.pair_rows(cr, cg, tol, self.dev)))
        vg, vr = np.asarray(got["pose_valid"], bool), np.asarray(ref["pose_valid"], bool)
        both = np.nonzero(vg & vr)[0]
        both = both[both > 0]
        Rg, tg = np.asarray(got["R"], np.float64), np.asarray(got["t"], np.float64)
        Rr, tr_ = np.asarray(ref["R"], np.float64), np.asarray(ref["t"], np.float64)
        rot = [cmp.rotation_gap_deg(Rg[f], Rr[f]) for f in both]
        Cg = -np.einsum("nji,nj->ni", Rg, tg)
        Cr = -np.einsum("nji,nj->ni", Rr, tr_)
        s = float(np.sum(Cg[both] * Cr[both]) / max(np.sum(Cg[both] ** 2), 1e-300))
        extent = max(float(np.max(np.linalg.norm(Cr[vr] - Cr[0], axis=1))), 1e-300)
        centre = np.linalg.norm(s * Cg[both] - Cr[both], axis=1) / extent
        lg, lr = track_links(got["point_id"], got["kept"]), track_links(ref["point_id"],
                                                                        ref["kept"])
        union = len(np.union1d(lg, lr))
        tracks = 1.0 - len(np.intersect1d(lg, lr)) / union if union else math.inf
        x = sequence.normalized(got["uv"], self.K, sequence.Arith(False))
        uvn = (x[..., :2] / x[..., 2:]).numpy()
        descent = sequence.ba_descent(Rg, tg, got["X"], np.asarray(got["point_id"]),
                                      got["kept"], uvn, vg)
        if vg.sum() >= 3:   # printed, not judged: the poses against the rendered ones
            from sfm_tpu_torch.utils import metrics

            R_gt, t_gt = self.truth[got["item"]]
            ate, _ = metrics.ate_rmse(Rg[vg], tg[vg], R_gt[vg], t_gt[vg])
            worst = max(cmp.rotation_gap_deg(Rg[f], R_gt[f]) for f in np.nonzero(vg)[0])
            print(f"sequence {got['item']}: ATE {ate!r} (Sim(3)-aligned, units of the arc's "
                  f"radius 7), rotation error deg max {worst!r}", file=sys.stderr)
        nan = float("nan")
        same = bool((vg == vr).all())
        return {
            "corr_miss": miss,
            "rot_gap_deg": max(rot) if rot and same else nan,
            "centre_gap": float(centre.max()) if len(both) and same else nan,
            "track_gap": tracks,
            "ba_descent": descent if math.isfinite(descent) else nan,
        }


def track_links(point_id, kept) -> np.ndarray:
    """The sorted links of a map: a * n + b for every two kept
    observations a < b (flat frame * slots + slot, n of them) of one
    point (``point_id`` [M, K])."""
    point_id = np.asarray(point_id)
    n = point_id.size
    obs = np.nonzero(np.asarray(kept, bool).reshape(-1))[0]
    pid = point_id.reshape(-1)[obs]
    order = np.argsort(pid, kind="stable")
    obs, pid = obs[order], pid[order]
    cut = np.flatnonzero(np.diff(pid)) + 1
    links = [np.zeros(0, np.int64)]
    for track in np.split(obs, cut):
        a, b = np.triu_indices(len(track), 1)
        links.append(track[a].astype(np.int64) * n + track[b])
    return np.unique(np.concatenate(links))
