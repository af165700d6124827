"""Entry ``turntable_ring``: one request is one whole turntable ring,
``models/turntable.reconstruct_ring`` on the pool item's frames at the
configuration's ``ring`` settings (SIFT on every frame, the incremental
chain, the ring tracks over the wrapped pairs, the pinned LM with the
shared camera's f and k1, the annealed free-gauge BA and the snap to
the fitted ring), with the chain's RANSAC minimal sets handed in as
uniforms mapped onto the rows the port draws over (the callable
``minimal_sets``).  The pool holds ``pool`` rings, each the ring of
``gen.ring`` with the traffic's fixed ``scene_seed`` and sensor noise
drawn from the run's seed; the seed also orders the pool, and request
r takes its ring r mod pool and uniforms drawn from its own seed.

In a traced run the requests after the profiled slice hand the entry
point a timer whose synchronized stages (``extract``, the chain's,
``tracks``, ``pinned_lm``, ``free_ba``, ``snap``) become the harness's
spans; the profiled slice runs without it, so its syncs are the
program's own.

The check makes each frame's keypoints and each pair's matches with the
frozen plain twins of the frontend and the matcher (``reference/sfm``),
takes frames 0 and 1's poses from the sequence reference's bootstrap
with the same uniforms, and runs the ring written apart from the port
in float64 (``reference/turntable.py``) on the entry's device.  The
free BA holds no camera, so the two sides may end the same ring under
different similarity transforms: every judged pose number is blind to
one (``compare``).
"""

from __future__ import annotations

import contextlib
import math
import sys
import time

import numpy as np
import torch

from portbench.gen import ring as gen
from portbench.gen import scene as render
from portbench.harness import compare as cmp
from portbench.harness import draws
from portbench.harness import trace as tr
from portbench.harness.pipeline import pipeline_config, span, to_host


def chain_pairs(frames: int, n_back: int = 3) -> list:
    """The (p, i) frame pairs ``run_incremental`` matches, in its order."""
    pairs = [(0, 1)]
    for i in range(2, frames):
        pairs += [(p, i) for p in range(i - 1, max(i - 1 - n_back, -1), -1)]
    return pairs


class _Timer:
    """A ``StageTimer`` in the port's ``timer=`` place: each synchronized
    stage it records becomes one of the harness's spans."""

    def __init__(self, spans):
        self.spans = spans

    def record(self, name, seconds):
        t1 = time.perf_counter()
        self.spans.items.append(tr.Span(name, self.spans.request, t1 - seconds, t1))


class Entry:
    span_names = ("ring",)
    compared = ("corr_miss", "track_gap", "f_gap", "step_gap_deg", "rot_gap_deg",
                "ba_descent", "frame_descent")
    by_median = ()

    def __init__(self, config, traffic, seed, dev):
        from sfm_tpu_torch import config as cfgmod
        from sfm_tpu_torch.models import turntable
        from portbench.reference import turntable as ref

        if not hasattr(turntable, "reconstruct_ring"):
            raise SystemExit("turntable_ring: the program has no models/turntable.py:"
                             "reconstruct_ring, the ring's entry point")
        self.dev, self.seed = dev, seed
        self.config, self.traffic = config, traffic
        self.ring = config["ring"]
        self.frames = self.ring["frames"]
        self.units_per_request = self.frames
        self.cfg = pipeline_config(cfgmod, config, traffic)
        self.n_hyps = self.cfg.ransac.n_hyps
        tt = self.ring["turntable"]
        self.ring_pairs = ref.ring_pairs(self.frames, tuple(tt["gaps"]), tt["wrap"])
        self.pairs = list(dict.fromkeys(chain_pairs(self.frames) + self.ring_pairs))
        self.pool, self.truth = [], []
        for i in range(traffic["pool"]):
            s = gen.synthetic_ring(
                config["height"], config["width"], self.frames, self.ring["step_deg"],
                self.ring["focal_px"], self.ring["k1"],
                scene=render.TorchDraws(draws.derive(traffic["scene_seed"], "scene", i), dev),
                noise=render.TorchDraws(draws.derive(seed, "noise", i), dev), device=dev,
                texture_n=self.ring["texture_n"])
            self.pool.append(list(s["images"]))
            self.truth.append((s["R"].astype(np.float64), s["t"].astype(np.float64)))
        self.order = draws.order(seed, len(self.pool))
        self.K = s["K"]
        self.u = None
        self._front = {}

    def _uniforms(self, r) -> dict:
        """Frame -> [n_hyps, k] uniforms: 0 the chain's bootstrap (k = 8),
        i >= 2 frame i's PnP (k = 6)."""
        out = {0: draws.uniforms(draws.derive(self.seed, "ransac", r, 0), self.n_hyps, 8,
                                 self.dev)}
        for i in range(2, self.frames):
            out[i] = draws.uniforms(draws.derive(self.seed, "ransac", r, i), self.n_hyps, 6,
                                    self.dev)
        return out

    def _item(self, r) -> int:
        return self.order[r % len(self.order)] if isinstance(r, int) else self.order[0]

    def _settings(self) -> dict:
        tt = dict(self.ring["turntable"])
        tt["gaps"], tt["axis_hint"] = tuple(tt["gaps"]), tuple(tt["axis_hint"])
        return {**self.ring["chain"], **tt}

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
        from sfm_tpu_torch.models import turntable

        sets = {i: (lambda mask, u=u: draws.minimal_sets(u, mask)) for i, u in self.u.items()}
        # The profiled slice runs without the timer: its syncs are the program's.
        timed = (spans is not None and isinstance(r, int)
                 and r >= self.traffic["profile_requests"])
        with span(spans, "ring"):
            res = turntable.reconstruct_ring(
                self.pool[self._item(r)], self.K, self.cfg, minimal_sets=sets,
                device=self.dev, timer=_Timer(spans) if timed else None, **self._settings())
        out = {"item": self._item(r), "rms_px": res.rms_px, "tracks": res.tracks.n_tracks,
               "kept": res.keep}
        if keep:
            ts, chain = res.tracks, res.chain
            out.update(R=res.R, t=res.t, X=res.X, f=res.f, k1=res.k1, k2=res.k2,
                       step_deg=res.step_deg, total_deg=res.total_deg, ba_obs=res.ba_obs,
                       cam=ts.cam_idx, pt=ts.pt_idx, slot=ts.slot, uv_pix=ts.uv_pix,
                       n_tracks=ts.n_tracks, uv=chain.uv, kp_valid=chain.kp_valid,
                       matches={**res.matches, **chain.matches})
        return to_host(out)

    def work(self, out) -> dict:
        return {"rms_px": float(out["rms_px"]), "tracks": int(out["tracks"]),
                "kept": int(np.sum(out["kept"]))}

    def release(self):
        self.u = None

    # --- the check ---

    def _frontend(self, item, control):
        """Keypoints (uv [M, K, 2], valid [M, K]) and the matches {(p, i):
        (index, valid)} of the chain's and the ring's pairs of the pool
        item by the frozen twins of the frontend and the matcher (one
        precision down under ``control``)."""
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
        from portbench.reference import turntable as ref
        from portbench.reference.sfm import config as refcfg

        item = self._item(r)
        uv, valid, matches = self._frontend(item, control)
        u0 = self._uniforms(r)[0]
        cfg = pipeline_config(refcfg, self.config, self.traffic)
        R01, t01 = ref.start_poses(uv, valid, matches, self.K, cfg,
                                   lambda mask: draws.minimal_sets(u0, mask.to(u0.device)).cpu(),
                                   control=control)
        tt = self._settings()
        ring = ref.run(uv, valid, matches, R01, t01, self.K, gaps=tt["gaps"], wrap=tt["wrap"],
                       ba_iters=tt["ba_iters"], snap_rounds=tt["snap_rounds"],
                       axis_hint=tt["axis_hint"], min_track_len=tt["min_track_len"],
                       control=control, device=self.dev)
        ts = ring.tracks
        return {"item": item, "R": ring.R, "t": ring.t, "X": ring.X, "f": ring.f,
                "k1": ring.k1, "k2": ring.k2, "step_deg": ring.step_deg,
                "total_deg": ring.total_deg, "rms_px": ring.rms_px, "kept": ring.keep,
                "ba_obs": ring.ba_obs, "cam": ts.cam, "pt": ts.pt, "slot": ts.slot,
                "uv_pix": ts.uv, "n_tracks": ts.n, "uv": uv, "kp_valid": valid,
                "matches": matches}

    def compare(self, got, ref) -> dict:
        """corr_miss: over every pair the chain and the ring match, the
        largest of the pair cell's measure (the larger share of either
        side's valid correspondences with no partner within 0.01 px in
        both frames), 1 where a side lacks the pair;
        track_gap: the ring tracks' links (two kept observations, frame
        and slot, of one track) that one side has and the other lacks,
        over both sides' links;
        f_gap: the relative gap of the focal lengths;
        step_gap_deg: the worst over the ring's steps, the wrap included,
        of the angle between the two sides' relative rotations R_i
        R_{i-1}^T;
        rot_gap_deg: the worst frame's angle after the judged rotations
        are turned by the one world rotation that best maps them onto
        the reference's (the rotation nearest the chordal mean of R_ref_i^T
        R_got_i);
        ba_descent: the relative cost drop that 5 float64 LM steps make
        from the judged final R, t, X in a canonical gauge over the
        observations of the judged run's last BA, undistorted at its f
        and k1 (``reference/turntable.ba_descent``): whether it ended at
        the float64 optimum of its own problem;
        frame_descent: at the same state, the largest cost that one
        camera's own Gauss-Newton step (its points held) would take off,
        over the mean frame's cost: a fault of one frame, which
        ``ba_descent`` spreads over the ring's 36;
        No pose number sees a similarity transform of the judged ring.
        Printed, not judged: the gaps before the rotation is removed, the
        centre gap after the least-squares similarity, and ``ring_bar``,
        the judged ring against the rendered one by the configuration's
        ``bar`` (r5's: the mean step, the steps' spread, the whole turn,
        the rms in px), the worst as a fraction of its bound, which
        cannot tell the port from the control (PERF.md §2).
        A run compares each number's worst over the judged requests."""
        from portbench.reference import turntable as ref_mod

        miss = 0.0
        for p, i in self.pairs:
            if (p, i) not in got["matches"] or (p, i) not in ref["matches"]:
                miss = 1.0
                continue

            def corr(o):
                index, ok = o["matches"][(p, i)]
                ok = np.asarray(ok, bool) & o["kp_valid"][p] & o["kp_valid"][i][index]
                return np.concatenate([o["uv"][p][ok], o["uv"][i][index][ok]], 1)

            cg, cr = corr(got), corr(ref)
            tol = [0.01] * 4
            miss = max(miss, cmp.unpaired_share(cmp.pair_rows(cg, cr, tol, self.dev),
                                                cmp.pair_rows(cr, cg, tol, self.dev)))
        slots = np.asarray(got["kp_valid"]).shape[1]
        lg = ring_links(got["cam"], got["slot"], got["pt"], got["kept"], slots, self.frames)
        lr = ring_links(ref["cam"], ref["slot"], ref["pt"], ref["kept"], slots, self.frames)
        union = len(np.union1d(lg, lr))
        tracks = 1.0 - len(np.intersect1d(lg, lr)) / union if union else math.inf
        f_gap = abs(float(got["f"]) - float(ref["f"])) / abs(float(ref["f"]))
        Rg, Rr = np.asarray(got["R"], np.float64), np.asarray(ref["R"], np.float64)
        steps = ref_mod.step_gaps(Rg, Rr)
        after, before, _ = ref_mod.aligned_rotation_gaps(Rg, Rr)
        centre = ref_mod.centre_gaps(Rg, got["t"], Rr, ref["t"])
        got_tracks = ref_mod.Tracks(np.asarray(got["cam"], np.int64),
                                    np.asarray(got["slot"], np.int64),
                                    np.asarray(got["pt"], np.int64),
                                    np.asarray(got["uv_pix"], np.float64), int(got["n_tracks"]))
        delta = ref_mod.SNAP_SCHEDULE[-1][0] / (0.5 * float(self.K[0, 0] + self.K[1, 1]))
        descent, frame = ref_mod.ba_descent(got["R"], got["t"], got["X"], got_tracks,
                                            got["ba_obs"], float(got["f"]), float(got["k1"]),
                                            float(got["k2"]), self.K, delta)
        bar = self.ring["bar"]
        sd = np.asarray(got["step_deg"], np.float64)
        step = 360.0 / self.frames
        ring_bar = max(abs(sd.mean() - step) / bar["step_mean"], sd.std() / bar["step_std"],
                       abs(float(got["total_deg"]) - 360.0) / bar["total_deg"],
                       float(got["rms_px"]) / bar["rms_px"])
        own, own_frame = ref_mod.ba_descent(ref["R"], ref["t"], ref["X"], ref_mod.Tracks(
            ref["cam"], ref["slot"], ref["pt"], ref["uv_pix"], ref["n_tracks"]), ref["ba_obs"],
            ref["f"], ref["k1"], ref["k2"], self.K, delta)
        print(f"ring {got['item']}: worst frame's rotation gap deg before the gauge is "
              f"removed {before.max()!r}, after {after.max()!r}; centre gap {centre.max()!r}; "
              f"f {float(got['f'])!r} / {float(ref['f'])!r}, k1 {float(got['k1'])!r} / "
              f"{float(ref['k1'])!r}; ba_descent {descent!r}, frame_descent {frame!r} (the "
              f"reference's own {own!r}, {own_frame!r})", file=sys.stderr)
        R_gt, t_gt = self.truth[got["item"]]
        truth, _, _ = ref_mod.aligned_rotation_gaps(Rg, R_gt)
        print(f"ring {got['item']}: against the rendered ring: rotation error deg max "
              f"{truth.max()!r}, step {sd.mean()!r} +- {sd.std()!r}, total "
              f"{float(got['total_deg'])!r}, {float(got['rms_px'])!r} px; ring_bar "
              f"{ring_bar!r}", file=sys.stderr)
        nan = float("nan")
        return {
            "corr_miss": miss,
            "track_gap": tracks,
            "f_gap": f_gap,
            "step_gap_deg": float(steps.max()),
            "rot_gap_deg": float(after.max()),
            "ba_descent": descent if math.isfinite(descent) else nan,
            "frame_descent": frame if math.isfinite(frame) else nan,
        }


def ring_links(cam, slot, pt, kept, slots, frames) -> np.ndarray:
    """The sorted links of a ring's tracks: a * n + b for every two kept
    observations a < b (frame * slots + slot, n = frames * slots of
    them) of one track."""
    cam, slot, pt = (np.asarray(a, np.int64) for a in (cam, slot, pt))
    kept = np.asarray(kept, bool)
    obs = (cam * slots + slot)[kept]
    pid = pt[kept]
    n = frames * slots
    order = np.lexsort((obs, pid))
    obs, pid = obs[order], pid[order]
    cut = np.flatnonzero(np.diff(pid)) + 1
    links = [np.zeros(0, np.int64)]
    for track in np.split(obs, cut):
        a, b = np.triu_indices(len(track), 1)
        links.append(track[a] * n + track[b])
    return np.unique(np.concatenate(links))
