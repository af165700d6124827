"""Entry ``two_view_pair``: one request is one two-view reconstruction,
``models/two_view.frontend_stage`` (SIFT on both images, the top-2
matcher, compaction to ``geometry_cap``) then ``two_view_geometry``
with the RANSAC minimal sets handed in: the composition of
``two_view_pipeline``.  The pool holds ``pool`` pairs of the
configuration's size, each a scene of the traffic's fixed
``scene_seed`` with sensor noise drawn from the run's seed
(``gen.scene``); the seed also orders the pool, and request r takes
its pair r mod pool and minimal sets drawn from its own seed.

The check makes the correspondences of the same pair with the frozen
plain twins of the frontend and the matcher (``reference/sfm``: plain
PyTorch, f32 with TF32 off, bf16 matcher products), maps the same
draws onto them, runs the geometry written apart from the port in
float64 NumPy (``reference/geometry.py``) and compares the
correspondences, the pose, the inliers and the points.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.gen import scene as gen
from portbench.harness import compare as cmp
from portbench.harness import draws
from portbench.harness.pipeline import pipeline_config, span, to_host

_FIELDS = ("R", "t", "inliers", "points", "point_valid", "num_inliers")


def _host_result(uv1, uv2, mask, res) -> dict:
    out = {"uv1": uv1, "uv2": uv2, "mask": mask}
    out.update({k: getattr(res, k) for k in _FIELDS})
    return to_host(out)


class Entry:
    units_per_request = 1
    span_names = ("frontend", "geometry")
    compared = ("corr_miss", "rot_gap_deg", "t_gap_deg", "inlier_flip", "point_gap")
    by_median = ("rot_gap_deg", "t_gap_deg")

    def __init__(self, config, traffic, seed, dev):
        from sfm_tpu_torch import config as cfgmod

        self.dev, self.seed = dev, seed
        self.config, self.traffic = config, traffic
        self.cfg = pipeline_config(cfgmod, config, traffic)
        self.n_hyps = self.cfg.ransac.n_hyps
        self.pool = []
        for i in range(traffic["pool"]):
            p = gen.synthetic_pair(
                config["height"], config["width"], device=dev,
                scene=gen.TorchDraws(draws.derive(traffic["scene_seed"], "scene", i), dev),
                noise=gen.TorchDraws(draws.derive(seed, "noise", i), dev))
            self.pool.append((p["img1"], p["img2"]))
        self.order = draws.order(seed, len(self.pool))
        self.K = torch.as_tensor(p["K"], device=dev)
        self.u = None
        self._ref_front = {}

    def _uniforms(self, r):
        return draws.uniforms(draws.derive(self.seed, "ransac", r), self.n_hyps, 8, self.dev)

    def _item(self, r) -> int:
        return self.order[r % len(self.order)] if isinstance(r, int) else self.order[0]

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
        from sfm_tpu_torch.models import two_view

        img1, img2 = self.pool[self._item(r)]
        with span(spans, "frontend"):
            uv1, uv2, mask = two_view.frontend_stage(img1, img2, self.cfg)
        sets = draws.minimal_sets(self.u, mask)
        with span(spans, "geometry"):
            res = two_view.two_view_geometry(uv1, uv2, mask, self.K, self.cfg,
                                             minimal_sets=sets)
        return _host_result(uv1, uv2, mask, res)

    def work(self, out) -> dict:
        return {"correspondences": int(out["mask"].sum()),
                "inliers": int(out["num_inliers"])}

    def release(self):
        self.u = None

    # --- the check ---

    def reference(self, r, control=False):
        from portbench.reference import geometry
        from portbench.reference.sfm import config as refcfg
        from portbench.reference.sfm.models import two_view as ref_two_view
        from portbench.reference.sfm.utils import precision

        cfg = pipeline_config(refcfg, self.config, self.traffic)
        i = self._item(r)
        if (i, control) not in self._ref_front:
            with precision.control() if control else contextlib.nullcontext():
                self._ref_front[(i, control)] = ref_two_view.frontend_stage(
                    *self.pool[i], cfg)
        uv1, uv2, mask = self._ref_front[(i, control)]
        sets = draws.minimal_sets(self._uniforms(r), mask)
        uv1, uv2, mask, sets, K = to_host((uv1, uv2, mask, sets, self.K))
        g = geometry.two_view_geometry(uv1, uv2, mask, K, sets, cfg, control=control)
        out = {"uv1": uv1, "uv2": uv2, "mask": mask, "K": K, "cfg": cfg}
        out.update({k: getattr(g, k) for k in _FIELDS})
        return out

    def compare(self, got, ref) -> dict:
        """corr_miss: the larger share of either side's valid
        correspondences with no partner within 0.01 px in both images;
        rot_gap_deg, t_gap_deg: the angle between the rotations and
        between the translation directions (a run compares their median
        over the judged requests: the pose the port keeps turns on counts
        that a row at a threshold tips in float32, which moves a few
        requests in a hundred by up to ~0.06 deg); at the judged pose, in
        float64 on
        the reference's correspondences paired with the judged ones:
        inlier_flip, the share of paired rows whose inlier flag differs,
        and point_gap, the median relative distance between the judged
        points and the DLT points, over rows valid in both."""
        from portbench.reference import geometry

        def corr(o):
            m = o["mask"]
            return np.concatenate([o["uv1"][m], o["uv2"][m]], 1), np.nonzero(m)[0]

        cg, ig = corr(got)
        cr, ir = corr(ref)
        tol = [0.01] * 4
        g2r = cmp.pair_rows(cg, cr, tol, self.dev)
        r2g = cmp.pair_rows(cr, cg, tol, self.dev)
        paired = g2r >= 0
        sg, sr = ig[paired], ir[g2r[paired]]
        inl, X, valid = geometry.judge_at_pose(ref["uv1"], ref["uv2"], ref["mask"], ref["K"],
                                               got["R"], got["t"], ref["cfg"])
        both = got["point_valid"][sg] & valid[sr]
        Xg = got["points"][sg][both].astype(np.float64)
        Xr = X[sr][both]
        rel = np.linalg.norm(Xg - Xr, axis=1) / np.maximum(np.linalg.norm(Xr, axis=1), 1e-12)
        return {
            "corr_miss": cmp.unpaired_share(g2r, r2g),
            "rot_gap_deg": cmp.rotation_gap_deg(got["R"], ref["R"]),
            "t_gap_deg": cmp.direction_gap_deg(got["t"], ref["t"]),
            "inlier_flip": float(np.mean(got["inliers"][sg] != inl[sr])) if len(sg) else 1.0,
            "point_gap": float(np.median(rel)) if len(rel) else float("inf"),
        }
