"""Entry ``extract_match``: one request is SIFT on both images of a pair
(``sift/frontend.extract_sift``) and the top-2 match of their
descriptors with the ratio test (``sift/match.match``), no geometry.
The pool holds ``pool`` rotation pairs of the configuration's size
(``gen.scene.rotation_pair``), each a scene of the traffic's fixed
``scene_seed`` with sensor noise drawn from the run's seed, which also
orders the pool; request r takes its pair r mod pool.  The result on the host is each image's keypoints
(position, scale, orientation, validity) and the matches (index,
score, validity); the descriptors stay on the card.

The check runs the reference (``reference/sfm``: the port's plain
pyramid, detection, orientation, descriptor and matcher, frozen) on
the same pair and pairs the two sides' keypoints by position, scale
and orientation.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.gen import scene as gen
from portbench.harness import compare as cmp
from portbench.harness import draws
from portbench.harness.pipeline import pipeline_config, span, to_host

_KP = ("x", "y", "scale", "orientation", "valid")


def _result(s1, s2, m, keep) -> dict:
    out = to_host({"kp": [{k: getattr(s.keypoints, k) for k in _KP} for s in (s1, s2)],
                   "index": m.index, "score": m.score, "valid": m.valid})
    if keep:
        out["desc"] = (s1.descriptors, s2.descriptors)
    return out


class Entry:
    units_per_request = 1
    span_names = ("extract", "match")
    compared = ("kp_miss", "desc_gap", "match_flip")

    def __init__(self, config, traffic, seed, dev):
        from sfm_tpu_torch import config as cfgmod

        self.dev, self.seed = dev, seed
        self.config, self.traffic = config, traffic
        self.cfg = pipeline_config(cfgmod, config, traffic)
        self.pool = []
        for i in range(traffic["pool"]):
            p = gen.rotation_pair(
                config["height"], config["width"], device=dev,
                scene=gen.TorchDraws(draws.derive(traffic["scene_seed"], "scene", i), dev),
                noise=gen.TorchDraws(draws.derive(seed, "noise", i), dev))
            self.pool.append((p["img1"], p["img2"]))
        self.order = draws.order(seed, len(self.pool))
        self._ref = {}

    def _item(self, r) -> int:
        return self.order[r % len(self.order)] if isinstance(r, int) else self.order[0]

    def warm(self):
        if self.dev.type == "cuda":
            from sfm_tpu_torch.ops import _cuda

            _cuda.library()
        for w in range(self.traffic.get("warm_requests", 1)):
            self.request(w, None, keep=False)

    def prepare(self, r):
        pass

    def request(self, r, spans, keep):
        from sfm_tpu_torch.sift import frontend, match

        img1, img2 = self.pool[self._item(r)]
        with span(spans, "extract"):
            s1 = frontend.extract_sift(img1, self.cfg.sift)
        with span(spans, "extract"):
            s2 = frontend.extract_sift(img2, self.cfg.sift)
        with span(spans, "match"):
            m = match.match(s1.descriptors, s2.descriptors, s1.keypoints.valid,
                            s2.keypoints.valid, self.cfg.match)
        return _result(s1, s2, m, keep)

    def work(self, out) -> dict:
        return {"live": tuple(int(k["valid"].sum()) for k in out["kp"])}

    def release(self):
        pass

    # --- the check ---

    def reference(self, r, control=False):
        from portbench.reference.sfm import config as refcfg
        from portbench.reference.sfm.sift import frontend, match
        from portbench.reference.sfm.utils import precision

        i = self._item(r)
        if (i, control) not in self._ref:
            cfg = pipeline_config(refcfg, self.config, self.traffic)
            with precision.control() if control else contextlib.nullcontext():
                s1, s2 = (frontend.extract_sift(img, cfg.sift) for img in self.pool[i])
                m = match.match(s1.descriptors, s2.descriptors, s1.keypoints.valid,
                                s2.keypoints.valid, cfg.match)
            self._ref[(i, control)] = _result(s1, s2, m, keep=True)
        return self._ref[(i, control)]

    def compare(self, got, ref) -> dict:
        """kp_miss: the larger share of either side's valid keypoints
        (both images) with no partner within 0.01 px, 0.1% of the scale
        and 0.05 degrees; desc_gap: the largest L2 distance between
        paired keypoints' descriptors; match_flip: the share of paired
        image-1 keypoints matched by either side whose match validity or
        matched image-2 keypoint differs."""
        pairs, miss = [], 0.0
        for g, f in zip(got["kp"], ref["kp"]):
            def rows(k):
                v = np.nonzero(k["valid"])[0]
                ang = np.deg2rad(k["orientation"][v].astype(np.float64))
                return np.stack([k["x"][v], k["y"][v], k["scale"][v],
                                 np.cos(ang), np.sin(ang)], 1), v, k["scale"][v]

            a, ia, sa = rows(g)
            b, ib, _ = rows(f)
            tol = np.array([0.01, 0.01, 1e-3 * max(float(np.median(sa)), 1e-6) if len(sa) else 1e-3,
                            np.deg2rad(0.05), np.deg2rad(0.05)])
            g2r = cmp.pair_rows(a, b, tol, self.dev)
            r2g = cmp.pair_rows(b, a, tol, self.dev)
            miss = max(miss, cmp.unpaired_share(g2r, r2g))
            full = np.full(len(g["valid"]), -1, np.int64)
            full[ia[g2r >= 0]] = ib[g2r[g2r >= 0]]
            pairs.append(full)
        p1, p2 = pairs
        dg = 0.0
        for s in range(2):
            src = np.nonzero(pairs[s] >= 0)[0]
            if len(src):
                d = (got["desc"][s][torch.as_tensor(src, device=self.dev)]
                     - ref["desc"][s][torch.as_tensor(pairs[s][src], device=self.dev)])
                dg = max(dg, float(torch.linalg.vector_norm(d.double(), dim=1).max()))
        q = np.nonzero(p1 >= 0)[0]
        gv, rv = got["valid"][q], ref["valid"][p1[q]]
        g_to = np.where(gv, p2[got["index"][q]], -2)
        r_to = np.where(rv, ref["index"][p1[q]], -2)
        either = gv | rv
        flips = either & ((gv != rv) | (g_to != r_to))
        flip = float(flips.sum() / max(either.sum(), 1))
        return {"kp_miss": miss, "desc_gap": dg, "match_flip": flip}
