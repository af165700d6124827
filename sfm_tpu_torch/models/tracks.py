"""Model-free multi-frame track building from pairwise matches
(counterpart of ``sfm_tpu/models/tracks.py``).

Tracks come from descriptor matches only: ratio-test matching (K6,
through ``sift/match.match``) of chosen frame pairs on the features'
device, then union-find with frame-conflict rejection on the host, so
the global refinement downstream (``models/turntable.py``) sees an
observation graph that no chain geometry has filtered.

The union-find is host bookkeeping in numpy, as in the JAX package:
each pair's matches come to the host once (index and validity), and
pairs, matches, nodes and groups are visited in the JAX package's
order, so "first link wins" and the track numbering, and with them
``cam_idx`` / ``pt_idx``, come out equal to its.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from sfm_tpu_torch.sift import match as match_mod


class TrackSet(NamedTuple):
    cam_idx: torch.Tensor   # [O] int64 frame per observation
    pt_idx: torch.Tensor    # [O] int64 track per observation
    uv_pix: torch.Tensor    # [O, 2] pixel coords
    mask: torch.Tensor      # [O] bool
    n_tracks: int
    slot: torch.Tensor      # [O] int64 keypoint slot in its frame


def ring_pairs(n: int, gaps: Sequence[int] = (1,), wrap: bool = True):
    """(i, j) frame pairs at the given gaps; with ``wrap``, pairs wrap
    around the ring (loop-closure edges for turntable sequences)."""
    pairs = []
    for g in gaps:
        last = n if wrap else n - g
        for i in range(last):
            pairs.append((i, (i + g) % n))
    return pairs


def build_tracks(feats, pairs, cfg, *, min_disparity_px: float = 1.5,
                 min_len: int = 2, matches: dict | None = None) -> TrackSet:
    """Union-find track building over the given frame pairs.

    A union that would put two observations of the SAME frame into one
    track is rejected (first link wins), the standard conflict rule.
    The TrackSet lies on the features' device.  ``matches`` (a dict),
    where given, receives each pair's matches as the union-find read
    them: (i, j) -> (index [K], valid [K]), numpy on the host.
    """
    parent: dict = {}
    frames: dict = {}   # root -> set of frames in its component

    def find(a):
        while parent.get(a, a) != a:
            parent[a] = parent.get(parent[a], parent[a])
            a = parent[a]
        return a

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra == rb:
            return
        fa = frames.setdefault(ra, {ra[0]})
        fb = frames.setdefault(rb, {rb[0]})
        if fa & fb:
            return  # frame conflict: keep both tracks separate
        if len(fa) < len(fb):
            ra, rb, fa, fb = rb, ra, fb, fa
        parent[rb] = ra
        fa |= fb
        frames[ra] = fa
        frames.pop(rb, None)

    dev = feats[0].descriptors.device
    uv = [torch.stack([f.keypoints.x, f.keypoints.y], 1).cpu().numpy() for f in feats]
    valid = [f.keypoints.valid.cpu().numpy() for f in feats]
    for (i, j) in pairs:
        m = match_mod.match(feats[i].descriptors, feats[j].descriptors,
                            feats[i].keypoints.valid, feats[j].keypoints.valid,
                            cfg.match)
        mi, mv = torch.stack([m.index, m.valid.to(m.index.dtype)]).cpu().numpy()
        if matches is not None:
            matches[(i, j)] = (mi, mv.astype(bool))
        ok = mv.astype(bool) & valid[i] & valid[j][mi]
        disp = np.sqrt(((uv[i] - uv[j][mi]) ** 2).sum(1))
        ok &= disp > min_disparity_px
        for a in np.nonzero(ok)[0]:
            na, nb = (i, int(a)), (j, int(mi[a]))
            parent.setdefault(na, na)
            parent.setdefault(nb, nb)
            union(na, nb)

    groups: dict = {}
    for node in parent:
        groups.setdefault(find(node), []).append(node)
    obs_cam, obs_pt, obs_uv, obs_slot = [], [], [], []
    pid = 0
    for members in groups.values():
        if len(members) < min_len:
            continue
        for (fr, slot) in members:
            obs_cam.append(fr)
            obs_pt.append(pid)
            obs_uv.append(uv[fr][slot])
            obs_slot.append(slot)
        pid += 1
    return TrackSet(
        cam_idx=torch.as_tensor(np.array(obs_cam, np.int64), device=dev),
        pt_idx=torch.as_tensor(np.array(obs_pt, np.int64), device=dev),
        uv_pix=torch.as_tensor(np.array(obs_uv, np.float32).reshape(-1, 2), device=dev),
        mask=torch.ones((len(obs_cam),), dtype=torch.bool, device=dev),
        n_tracks=pid,
        slot=torch.as_tensor(np.array(obs_slot, np.int64), device=dev),
    )


def normalize_trackset(ts: TrackSet, K) -> torch.Tensor:
    """Pixel observations -> [O, 2] normalized coordinates (on the
    TrackSet's device)."""
    K = np.asarray(torch.as_tensor(K).cpu(), np.float32)
    K_inv = np.linalg.inv(K)
    uv = ts.uv_pix.cpu().numpy()
    xh = np.concatenate([uv, np.ones((len(uv), 1), np.float32)], 1) @ K_inv.T
    return torch.as_tensor(xh[:, :2] / xh[:, 2:3], device=ts.uv_pix.device)
