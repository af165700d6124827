"""SIFT frontend (counterpart of ``sfm_tpu/sift/frontend.py``): the base
chain ([K7,] K1 + K2 in one launch), per-octave detection and selection,
the octave atlas, then orientation and descriptor sampling.

Two routes for each of the two stages, picked by the configuration as
the JAX package picks them (``config.py``): ``None`` or ``True`` keeps
the fused route, an explicit ``False`` selects the XLA route, each knob
on its own.

- Detection, ``fused_detect``: K3's maps of all octaves (one launch per
  8 octaves; octave o gated at ``lowest_scale / 2**o``, ``detect_lean``
  picks K3's mode) and the per-octave selection; or with ``False`` the
  dense DoG detector, octave by octave on the chain's bases
  (``pyramid.build_octave``, ``detect.detect``), each DoG volume freed
  before the next is built.
- Sampling, ``use_pallas``: the fused kernel K4 (or K9 with
  ``sample_window`` True, "hbm" or "vmem", K4's function bit for bit;
  None, False and "blk", the JAX package's paged-atlas form, run K4) on
  every slot, then the second-peak duplicates compacted and sampled by
  K5 into a fixed second half (slot i + K); or with ``False`` two
  stages: K8's histograms and ``orient.orientations_from_histograms``,
  then primaries and duplicates compacted together (valid first,
  stable) and K5 on every slot.

Octave bases are packed into one atlas with 48-row edge-replicated
guards; detections are capped to the ``sample_cap`` globally strongest
slots (over more than 16,384 slots: a rank-major interleave of the
octaves).  With ``up_scale`` the image is upsampled 2x before the
prefilter and keypoints are halved back to input pixels at the end.
The JAX package's TPU dispatch knobs ``pyramid_pallas``,
``blur_matmul``, ``dup_split``, ``sample_block_k`` and ``topk_block``
compute the same function either way and are ignored.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from sfm_tpu_torch.config import SiftConfig
from sfm_tpu_torch.ops.compact import compaction_order, stable_topk_indices
from sfm_tpu_torch.ops.detect import detect_maps_octaves
from sfm_tpu_torch.ops.sample import (descriptor_sample, fused_orient_descriptor,
                                     fused_orient_descriptor_win,
                                     orientation_histogram_sample)
from sfm_tpu_torch.sift import describe, detect as detect_mod, orient, pyramid
from sfm_tpu_torch.utils import timing

_GUARD = 48  # vertical guard rows between octaves (>= descriptor patch)
# sample_window -> the fused sampling kernel, the same function either
# way: K9 runs K4's warp on each keypoint's support box, copied to
# shared memory by cp.async (the next slot's copy overlapping this one's
# sampling), K4 gathers from the atlas.
_SAMPLE_WINDOWS = {None: fused_orient_descriptor, False: fused_orient_descriptor,
                   "blk": fused_orient_descriptor,
                   True: fused_orient_descriptor_win,
                   "hbm": fused_orient_descriptor_win,
                   "vmem": fused_orient_descriptor_win}


class Keypoints(NamedTuple):
    """SoA keypoint set; coordinates in input-image pixels."""

    x: torch.Tensor            # [K]
    y: torch.Tensor            # [K]
    scale: torch.Tensor        # [K]
    sharpness: torch.Tensor    # [K]
    edgeness: torch.Tensor     # [K]
    orientation: torch.Tensor  # [K] degrees
    octave: torch.Tensor       # [K] int
    valid: torch.Tensor        # [K] bool


class SiftResult(NamedTuple):
    keypoints: Keypoints
    descriptors: torch.Tensor  # [K, 128]


def check_supported(cfg: SiftConfig):
    """Raise for configuration knobs this port does not implement."""
    detect_mod.check_select(cfg)
    if cfg.sample_window not in _SAMPLE_WINDOWS:
        raise ValueError(f"sample_window={cfg.sample_window!r}: expected one of "
                         f"{sorted(map(repr, _SAMPLE_WINDOWS))}")
    if cfg.sample_phases != 5:
        raise NotImplementedError("sample_phases != 5 is a TPU profiling mode")
    if cfg.octave_caps is not None and len(cfg.octave_caps) != cfg.num_octaves:
        raise ValueError(
            f"octave_caps must have num_octaves={cfg.num_octaves} entries")


def atlas_layout(shape, cfg: SiftConfig):
    """Static atlas layout for an input of ``shape``: (offsets, subs).
    Octave o is ``H // 2**o`` rows high (``pyramid.base_chain``)."""
    H, W = shape
    if cfg.up_scale:
        H, W = 2 * H, 2 * W
    offsets, subs = [], []
    y = 0
    sub = 1.0
    for _ in range(cfg.num_octaves):
        offsets.append(y + _GUARD)
        subs.append(sub)
        y += H + 2 * _GUARD
        H, W = H // 2, W // 2
        sub *= 2.0
    return tuple(offsets), tuple(subs)


def build_atlas(bases):
    """Pack octave bases vertically with edge-replicated guard rows and
    right-edge column padding: [sum(H_o + 96), W_0]."""
    W0 = bases[0].shape[1]
    rows = [F.pad(b[None, None], (0, W0 - b.shape[1], _GUARD, _GUARD),
                  mode="replicate")[0, 0] for b in bases]
    return torch.cat(rows, dim=0)


def _octave_cfg(cfg: SiftConfig, o: int) -> SiftConfig:
    if cfg.octave_caps is None:
        return cfg
    import dataclasses

    return dataclasses.replace(cfg, max_pts_per_octave=int(cfg.octave_caps[o]))


@functools.lru_cache(maxsize=16)
def _tap_banks(cfg: SiftConfig) -> np.ndarray:
    """Every octave's K3 taps (``pyramid.octave_kernel_bank``) as one
    read-only [octaves, planes, 9] array, built on the host once per
    configuration (~0.45 ms of numpy per image otherwise)."""
    banks = np.stack([pyramid.octave_kernel_bank(cfg, o)
                      for o in range(cfg.num_octaves)]).astype(np.float32)
    banks.flags.writeable = False
    return banks


def detect_stage(img, cfg: SiftConfig):
    """Base chain, detection of every octave and the atlas: K3's maps
    (one launch per 8 octaves; octave o gated at ``lowest_scale /
    2**o``) and the per-octave selection, or with ``fused_detect=False``
    the dense DoG detector octave by octave.  Returns (atlas, detections
    with y in atlas rows)."""
    with timing.span("sift.chain"):
        bases = pyramid.base_chain(img, cfg)
    offsets, subs = atlas_layout(img.shape, cfg)
    if cfg.fused_detect is False:
        dets = []
        for o, (base, sub) in enumerate(zip(bases, subs)):
            with timing.span("sift.detect"):
                dog = pyramid.build_octave(base, cfg, o, sub).dog
                dets.append(detect_mod.detect(dog, _octave_cfg(cfg, o), sub))
            del dog   # the volume goes before the next octave's is built
    else:
        with timing.span("sift.detect"):
            maps = detect_maps_octaves(bases, _tap_banks(cfg), float(cfg.thresh),
                                       float(cfg.edge_limit),
                                       [float(cfg.lowest_scale / s) for s in subs],
                                       cfg.detect_lean)
        with timing.span("sift.select"):
            dets = [detect_mod.select_from_maps(resp, aux, _octave_cfg(cfg, o))
                    for o, (resp, aux) in enumerate(maps)]
    with timing.span("sift.atlas"):
        dets = [d._replace(y=d.y + off) for d, off in zip(dets, offsets)]
        return build_atlas(bases), dets


@functools.lru_cache(maxsize=16)
def rank_major_order(seg: tuple, device=None) -> torch.Tensor:
    """Slot permutation taking rank r of every octave that has one, in
    octave order, before rank r + 1 of any; ``seg``: the octaves' slot
    counts.  For equal counts this is the JAX package's ``(j % n_oct) *
    per + j // n_oct`` (``sfm_tpu/sift/frontend.py:326-330``); with
    unequal ``octave_caps`` it follows the true segment bounds, where
    the JAX formula is not a permutation."""
    rank = np.concatenate([np.arange(n) for n in seg])
    octave = np.repeat(np.arange(len(seg)), seg)
    return torch.as_tensor(np.lexsort((octave, rank)), device=device)


def _sample_order(valid, sharp, cap: int, seg=None):
    """Slot order for the sampling kernels: valid slots first, capped to
    the ``cap`` globally strongest detections (ties to the lowest slot).
    Over more than 16,384 slots, the JAX package's cheaper order: each
    octave's slots are strongest first (top-k), so a rank-major
    interleave of the octaves (``seg``: their slot counts) and a stable
    valid-first compaction; if the cap binds, it keeps each octave's
    strongest prefix."""
    K_slots = valid.shape[0]
    if not cap or cap >= K_slots:
        return compaction_order(valid)
    if K_slots <= 16384:
        strength = torch.where(valid, sharp.abs(), torch.full_like(sharp, -1.0))
        return stable_topk_indices(strength, cap)
    if seg is None or sum(seg) != K_slots:
        raise ValueError(f"{K_slots} slots need their per-octave counts, got {seg}")
    perm = rank_major_order(tuple(seg), valid.device)
    return perm[compaction_order(valid[perm])[:cap]]


def _fused_sampling(atlas, x, y, sc, valid, cfg: SiftConfig):
    """K4 (or K9) on every slot, then the duplicates compacted and
    sampled by K5 into the second half: (raw descriptors [2K, 128],
    orientations [2K], validity [2K]) in slot order i, then i + K."""
    count = valid.sum().to(torch.int32)
    fused = _SAMPLE_WINDOWS[cfg.sample_window]
    d1, ori1, ori2, dup = fused(atlas, x, y, sc, count=count)
    valid2 = dup & valid
    d2 = torch.zeros_like(d1)
    if cfg.orientation_duplicates:
        order_d = compaction_order(valid2)
        d2[order_d] = descriptor_sample(
            atlas, x[order_d], y[order_d], sc[order_d], ori2[order_d],
            count=valid2.sum().to(torch.int32))
    else:
        valid2 = torch.zeros_like(valid2)
    return (torch.cat([d1, d2]), torch.cat([ori1, ori2]),
            torch.cat([valid, valid2]))


def _two_stage_sampling(atlas, x, y, sc, valid, cfg: SiftConfig):
    """K8's histograms of the valid-first slots and their peaks, then
    primaries and second-peak duplicates compacted together (valid
    first, stable) and K5 on every slot: (raw descriptors [2K, 128],
    orientations [2K], validity [2K], the second compaction's order
    over the doubled slots)."""
    h = orientation_histogram_sample(atlas, x, y, sc, count=valid.sum().to(torch.int32))
    ori1, ori2, valid2 = orient.orientations_from_histograms(
        h, valid, duplicates=cfg.orientation_duplicates)
    valid_2 = torch.cat([valid, valid2 & valid])
    order2 = compaction_order(valid_2)
    ori_2 = torch.cat([ori1, ori2])[order2]
    valid_2 = valid_2[order2]
    raw = descriptor_sample(atlas, *(torch.cat([a, a])[order2] for a in (x, y, sc)),
                            ori_2, count=valid_2.sum().to(torch.int32))
    return raw, ori_2, valid_2, order2


def sample_stage(atlas, offsets, subs, dets, cfg: SiftConfig) -> SiftResult:
    """Orientation and descriptors of every detection slot: fused (K4 or
    K9, K5) or, with ``use_pallas=False``, two-stage (K8, K5)."""
    dev = atlas.device
    n = [d.x.shape[0] for d in dets]
    with timing.span("sift.sample"):
        fields = {f: torch.cat([getattr(d, f) for d in dets])
                  for f in ("x", "y", "scale", "sharpness", "edgeness", "valid")}
        fields["octave"] = torch.cat([torch.full((k,), i, dtype=torch.int64, device=dev)
                                      for i, k in enumerate(n)])
        fields["sub"] = torch.cat([torch.full((k,), s, dtype=torch.float32, device=dev)
                                   for k, s in zip(n, subs)])
        fields["off"] = torch.cat([torch.full((k,), float(o), dtype=torch.float32,
                                              device=dev) for k, o in zip(n, offsets)])
        order = _sample_order(fields["valid"], fields["sharpness"], cfg.sample_cap, n)
        f = {k: v[order] for k, v in fields.items()}
        if cfg.use_pallas is False:
            raw, ori, valid, order2 = _two_stage_sampling(
                atlas, f["x"], f["y"], f["scale"], f["valid"], cfg)
            f = {k: torch.cat([v, v])[order2] for k, v in f.items()}
        else:   # slot i and its duplicate slot i + K
            raw, ori, valid = _fused_sampling(atlas, f["x"], f["y"], f["scale"],
                                              f["valid"], cfg)
            f = {k: torch.cat([v, v]) for k, v in f.items()}
    with timing.span("sift.describe"):
        desc = describe.normalize_descriptors(raw) * valid[:, None]
        sub = f["sub"]
        kp = Keypoints(
            x=f["x"] * sub,
            y=(f["y"] - f["off"]) * sub,
            scale=f["scale"] * sub,
            sharpness=f["sharpness"],
            edgeness=f["edgeness"],
            orientation=ori,
            octave=f["octave"],
            valid=valid,
        )
        if cfg.up_scale:
            # Back to input-image pixels (reference RescalePositions(0.5)).
            kp = kp._replace(x=kp.x * 0.5, y=kp.y * 0.5, scale=kp.scale * 0.5)
        return SiftResult(keypoints=kp, descriptors=desc)


def extract_sift(img, cfg: SiftConfig = SiftConfig()) -> SiftResult:
    """SIFT on an [H, W] f32 image (0..255) on its own device.

    Capacity: 2 * min(sample_cap, total detection slots) keypoints with
    validity masks, descriptors L2-normalized.
    """
    with timing.span("sift.extract"):
        check_supported(cfg)
        offsets, subs = atlas_layout(tuple(img.shape), cfg)
        atlas, dets = detect_stage(img, cfg)
        return sample_stage(atlas, offsets, subs, dets, cfg)
