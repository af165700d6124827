"""Frozen copy of the port's plain K4, K5, K8 and K9 (``sfm_tpu_torch/ops/
sample.py``): orientation histograms and descriptors sampled from the
octave atlas, in plain PyTorch (the gather forms of ``sift/orient.py``
and ``sift/describe.py``).
"""

from __future__ import annotations

import torch

from portbench.reference.sfm.ops.image import ORI_P, patch_origin
from portbench.reference.sfm.sift import describe, orient


def _live(K, count, device):
    """[K] bool: slot index < count (a device scalar; never synced)."""
    if count is None:
        return torch.ones(K, dtype=torch.bool, device=device)
    return torch.arange(K, device=device) < torch.as_tensor(count, device=device)


def fused_orient_descriptor_plain(atlas, x, y, scale, count=None):
    """Plain PyTorch K4 (and K9): (d1 [K, 128] raw, ori1 [K], ori2 [K],
    dup [K])."""
    H, W = atlas.shape
    x0, y0a, fx, fy = patch_origin(x, y, H, W)
    h = orient.patch_histograms(atlas, x0, y0a, fx, fy, scale)
    live = _live(x.shape[0], count, atlas.device)
    ori1, ori2, dup = orient.orientations_from_histograms(h, live)
    d1 = describe.raw_descriptors(atlas, x0, y0a, fx, fy, scale, ori1)
    zero = torch.zeros_like(ori1)
    return (torch.where(live[:, None], d1, torch.zeros_like(d1)),
            torch.where(live, ori1, zero), torch.where(live, ori2, zero), dup)


def descriptor_sample_plain(atlas, x, y, scale, ori, count=None):
    """Plain PyTorch K5: raw [K, 128] descriptors, zero rows >= count."""
    H, W = atlas.shape
    x0, y0a, fx, fy = patch_origin(x, y, H, W)
    d = describe.raw_descriptors(atlas, x0, y0a, fx, fy, scale, ori)
    live = _live(x.shape[0], count, atlas.device)
    return torch.where(live[:, None], d, torch.zeros_like(d))


def orientation_histogram_sample_plain(img, x, y, scale, count=None):
    """Plain PyTorch K8: raw [K, 32] histograms, zero rows >= count."""
    H, W = img.shape
    x0, y0a, fx, fy = patch_origin(x, y, H, W, ORI_P)
    h = orient.patch_histograms(img, x0, y0a, fx, fy, scale, ORI_P)
    live = _live(x.shape[0], count, img.device)
    return torch.where(live[:, None], h, torch.zeros_like(h))


# The plain versions stand in for the kernels.
fused_orient_descriptor = fused_orient_descriptor_plain
fused_orient_descriptor_win = fused_orient_descriptor_plain
descriptor_sample = descriptor_sample_plain
orientation_histogram_sample = orientation_histogram_sample_plain
