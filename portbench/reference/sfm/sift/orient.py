"""Orientation assignment with dual-peak keypoint duplication
(counterpart of ``sfm_tpu/sift/orient.py``).

``orientation_histograms`` is the JAX package's gather-path function,
computed by K8 (``ops.sample.orientation_histogram_sample``) on the card
and by K8's plain version on the CPU; the two-stage sampling route
(``SiftConfig.use_pallas=False``) runs it.
``assign_orientations`` takes the JAX package's Pallas route on every
device: valid keypoints are compacted first, K8
(``ops.sample.orientation_histogram_sample``; its plain version for CPU
tensors) samples their raw histograms, the rows go back to their slots
by the inverse permutation, and ``orientations_from_histograms`` finds
the peaks.  ``patch_histograms`` is the gather form of the histogram
that the plain versions of K4 and K8 share.

Semantics follow the TPU sampling kernels: gradient samples at integer
offsets -5..5 around the keypoint, Gaussian weight sigma = 1.5 *
scale, bin = floor(16 * atan2 / pi + 16.5) mod 32, circular
[1, 4, 6, 4, 1] smoothing, peaks where v > left and v >= right, the two
largest peaks (ties to the lowest bin) with parabolic sub-bin
interpolation, and a duplicate when m2 > 0.8 * m1.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.sfm.ops.compact import compaction_order
from portbench.reference.sfm.ops.image import DESC_P, patch_sample

_N_BINS = 32


def patch_histograms(img, x0, y0a, fx, fy, scale, P: int = DESC_P):
    """[K, 32] raw histograms around patch-relative keypoints
    (``ops.image.patch_origin`` with the same ``P``)."""
    dev = img.device
    s = torch.arange(121, device=dev)
    xd = (s % 11).to(torch.float32) - 5.0
    yd = torch.div(s, 11, rounding_mode="floor").to(torch.float32) - 5.0
    bxo = fx[:, None] + xd
    byo = fy[:, None] + yd
    dx = (patch_sample(img, x0, y0a, bxo + 1.0, byo, P)
          - patch_sample(img, x0, y0a, bxo + (-1.0), byo, P))
    dy = (patch_sample(img, x0, y0a, bxo, byo + 1.0, P)
          - patch_sample(img, x0, y0a, bxo, byo + (-1.0), P))
    grad = torch.sqrt(dx * dx + dy * dy)
    s15 = 1.5 * scale
    inv2s2 = -1.0 / (2.0 * (s15 * s15))
    w = torch.exp(inv2s2[:, None] * (xd * xd + yd * yd))
    bins = torch.floor((16.0 / math.pi) * torch.atan2(dy, dx) + 16.5)
    bins = torch.where(bins > 31.0, torch.zeros_like(bins), bins)
    onehot = (bins[..., None] == torch.arange(_N_BINS, device=dev)).to(torch.float32)
    return torch.einsum("ks,ksb->kb", grad * w, onehot)


def orientation_histograms(img, x, y, scale):
    """[K, 32] raw gradient orientation histograms around keypoints at
    (x, y, scale) on ``img`` (an octave base or the atlas): K8 for a
    CUDA tensor, its plain version for a CPU one."""
    from portbench.reference.sfm.ops.sample import orientation_histogram_sample

    return orientation_histogram_sample(img, x, y, scale)


def smooth_histogram(h):
    """Circular [1, 4, 6, 4, 1] smoothing."""
    return (6.0 * h + 4.0 * (torch.roll(h, 1, -1) + torch.roll(h, -1, -1))
            + torch.roll(h, 2, -1) + torch.roll(h, -2, -1))


def _peak_angle(hs, idx):
    """Parabolic sub-bin peak [K, 1] -> degrees."""
    v0 = torch.gather(hs, 1, idx)
    vp = torch.gather(hs, 1, (idx + 1) % _N_BINS)
    vm = torch.gather(hs, 1, (idx + _N_BINS - 1) % _N_BINS)
    denom = 2.0 * v0 - vp - vm
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    peak = idx.to(torch.float32) + 0.5 * (vp - vm) / denom
    peak = torch.where(peak < 0.0, peak + 32.0, peak)
    return 11.25 * peak


def orientations_from_histograms(h, valid, *, duplicates=True):
    """Peak finding on [K, 32] raw histograms -> (ori1 [K], ori2 [K],
    valid2 [K]): valid2 marks the valid keypoints whose second peak
    exceeds 0.8 x the first (always False without ``duplicates``)."""
    hs = smooth_histogram(h)
    is_peak = (hs > torch.roll(hs, 1, -1)) & (hs >= torch.roll(hs, -1, -1))
    pv = torch.where(is_peak, hs, torch.zeros_like(hs))
    iota = torch.arange(_N_BINS, device=h.device)
    m1 = pv.max(dim=1, keepdim=True).values
    i1 = torch.where(pv == m1, iota, _N_BINS).min(dim=1, keepdim=True).values
    pv2 = torch.where(iota == i1, torch.zeros_like(pv), pv)
    m2 = pv2.max(dim=1, keepdim=True).values
    i2 = torch.where(pv2 == m2, iota, _N_BINS).min(dim=1, keepdim=True).values
    zero = torch.zeros_like(m1)
    ori1 = torch.where(m1 > 0, _peak_angle(hs, i1), zero)[:, 0]
    ori2 = torch.where(m2 > 0, _peak_angle(hs, i2), zero)[:, 0]
    valid2 = valid & ((m2 > 0.8 * m1) & (m2 > 0))[:, 0]
    if not duplicates:
        valid2 = torch.zeros_like(valid2)
    return ori1, ori2, valid2


def assign_orientations(img, x, y, scale, valid, *, duplicates=True,
                        use_pallas=False):
    """Returns (orientation1 [K], orientation2 [K], valid2 [K]) for
    keypoints at (x, y, scale) on ``img`` (an octave base or the atlas).

    ``use_pallas`` is accepted for the JAX package's signature; the port
    always samples through K8 and the result does not depend on it."""
    from portbench.reference.sfm.ops.sample import orientation_histogram_sample

    order = compaction_order(valid)
    h_c = orientation_histogram_sample(img, x[order], y[order], scale[order],
                                       count=valid.sum().to(torch.int32))
    h = torch.empty_like(h_c)
    h[order] = h_c
    return orientations_from_histograms(h, valid, duplicates=duplicates)
