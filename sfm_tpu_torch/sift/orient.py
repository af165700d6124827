"""Orientation histograms and dual-peak assignment (counterpart of
``sfm_tpu/sift/orient.py``), in the gather form that serves as the plain
version of K4's orientation half.

Semantics follow the TPU sampling kernel the frontend runs: gradient
samples at integer offsets -5..5 around the keypoint, Gaussian weight
sigma = 1.5 * scale, bin = floor(16 * atan2 / pi + 16.5) mod 32,
circular [1, 4, 6, 4, 1] smoothing, peaks where v > left and
v >= right, the two largest peaks (ties to the lowest bin) with
parabolic sub-bin interpolation, and a duplicate when m2 > 0.8 * m1.
"""

from __future__ import annotations

import math

import torch

from sfm_tpu_torch.ops.image import patch_sample

_N_BINS = 32


def orientation_histograms(img, x0, y0a, fx, fy, scale):
    """[K, 32] histograms around patch-relative keypoints
    (``ops.image.patch_origin``)."""
    dev = img.device
    s = torch.arange(121, device=dev)
    xd = (s % 11).to(torch.float32) - 5.0
    yd = torch.div(s, 11, rounding_mode="floor").to(torch.float32) - 5.0
    bxo = fx[:, None] + xd
    byo = fy[:, None] + yd
    dx = (patch_sample(img, x0, y0a, bxo + 1.0, byo)
          - patch_sample(img, x0, y0a, bxo + (-1.0), byo))
    dy = (patch_sample(img, x0, y0a, bxo, byo + 1.0)
          - patch_sample(img, x0, y0a, bxo, byo + (-1.0)))
    grad = torch.sqrt(dx * dx + dy * dy)
    s15 = 1.5 * scale
    inv2s2 = -1.0 / (2.0 * (s15 * s15))
    w = torch.exp(inv2s2[:, None] * (xd * xd + yd * yd))
    bins = torch.floor((16.0 / math.pi) * torch.atan2(dy, dx) + 16.5)
    bins = torch.where(bins > 31.0, torch.zeros_like(bins), bins)
    onehot = (bins[..., None] == torch.arange(_N_BINS, device=dev)).to(torch.float32)
    return torch.einsum("ks,ksb->kb", grad * w, onehot)


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


def orientations_from_histograms(h):
    """Peaks of [K, 32] histograms -> (ori1 [K], ori2 [K], dup [K])."""
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
    dup = ((m2 > 0.8 * m1) & (m2 > 0))[:, 0]
    return ori1, ori2, dup
