"""SIFT descriptors, 128-D = 4 x 4 cells x 8 orientations (counterpart
of ``sfm_tpu/sift/describe.py``).  ``extract_descriptors`` takes the JAX
package's Pallas route on every device (compact, K5, scatter back,
normalize); ``raw_descriptors`` is the gather form that serves as the
plain version of K4's descriptor half and of K5.

Semantics: a 16 x 16 sample grid rotated by the keypoint orientation
with spacing 12/16 * scale, rotated unit-step central differences,
Gaussian window exp(-(t - 7.5)^2 / 128) per axis, angle bins
4 * atan2 / pi + 4 interpolated across 8 bins, bilinear spatial cell
weights with the reference's edge truncation; then normalize, clamp at
0.2 and renormalize.  Layout: index = 8 * (4 * row_cell + col_cell) +
angle_bin.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.sfm.ops.compact import compaction_order
from portbench.reference.sfm.ops.image import patch_sample

_RAD = 2.0 * math.pi / 360.0


def _spatial_weight_matrix() -> np.ndarray:
    """[16, 4] per-axis bilinear cell weights with edge truncation."""
    W1 = np.zeros((16, 4), np.float32)
    for i in range(16):
        ci = (i + 2) // 4 - 1
        f = (i - 1.5) / 4.0 - ci
        if i >= 2 and 0 <= ci <= 3:
            W1[i, ci] = 1.0 - f
        if i <= 13 and 0 <= ci + 1 <= 3:
            W1[i, ci + 1] = f
    return W1


def _tables():
    """(w2d [256], wsp [256, 16]) float32: the Gaussian window of sample
    s = j*16+i, and its spatial weight W1[j, cy] * W1[i, cx] in cell
    cy*4+cx."""
    g = np.exp(-((np.arange(16) - 7.5) ** 2) / 128.0).astype(np.float32)
    w2d = (g[:, None] * g[None, :]).reshape(256).astype(np.float32)
    W1 = _spatial_weight_matrix()
    wsp = (W1[:, None, :, None] * W1[None, :, None, :]).reshape(256, 16)
    return w2d, wsp.astype(np.float32)


W2D, WSP = _tables()


def _support(wsp: np.ndarray):
    """The compact form of ``wsp`` that K4 and K5 walk: (offsets [17]
    int32, s [n] int32, w [n] float32), where entries offsets[c] ..
    offsets[c + 1] - 1 are cell c's nonzero weights (s, wsp[s, c]) in
    increasing s (n = 784: 36 to 64 per cell instead of 256)."""
    cells = [np.flatnonzero(wsp[:, c]) for c in range(wsp.shape[1])]
    offsets = np.cumsum([0] + [len(s) for s in cells]).astype(np.int32)
    s = np.concatenate(cells).astype(np.int32)
    w = wsp[s, np.repeat(np.arange(len(cells)), np.diff(offsets))]
    return offsets, s, w.astype(np.float32)


SUPPORT_OFFSETS, SUPPORT_S, SUPPORT_W = _support(WSP)


def normalize_descriptors(desc):
    """Two-pass normalization with the 0.2 clamp."""
    n1 = torch.sqrt(torch.sum(desc * desc, dim=-1, keepdim=True))
    desc = torch.clamp(desc / torch.clamp(n1, min=1e-12), max=0.2)
    n2 = torch.sqrt(torch.sum(desc * desc, dim=-1, keepdim=True))
    return desc / torch.clamp(n2, min=1e-12)


def descriptor_samples(img, x0, y0a, fx, fy, scale, orientation_deg):
    """The 256 rotated samples of each keypoint at patch-relative
    positions (``ops.image.patch_origin``): (grad [K, 256] windowed
    gradient magnitudes, angi [K, 256] angle bins 0..7 as floats, angf
    [K, 256] the fractions toward bin angi + 1)."""
    dev = img.device
    theta = orientation_deg * _RAD
    ca = torch.cos(theta)[:, None]
    sa = torch.sin(theta)[:, None]
    sc = (0.75 * scale)[:, None]
    s = torch.arange(256, device=dev)
    i_f = (s % 16).to(torch.float32) - 7.5
    j_f = torch.div(s, 16, rounding_mode="floor").to(torch.float32) - 7.5
    bx = fx[:, None] + sc * (i_f * ca - j_f * sa)
    by = fy[:, None] + sc * (i_f * sa + j_f * ca)
    dx = (patch_sample(img, x0, y0a, bx + ca, by + sa)
          - patch_sample(img, x0, y0a, bx + (-ca), by + (-sa)))
    dy = (patch_sample(img, x0, y0a, bx + (-sa), by + ca)
          - patch_sample(img, x0, y0a, bx + sa, by + (-ca)))
    grad = torch.as_tensor(W2D, device=dev) * torch.sqrt(dx * dx + dy * dy)
    ang = (4.0 / math.pi) * torch.atan2(dy, dx) + 4.0
    angi = torch.clamp(torch.floor(ang), 0.0, 7.0)
    return grad, angi, ang - angi


def raw_descriptors(img, x0, y0a, fx, fy, scale, orientation_deg):
    """Unnormalized [K, 128] descriptors at patch-relative keypoints
    (``ops.image.patch_origin``)."""
    dev = img.device
    grad, angi, angf = descriptor_samples(img, x0, y0a, fx, fy, scale,
                                          orientation_deg)
    angi2 = torch.where(angi + 1.0 > 7.0, torch.zeros_like(angi), angi + 1.0)
    bins = torch.arange(8, device=dev, dtype=torch.float32)
    wa = (torch.where(angi[..., None] == bins, (1.0 - angf)[..., None], 0.0)
          + torch.where(angi2[..., None] == bins, angf[..., None], 0.0))
    T = grad[..., None] * wa                                   # [K, 256, 8]
    desc = torch.einsum("ksa,sp->kpa", T, torch.as_tensor(WSP, device=dev))
    return desc.reshape(-1, 128)


def extract_descriptors(img, x, y, scale, orientation_deg, *, valid=None,
                        use_pallas=False):
    """[K, 128] L2-normalized SIFT descriptors of keypoints at (x, y,
    scale, orientation in degrees) on ``img``, sampled by K5.  With
    ``valid``, the valid keypoints are compacted first, K5 samples only
    them, and the rows go back to their slots (invalid rows are zero
    before normalization).  ``use_pallas`` is accepted for the JAX
    package's signature and does not change the result."""
    from portbench.reference.sfm.ops.sample import descriptor_sample

    if valid is None:
        return normalize_descriptors(
            descriptor_sample(img, x, y, scale, orientation_deg))
    order = compaction_order(valid)
    raw_c = descriptor_sample(img, x[order], y[order], scale[order],
                              orientation_deg[order],
                              count=valid.sum().to(torch.int32))
    raw = torch.empty_like(raw_c)
    raw[order] = raw_c
    return normalize_descriptors(raw)
