"""Dense image ops: Gaussian taps, separable filtering, resampling,
bilinear sampling and the sampling kernels' patch geometry (counterpart
of ``sfm_tpu/ops/image.py``).

The base chain's blur, decimation and upsample are K1, K2 and K7 in
``sfm_tpu_torch/ops/pyramid.py``.  :func:`blur`, :func:`blur_bank` and
:func:`scale_down` are the JAX package's XLA filters, which the dense
DoG detector runs for its blur bank: edge-clamped separable filtering as
explicit shifted f32 multiply-adds, one PyTorch op each, so no
convolution (cuDNN, TF32 by default on the card, whose rounding injects
phantom DoG extrema) is on the path and the card computes the CPU's
values bit for bit.  :func:`scale_up` is K7.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.sfm.ops import pyramid as _pyr


def gaussian_kernel(radius: int, variance: float) -> np.ndarray:
    """Truncated, normalized Gaussian taps [2r+1] (host-side constant)."""
    j = np.arange(-radius, radius + 1, dtype=np.float64)
    if variance <= 1e-12:
        k = (j == 0).astype(np.float64)
    else:
        k = np.exp(-(j * j) / (2.0 * variance))
    k = k / k.sum()
    return k.astype(np.float32)


def _sep_conv(img, taps_row, taps_col):
    """Separable filtering of [C, H, W] with per-channel taps [C, K]:
    along W with ``taps_row``, then along H with ``taps_col``, each pass
    over an edge-replicated pad (the JAX package's ``mode="edge"`` pad
    and VALID convolution).  XLA's convolution and this sum both
    correlate (no tap flip), so they agree for any taps; the Gaussian
    taps are symmetric, where correlation and convolution are one."""
    C, H, W = img.shape
    t_row = torch.as_tensor(np.asarray(taps_row, np.float32).reshape(C, -1),
                            device=img.device)
    t_col = torch.as_tensor(np.asarray(taps_col, np.float32).reshape(C, -1),
                            device=img.device)
    K = t_row.shape[1]
    r = K // 2

    def taps_times(t, views):   # t[:, 0] v0 + t[:, 1] v1 + ..., left to right
        acc = t[:, 0, None, None] * views[0]
        for k in range(1, K):
            acc = acc + t[:, k, None, None] * views[k]
        return acc

    x = F.pad(img[None], (r, r, 0, 0), mode="replicate")[0]
    x = taps_times(t_row, [x[:, :, k:k + W] for k in range(K)])
    x = F.pad(x[None], (0, 0, r, r), mode="replicate")[0]
    return taps_times(t_col, [x[:, k:k + H, :] for k in range(K)])


def blur(img, taps):
    """Separable edge-clamped blur of [H, W] with 1-D taps."""
    taps = np.asarray(taps, np.float32)
    return _sep_conv(img[None], taps[None], taps[None])[0]


def blur_bank(img, taps_bank):
    """Blur [H, W] with a bank of B kernels at once -> [B, H, W]."""
    bank = np.atleast_2d(np.asarray(taps_bank, np.float32))
    rep = img[None].expand(bank.shape[0], *img.shape)
    return _sep_conv(rep, bank, bank)


def scale_down(img, variance: float = 0.5):
    """5-tap Gaussian blur, then every second row and column from the
    first: [H, W] -> [ceil(H / 2), ceil(W / 2)], the JAX package's
    ``scale_down`` (the base chain's K2 keeps [H // 2, W // 2]; the two
    agree on even sizes)."""
    return blur(img, gaussian_kernel(2, variance))[0::2, 0::2]


def scale_up(img):
    """2x upsample with the reference's interleave, [H, W] -> [2H, 2W]:
    K7 for a CUDA tensor, its plain version for a CPU one."""
    return _pyr.scale_up(img)


def bilinear_sample(img, x, y):
    """Bilinear sample [H, W] at float coords (x = col, y = row),
    clamped to the image; integer coords hit pixel centers."""
    H, W = img.shape
    x = torch.clamp(x, 0.0, W - 1.0)
    y = torch.clamp(y, 0.0, H - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    v00 = img[y0, x0]
    v01 = img[y0, x1]
    v10 = img[y1, x0]
    v11 = img[y1, x1]
    return (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
            + v10 * fy * (1 - fx) + v11 * fy * fx)


# Patch geometry of the TPU sampling kernels (sfm_tpu/ops/pallas_sample.py):
# a P-column, (P + 8)-row patch whose origin depends only on the
# keypoint.  The descriptor kernels (K4, K5, K9) take P = 40, the
# orientation kernel (K8) P = 16.
DESC_P = 40
ORI_P = 16


def padded_dims(H: int, W: int, P: int = DESC_P):
    """The TPU kernels' padded atlas size: rows to a multiple of 8 and at
    least P + 8, columns to a multiple of 128 and at least P."""
    return (max(-(-H // 8) * 8, P + 8),
            max(-(-W // 128) * 128, P))


def patch_origin(x, y, H: int, W: int, P: int = DESC_P):
    """Patch origin (x0, y0a) [K] and patch-relative (fx, fy) [K].

    x0 = clip(floor(x) - (P/2 - 1), 0, Wp - P); rows start at the
    8-aligned y0a <= Hp - (P + 8).  Coordinates relative to an integer
    origin keep the f32 rounding of the sample positions independent of
    where the keypoint sits in the atlas.
    """
    Hp, Wp = padded_dims(H, W, P)
    half = P // 2 - 1
    x0 = torch.clamp(torch.floor(x).to(torch.int64) - half, 0, max(Wp - P, 0))
    y0 = torch.clamp(torch.floor(y).to(torch.int64) - half, 0, max(Hp - P, 0))
    fx = x - x0.to(torch.float32)
    fy = y - y0.to(torch.float32)
    y0a = torch.clamp(torch.clamp(torch.div(y0, 8, rounding_mode="floor") * 8,
                                  max=Hp - P - 8), min=0)
    fy = fy + (y0 - y0a).to(torch.float32)
    return x0, y0a, fx, fy


def patch_sample(img, x0, y0a, px, py, P: int = DESC_P):
    """Bilinear samples [K, S] at patch-relative (px, py), clamped to
    the P x (P + 8) patch and to the image (the TPU kernels' edge
    padding)."""
    H, W = img.shape
    rows = P + 8
    px = torch.clamp(px, 0.0, P - 1.0)
    py = torch.clamp(py, 0.0, rows - 1.0)
    ixf = torch.floor(px)
    iyf = torch.floor(py)
    fxw = px - ixf
    fyw = py - iyf
    ix = ixf.to(torch.int64)
    iy = iyf.to(torch.int64)
    x0 = x0[:, None]
    y0a = y0a[:, None]
    gx0 = torch.clamp(x0 + ix, 0, W - 1)
    gx1 = torch.clamp(x0 + torch.clamp(ix + 1, max=P - 1), 0, W - 1)
    gy0 = torch.clamp(y0a + iy, 0, H - 1)
    gy1 = torch.clamp(y0a + torch.clamp(iy + 1, max=rows - 1), 0, H - 1)
    ux = 1.0 - fxw
    uy = 1.0 - fyw
    return (ux * (uy * img[gy0, gx0] + fyw * img[gy1, gx0])
            + fxw * (uy * img[gy0, gx1] + fyw * img[gy1, gx1]))
