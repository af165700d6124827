"""Comparisons shared by the entries: rotations, directions and the
pairing of two point sets by position."""

from __future__ import annotations

import math

import numpy as np
import torch


def rotation_gap_deg(Ra, Rb) -> float:
    """The angle between two rotations from ||Ra - Rb||_F = 2 sqrt(2)
    sin(angle / 2): stable for small angles, where arccos((trace - 1)
    / 2) reads ~0.03 degrees on two equal float32 matrices."""
    d = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64))
    return math.degrees(2.0 * math.asin(min(d / (2.0 * math.sqrt(2.0)), 1.0)))


def direction_gap_deg(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c = a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300)
    return math.degrees(math.acos(float(np.clip(c, -1.0, 1.0))))


def pair_rows(a, b, tol, device="cpu", chunk: int = 2048):
    """For each row of ``a`` [n, d] the index of its nearest row of ``b``
    [m, d] where every coordinate is within ``tol`` [d] of it, else -1
    (float64, computed on ``device``)."""
    a, b, tol = (torch.as_tensor(np.asarray(x, np.float64), device=device)
                 for x in (a, b, tol))
    out = torch.full((a.shape[0],), -1, dtype=torch.int64, device=device)
    if not len(a) or not len(b):
        return out.cpu().numpy()
    for s in range(0, a.shape[0], chunk):
        d = torch.cdist(a[s:s + chunk] / tol, b / tol)
        j = torch.argmin(d, dim=1)
        ok = (torch.abs(a[s:s + chunk] - b[j]) <= tol).all(dim=1)
        out[s:s + chunk] = torch.where(ok, j, -1)
    return out.cpu().numpy()


def unpaired_share(pairs_ab, pairs_ba) -> float:
    """The larger share of either set with no partner in the other."""
    shares = [float(np.mean(p < 0)) if len(p) else 0.0 for p in (pairs_ab, pairs_ba)]
    return max(shares)
