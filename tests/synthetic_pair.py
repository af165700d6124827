"""Synthetic textured two-view pair with known pose (numpy only).

Four textured planes at different depths (a tilted background, a floor
whose depth grows up the image, a middle slab and a near plane) are
ray-cast from two pinhole
cameras with the same intrinsics K: camera 1 at the origin and camera
2 at (R, t), with X_cam2 = R X_cam1 + t.  Each plane carries its own
band-limited noise texture (blobs at several scales, which is what the
DoG detector responds to), fixed in plane coordinates, so both views
see the same surface texture and every detection has a true
correspondence.  The 0.5-unit baseline against depths of 4 to 12
gives 30-100 px of parallax at full size, and no single plane holds
most of the matches, so E is well posed.

``rotation_pair`` renders the same planes, with dead-leaves textures,
from one camera centre with a rotation only, so its two views are
related by an exact homography.

The renderer is the benchmark's (``portbench/gen/scene_np.py``), so the
tests, the card's harnesses and the benchmark's traffic see the same
scenes; this module adds the tests' own helpers.  Imports neither jax
nor torch, so the JAX tests, the port's tests and the GPU smoke run
share it.
"""

from __future__ import annotations

import numpy as np

from portbench.gen.scene_np import (  # noqa: F401  (re-exported for the tests' scenes)
    _cast, _dead_leaves, _lookup, _planes, _render, _rot, rotation_pair, synthetic_pair)


def transfer_px(H, uv1, uv2):
    """Distances [N] in px between H applied to uv1 [N, 2] and uv2."""
    x = np.concatenate([np.asarray(uv1, np.float64).T, np.ones((1, len(uv1)))])
    p = np.asarray(H, np.float64) @ x
    return np.linalg.norm(p[:2] / p[2] - np.asarray(uv2, np.float64).T, axis=0)


def homography_grid_errors(H_est, H_gt, height: int, width: int,
                           nx: int = 16, ny: int = 12):
    """Transfer distances [ny * nx] in px between two homographies on
    an nx x ny grid of pixel centres spanning the image."""
    u, v = np.meshgrid(np.linspace(0, width - 1, nx), np.linspace(0, height - 1, ny))
    grid = np.stack([u.ravel(), v.ravel()], axis=1)
    x = np.concatenate([grid.T, np.ones((1, len(grid)))])
    p = np.asarray(H_gt, np.float64) @ x
    return transfer_px(H_est, grid, (p[:2] / p[2]).T)


def pose_errors_deg(R_est, t_est, R_gt, t_gt):
    """(rotation angle error, translation direction error) in degrees:
    floats for one pose ([3, 3], [3]), arrays for a batch ([..., 3, 3],
    [..., 3]).  By atan2, which is exact near 0, where an arccos of the
    trace reads ~0.03 degrees on equal float32 matrices; a zero-length
    translation reads 90 degrees."""
    Rd = np.asarray(R_est, np.float64) @ np.swapaxes(np.asarray(R_gt, np.float64), -1, -2)
    s = np.stack([Rd[..., 2, 1] - Rd[..., 1, 2], Rd[..., 0, 2] - Rd[..., 2, 0],
                  Rd[..., 1, 0] - Rd[..., 0, 1]], -1) / 2
    c = (np.trace(Rd, axis1=-2, axis2=-1) - 1) / 2
    rot = np.degrees(np.arctan2(np.linalg.norm(s, axis=-1), c))
    a = np.asarray(t_est, np.float64)
    b = np.asarray(t_gt, np.float64)
    tdir = np.where(np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) > 1e-12,
                    np.degrees(np.arctan2(np.linalg.norm(np.cross(a, b), axis=-1),
                                          np.sum(a * b, axis=-1))), 90.0)
    if rot.ndim == 0 and tdir.ndim == 0:
        return float(rot), float(tdir)
    return rot, tdir


def refine_problem(seed, n, B):
    """A two-view scene for the pose refinement: n correspondences in
    normalized coordinates (a ~110 degree field of view, depths 2-8, a
    unit baseline), 5e-4 noise on both views, the first 20% of x2
    replaced by uniform outliers; B starts within ~2 degrees and ~3
    degrees of translation direction of the truth; inlier masks as
    RANSAC would hand them over, each missing 5% of the inliers and
    keeping 5% of the outliers (Huber's linear branch), one shared [n]
    and one per start [B, n], the latter scaled by uniform(0.5, 1).
    Returns float32 (R [B, 3, 3], t [B, 3], x1 [n, 3], x2 [n, 3]), the
    bool [n] mask and the float32 [B, n] weights."""
    rng = np.random.default_rng(seed)
    R = _rot([0.1, 1.0, 0.05], 0.2)
    t = np.array([0.8, 0.1, 0.15]) / np.linalg.norm([0.8, 0.1, 0.15])
    X = rng.uniform([-3, -2.4, 2.0], [3, 2.4, 8.0], size=(n, 3))
    x1, x2 = X / X[:, 2:3], (X @ R.T + t) / (X @ R.T + t)[:, 2:3]
    x1[:, :2] += rng.normal(scale=5e-4, size=(n, 2))
    x2[:, :2] += rng.normal(scale=5e-4, size=(n, 2))
    k = int(0.2 * n)
    x2[:k, :2] = rng.uniform(-1, 1, size=(k, 2))
    Rs = np.stack([_rot(rng.normal(size=3), 0.03 * rng.random()) @ R for _ in range(B)])
    ts = t + rng.normal(scale=0.05, size=(B, 3))
    inlier = np.arange(n) >= k
    keep = lambda shape: (inlier | (rng.random(shape) < 0.05)) & (rng.random(shape) > 0.05)
    w_bool = keep(n)
    w_float = keep((B, n)) * rng.uniform(0.5, 1.0, size=(B, n))
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(Rs), f32(ts), f32(x1), f32(x2), w_bool, f32(w_float)


def pnp_problem(seed, n, live, prior_wins, n_hyps=256, noise=1e-3, prior_deg=0.15):
    """A registration for PnP as the sequence hands it over: n rows of
    normalized observations x [n, 3] and world points X [n, 3] (a ~110
    degree field of view, depths 2-8), a share ``live`` of them in the
    mask, ``noise`` on the observations (the strict gate 1.2e-5 lies at
    3.5 sigma of the default, so the LO rounds gain inliers on the
    start), 20% of the live rows uniform outliers; dead rows carry row
    0's point and an unrelated observation, as the sequence's unmatched
    slots do.  The prior (R_init, t_init) sits ``prior_deg`` and 1e-3
    from the truth where ``prior_wins``, else 8 degrees off; the
    minimal sets [n_hyps, 6] hold two outliers each where the prior is
    to win (so it has more support than every hypothesis), else inliers
    only.  Returns float32 arrays (x, X, R_init, t_init), the
    bool mask and the int64 sets."""
    rng = np.random.default_rng(seed)
    R = _rot([0.3, -1.0, 0.2], 0.3)
    t = np.array([0.4, -0.1, 0.2])
    Xc = rng.uniform([-2.8, -2.2, 2.0], [2.8, 2.2, 8.0], size=(n, 3))
    X = (Xc - t) @ R
    x = Xc / Xc[:, 2:3]
    x[:, :2] += rng.normal(scale=noise, size=(n, 2))
    mask = rng.random(n) < live
    live_rows = np.flatnonzero(mask)
    outlier = np.zeros(n, bool)
    outlier[rng.choice(live_rows, int(0.2 * live_rows.size), replace=False)] = True
    x[outlier, :2] = rng.uniform(-1, 1, size=(int(outlier.sum()), 2))
    X[~mask] = X[0]
    x[~mask, :2] = rng.uniform(-1, 1, size=(int((~mask).sum()), 2))
    good, bad = np.flatnonzero(mask & ~outlier), np.flatnonzero(outlier)
    if prior_wins and bad.size >= 2 and good.size >= 4:
        sets = np.concatenate([np.stack([rng.choice(good, 4, replace=False) for _ in range(n_hyps)]),
                               np.stack([rng.choice(bad, 2, replace=False) for _ in range(n_hyps)])],
                              axis=1)
    else:
        pool = good if good.size >= 6 else np.arange(n)
        sets = np.stack([rng.choice(pool, 6, replace=False) for _ in range(n_hyps)])
    ang, dt = (prior_deg, 1e-3) if prior_wins else (8.0, 0.05)
    R_init = _rot(rng.normal(size=3), np.radians(ang)) @ R
    t_init = t + dt
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(x), f32(X), f32(R_init), f32(t_init), mask, sets.astype(np.int64)


def pose_problem(seed, n, behind=0.0, s1=1.0, outliers=0.1):
    """A scene for the cheirality vote of ``recover_pose``: n
    correspondences in normalized coordinates (depths 4-8, a unit
    baseline, 5e-4 noise on both views), of which the first
    ``round(behind * n)`` see points behind both cameras, which vote for
    the true rotation with -t (``behind=0.5``, even n: an exact tie
    between those two branches), and a share ``outliers`` of the rest
    uniform noise in x2.  E = U diag(1, s1, 0) V^T from an SVD of the
    true [t]x R: s1 = 1 is the essential matrix itself, whose two equal
    singular values leave the basis of their plane, and so the order of
    the four candidates, to the rounding; s1 < 1 fixes that order and
    keeps the candidates; s1 -> 0 is a near-rank-1 E.  Returns float32
    (E [3, 3], x1 [n, 3], x2 [n, 3]), 0/1 weights [n] (outliers and 5%
    of the rest 0) and real weights uniform in (0.2, 1)."""
    rng = np.random.default_rng(seed)
    R = _rot(rng.normal(size=3), rng.uniform(0.05, 0.4))
    t = rng.normal(size=3)
    t /= np.linalg.norm(t)
    X = rng.uniform([-1, -1, 4.0], [1, 1, 8.0], size=(n, 3))
    k = int(round(behind * n))
    X[:k] = -X[:k]
    Xc = X @ R.T + t
    x1, x2 = X / X[:, 2:3], Xc / Xc[:, 2:3]
    x1[:, :2] += rng.normal(scale=5e-4, size=(n, 2))
    x2[:, :2] += rng.normal(scale=5e-4, size=(n, 2))
    bad = np.zeros(n, bool)
    bad[k + rng.permutation(n - k)[:int(outliers * (n - k))]] = True
    x2[bad, :2] = rng.uniform(-0.3, 0.3, size=(int(bad.sum()), 2))
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    U, _, Vt = np.linalg.svd(tx @ R)
    E = U @ np.diag([1.0, s1, 0.0]) @ Vt
    f32 = lambda a: np.asarray(a, np.float32)
    w01 = ~bad & (rng.random(n) > 0.05)
    return f32(E), f32(x1), f32(x2), f32(w01), f32(rng.uniform(0.2, 1.0, size=n))


def write_pgm(path, img):
    """Write an [H, W] 0..255 float image as an 8-bit binary PGM (P5),
    rounded to the nearest level: the form the command-line drivers of
    both packages read."""
    a = np.clip(np.rint(np.asarray(img, np.float64)), 0, 255).astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(b"P5\n%d %d\n255\n" % (a.shape[1], a.shape[0]))
        fh.write(a.tobytes())
