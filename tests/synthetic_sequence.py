"""Synthetic textured image sequence with known poses (numpy only).

The scene of ``synthetic_pair.py`` (four textured planes at depths 4.5
to 12) seen by ``n_frames`` pinhole cameras with one K.  The camera
centres lie on a horizontal arc around the scene's middle depth
(``CENTER``, 7 units in front of frame 0), ``STEP_DEG`` apart, and each
camera looks at ``CENTER``.  Frame 0 is the pair's first camera
(identity pose), so the world frame is frame 0's camera frame.

At the 4 degree step (``STEP_DEG``) the baseline between neighbours is 0.49
units, the pair's 0.5, so the rays of a point at the middle depth meet
at the pair's angle (~55 px at f); as every camera turns to keep CENTER
in the middle of its view, image motion between neighbours is smaller
(2-33 px, 5th to 95th percentile).  Frames 0 and 11 are 44 degrees
apart and 86% of frame 0's surface lies inside frame 11
(``view_overlap``), so a loop-closure pair (0, 11) has matches.

Imports neither jax nor torch, so the JAX package's reference runs, the
port's tests and the GPU smoke run share it.
"""

from __future__ import annotations

import os

import numpy as np

from synthetic_pair import _cast, _planes, _render, write_pgm

CENTER = np.array([0.0, 0.0, 7.0])
STEP_DEG = 4.0


def look_at(C, target=CENTER, up=(0.0, 1.0, 0.0)):
    """World -> camera (R, t) of a camera at C whose +z axis points at
    ``target`` (+y down in the image, as in ``synthetic_pair``)."""
    z = np.asarray(target, np.float64) - C
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    return R, -R @ C


def arc_poses(n_frames: int = 12):
    """Ground-truth world -> camera poses (R [n, 3, 3], t [n, 3]),
    float64: camera i at angle ``i * STEP_DEG`` on the circle of radius
    |CENTER| about CENTER (towards +x), looking at CENTER."""
    r = float(np.linalg.norm(CENTER))
    Rs, ts = [], []
    for i in range(n_frames):
        a = np.deg2rad(STEP_DEG * i)
        C = CENTER + r * np.array([np.sin(a), 0.0, -np.cos(a)])
        R, t = look_at(C)
        Rs.append(R)
        ts.append(t)
    return np.stack(Rs), np.stack(ts)


def synthetic_sequence(height: int = 576, width: int = 720, n_frames: int = 12,
                       seed: int = 0, with_scene: bool = False):
    """Render the sequence.  Returns dict with images [n, H, W] float32
    (0..255, with ``synthetic_pair``'s 0.5-level noise), K [3, 3]
    (f = 1.1 * width), R [n, 3, 3] and t [n, 3] float32 (X_cam_i =
    R_i X + t_i, in units where CENTER is 7 away); ``with_scene`` adds
    the planes (for ``synthetic_pair._cast``)."""
    rng = np.random.default_rng(seed)
    f = 1.1 * width
    K = np.array([[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0, 0, 1.0]])
    planes = _planes(rng, f)
    Rs, ts = arc_poses(n_frames)
    noise = np.random.default_rng(seed + 1)
    imgs = np.stack([
        np.clip(_render(planes, K, R, t, height, width)
                + noise.normal(scale=0.5, size=(height, width)), 0, 255)
        for R, t in zip(Rs, ts)])
    out = {"images": imgs.astype(np.float32), "K": K.astype(np.float32),
           "R": Rs.astype(np.float32), "t": ts.astype(np.float32)}
    if with_scene:
        out["scene"] = planes
    return out


def nearest_rotations(R):
    """[n, 3, 3] float64 nearest rotation matrices (SVD polar factor).
    A float32 estimate is orthonormal only to ~1e-7, which shifts
    arccos((trace - 1) / 2) by ~0.02 degrees near 0; projected first,
    ``metrics.rotation_errors_deg`` resolves the small errors of a good
    reconstruction."""
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    d = np.sign(np.linalg.det(U @ Vt))
    U[:, :, 2] *= d[:, None]
    return U @ Vt


def pose_quality(metrics, R, t, pose_valid, seq):
    """Registered poses (numpy) against the rendered ones, by either
    package's ``utils.metrics`` (numpy only in both): the Sim(3)-aligned
    ATE and the median and largest rotation error in degrees (the
    estimates projected onto SO(3) first, ``nearest_rotations``)."""
    v = np.asarray(pose_valid, bool)
    R, t = np.asarray(R)[v], np.asarray(t)[v]
    ate, _ = metrics.ate_rmse(R, t, seq["R"][v], seq["t"][v])
    rot = metrics.rotation_errors_deg(nearest_rotations(R), seq["R"][v])
    return {"ate": ate, "rot_median_deg": float(np.median(rot)),
            "rot_max_deg": float(rot.max())}


def view_overlap(planes, K, Ra, ta, Rb, tb, height: int, width: int,
                 step: int = 4) -> float:
    """Share of frame a's pixels (on a ``step``-pixel grid) whose surface
    point projects inside frame b, in front of it."""
    v, u = np.mgrid[0:height:step, 0:width:step].astype(np.float64)
    _, X = _cast(planes, K, Ra, ta, u, v)
    Xb = X.reshape(-1, 3) @ np.asarray(Rb, np.float64).T + tb
    z = Xb[:, 2]
    p = Xb @ np.asarray(K, np.float64).T
    zs = np.where(np.abs(z) < 1e-12, 1e-12, z)
    ub, vb = p[:, 0] / zs, p[:, 1] / zs
    inside = (z > 0) & (ub >= 0) & (ub <= width - 1) & (vb >= 0) & (vb <= height - 1)
    return float(inside.mean())


def orbit_features(n_images=8):
    """Injected features of cameras orbiting a random cloud: the numpy
    twin of ``tests/test_incremental.py:_synthetic_orbit`` at its
    defaults (the same draws), for tests that run without jax.  Returns
    (frames: dicts of x, y, descriptors, valid per keypoint slot, K,
    R_gt, t_gt)."""
    n_points, kp_cap, f, w, h, step_deg, noise_px = 220, 256, 500.0, 640, 480, 8.0, 0.3
    rng = np.random.default_rng(3)
    X = rng.uniform(-1.0, 1.0, (n_points, 3))
    desc = rng.normal(size=(n_points, 128)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    frames, R_gt, t_gt = [], [], []
    for i in range(n_images):
        th = np.radians(step_deg * i)
        R, t = look_at(np.array([5.0 * np.sin(th), 0.6, -5.0 * np.cos(th)]),
                       target=np.zeros(3))
        R_gt.append(R)
        t_gt.append(t)
        xc = X @ R.T + t
        uv = (xc[:, :2] / xc[:, 2:3]) * f + np.array([w / 2, h / 2])
        uv = uv + rng.normal(scale=noise_px, size=uv.shape)
        slots = rng.permutation(kp_cap)[:n_points]
        fr = {"x": np.zeros(kp_cap, np.float32), "y": np.zeros(kp_cap, np.float32),
              "descriptors": np.zeros((kp_cap, 128), np.float32),
              "valid": np.zeros(kp_cap, bool)}
        fr["x"][slots] = uv[:, 0]
        fr["y"][slots] = uv[:, 1]
        nd = desc + rng.normal(scale=0.03, size=desc.shape).astype(np.float32)
        fr["descriptors"][slots] = nd / np.linalg.norm(nd, axis=1, keepdims=True)
        fr["valid"][slots] = True
        frames.append(fr)
    return frames, K, np.stack(R_gt), np.stack(t_gt)


def write_pgms(directory, images):
    """Write each [H, W] frame as ``frame_XX.pgm`` (8-bit, rounded);
    returns the paths in frame order."""
    paths = []
    for i, img in enumerate(images):
        p = os.path.join(directory, f"frame_{i:02d}.pgm")
        write_pgm(p, img)
        paths.append(p)
    return paths
