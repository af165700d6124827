"""Numpy copy of the repository's synthetic sequence
(``tests/synthetic_sequence.py``, rendering only), frozen here beside
``scene_np`` so the benchmark's traffic cannot move with the tests.
The benchmark renders on the card with ``portbench.gen.sequence``;
this copy is what the CPU test holds that renderer against.

The four textured planes of ``scene_np`` seen by ``n_frames`` pinhole
cameras with one K (f = 1.1 * width).  The camera centres lie on a
horizontal arc around the scene's middle depth (``CENTER``, 7 units in
front of frame 0), ``step_deg`` apart, and each camera looks at
``CENTER``; frame 0 is the pair's first camera, so the world frame is
frame 0's camera frame.
"""

from __future__ import annotations

import numpy as np

from portbench.gen.scene_np import _planes, _render

CENTER = np.array([0.0, 0.0, 7.0])


def look_at(C, target=CENTER, up=(0.0, 1.0, 0.0)):
    """World -> camera (R, t) of a camera at C whose +z axis points at
    ``target`` (+y down in the image)."""
    z = np.asarray(target, np.float64) - C
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z])
    return R, -R @ C


def arc_poses(n_frames: int, step_deg: float):
    """World -> camera poses (R [n, 3, 3], t [n, 3]), float64: camera i
    at angle ``i * step_deg`` on the circle of radius |CENTER| about
    CENTER (towards +x), looking at CENTER."""
    r = float(np.linalg.norm(CENTER))
    Rs, ts = [], []
    for i in range(n_frames):
        a = np.deg2rad(step_deg * i)
        R, t = look_at(CENTER + r * np.array([np.sin(a), 0.0, -np.cos(a)]))
        Rs.append(R)
        ts.append(t)
    return np.stack(Rs), np.stack(ts)


def synthetic_sequence(height: int = 576, width: int = 720, n_frames: int = 12,
                       step_deg: float = 4.0, seed: int = 0):
    """Render the sequence: images [n, H, W] float32 (0..255, with
    0.5-level noise), K [3, 3], R [n, 3, 3] and t [n, 3] float32
    (X_cam_i = R_i X + t_i)."""
    rng = np.random.default_rng(seed)
    f = 1.1 * width
    K = np.array([[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0, 0, 1.0]])
    planes = _planes(rng, f)
    Rs, ts = arc_poses(n_frames, step_deg)
    noise = np.random.default_rng(seed + 1)
    imgs = np.stack([
        np.clip(_render(planes, K, R, t, height, width)
                + noise.normal(scale=0.5, size=(height, width)), 0, 255)
        for R, t in zip(Rs, ts)])
    return {"images": imgs.astype(np.float32), "K": K.astype(np.float32),
            "R": Rs.astype(np.float32), "t": ts.astype(np.float32)}
