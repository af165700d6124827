"""Synthetic turntable ring with known poses and radial distortion
(numpy only), rendered like the dino sequence.

A textured object made of bounded planes stands on a turntable over a
black background: a box (four side faces and a top, each with its own
dead-leaves texture, ``synthetic_pair._dead_leaves``) on a textured disc
that turns with it.  Nothing in the frame is static.  A fixed camera
watches the object turn by ``STEP_DEG`` per frame; in the object's frame
(the world frame here) the camera orbits the turntable axis, which is
the world y axis (+y points down, as in ``synthetic_pair``).

The geometry follows the dino's: the camera stands ``DISTANCE`` from
the axis, raised ``ELEVATION_DEG`` above the table so the box's top and
the disc are seen, and rolled ``ROLL_DEG`` about its optical axis, so
the turntable axis is tilted a few degrees off the image vertical.  The
disc (``DISC_RADIUS``) spans about a third of the frame width at f =
2360 px, the JAX tool's default, with the principal point at the frame
centre; the axis passes through the object, so the distance over the
object's radius is ~20, as on the dino (NOTES_R2.md: d/r 20-50), and
neighbouring frames differ by a few to ~25 px of image motion.

Radial distortion k1 is applied at render time: each pixel's distorted
normalized coordinate x_d is undistorted by fixed-point iteration of
x_n = x_d / (1 + k1 |x_n|^2) before its ray is cast, so a point at
normalized x_n lands at pixel c + f x_n (1 + k1 |x_n|^2), the model of
``models/calibrate.py`` and ``models/turntable.py``.

``synthetic_ring`` returns the frames, K, k1 and the ground-truth
world -> camera poses, and with ``directory`` writes the frames as
``viff.000.ppm`` ... ``viff.{n-1}.ppm`` (8-bit binary PGM, magic P5:
both packages' readers go by the magic number) plus ``viff.{n}.ppm``
identical to ``viff.000.ppm``, as the dino's 37 files close the ring.

Imports neither jax nor torch, so the JAX package's reference run, the
port's tests and the GPU smoke run share it.
"""

from __future__ import annotations

import os

import numpy as np

from synthetic_pair import _dead_leaves, _lookup, _rot, write_pgm

STEP_DEG = 10.0
FOCAL_PX = 2360.0
DISTANCE = 14.0         # camera centre to the turntable axis
ELEVATION_DEG = 15.0    # camera height above the table, as an angle
ROLL_DEG = 3.0          # camera roll about its optical axis
DISC_RADIUS = 0.8
BOX_HALF = (0.45, 0.35)  # box half extents along world x and z
BOX_HEIGHT = 1.6
BOX_OFFSET = (0.06, 0.04)  # box footprint centre off the axis (x, z)
TEXTURE_N = 512


def _shapes(rng, texel):
    """(kind, anchor, normal, u_axis, v_axis, extent, texture) per face:
    the box's four sides and top, then the disc (kind "disc", extent
    its radius); the box stands on the disc at y = 0."""
    hx, hz = BOX_HALF
    ox, oz = BOX_OFFSET
    mid = -BOX_HEIGHT / 2
    ex, ey, ez = np.eye(3)
    faces = [
        ("rect", (ox + hx, mid, oz), ex, ez, ey, (hz, BOX_HEIGHT / 2)),
        ("rect", (ox - hx, mid, oz), -ex, ez, ey, (hz, BOX_HEIGHT / 2)),
        ("rect", (ox, mid, oz + hz), ez, ex, ey, (hx, BOX_HEIGHT / 2)),
        ("rect", (ox, mid, oz - hz), -ez, ex, ey, (hx, BOX_HEIGHT / 2)),
        ("rect", (ox, -BOX_HEIGHT, oz), -ey, ex, ez, (hx, hz)),
        ("disc", (0.0, 0.0, 0.0), -ey, ex, ez, DISC_RADIUS),
    ]
    return [(kind, np.asarray(a, np.float64), n, u, v, ext,
             _dead_leaves(rng, TEXTURE_N, rmin=3.0))
            for kind, a, n, u, v, ext in faces], texel


def _camera0():
    """Camera 0's world -> camera (R0, C0): at ``DISTANCE`` from the axis
    and ``ELEVATION_DEG`` above the table, looking at the axis point at
    the box's mid-height, rolled by ``ROLL_DEG``."""
    e = np.deg2rad(ELEVATION_DEG)
    target = np.array([0.0, -BOX_HEIGHT / 2, 0.0])
    C0 = target + DISTANCE * np.array([0.0, -np.sin(e), -np.cos(e)])
    z = target - C0
    z /= np.linalg.norm(z)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z])
    return _rot([0.0, 0.0, 1.0], np.deg2rad(ROLL_DEG)) @ R, C0


def ring_poses(n_frames: int = 36):
    """Ground-truth world -> camera poses (R [n, 3, 3], t [n, 3]), float64,
    in the turntable model's form: R_i = R0 Rot(y, phi_i)^T and C_i =
    Rot(y, phi_i) C0 with phi_i = i * STEP_DEG."""
    R0, C0 = _camera0()
    Rs, ts = [], []
    for i in range(n_frames):
        rot = _rot([0.0, 1.0, 0.0], np.deg2rad(STEP_DEG * i))
        R = R0 @ rot.T
        Rs.append(R)
        ts.append(-R @ (rot @ C0))
    return np.stack(Rs), np.stack(ts)


def undistort(xd, k1: float, iters: int = 20):
    """Distorted normalized coordinates [..., 2] -> undistorted, by the
    fixed-point iteration x_n = x_d / (1 + k1 |x_n|^2)."""
    xn = xd
    for _ in range(iters):
        xn = xd / (1.0 + k1 * np.sum(xn * xn, axis=-1, keepdims=True))
    return xn


def _cast(shapes, R, t, xn):
    """Ray-cast the faces from camera (R, t) through undistorted
    normalized coordinates xn [..., 2]: intensity (0 where no face is
    hit: the black background), float64."""
    faces, texel = shapes
    rays = np.concatenate([xn, np.ones(xn.shape[:-1] + (1,))], -1) @ R
    C = -R.T @ t
    depth = np.full(xn.shape[:-1], np.inf)
    img = np.zeros(xn.shape[:-1])
    for kind, anchor, normal, u_axis, v_axis, extent, tex in faces:
        den = rays @ normal
        s = ((anchor - C) @ normal) / np.where(np.abs(den) < 1e-12, 1e-12, den)
        X = C + s[..., None] * rays
        a = (X - anchor) @ u_axis
        b = (X - anchor) @ v_axis
        hit = (s > 0) & (s < depth)
        if kind == "disc":
            hit &= a * a + b * b <= extent * extent
        else:
            hit &= (np.abs(a) <= extent[0]) & (np.abs(b) <= extent[1])
        depth = np.where(hit, s, depth)
        img = np.where(hit, _lookup(tex, a, b, texel), img)
    return img


def synthetic_ring(height: int = 576, width: int = 720, n_frames: int = 36,
                   k1: float = -0.45, seed: int = 0, directory=None):
    """Render the ring.  Returns dict with images [n, H, W] float32
    (0..255, with ``synthetic_pair``'s 0.5-level noise), K [3, 3]
    (f = ``FOCAL_PX``, principal point at the frame centre), k1, R
    [n, 3, 3] and t [n, 3] float32 (X_cam_i = R_i X + t_i); with
    ``directory``, also "paths": the n + 1 files written there
    (``write_ring``)."""
    rng = np.random.default_rng(seed)
    K = np.array([[FOCAL_PX, 0.0, width / 2.0], [0.0, FOCAL_PX, height / 2.0],
                  [0.0, 0.0, 1.0]])
    # One texel ~ one pixel at the axis's distance.
    shapes = _shapes(rng, DISTANCE / FOCAL_PX)
    v, u = np.mgrid[0:height, 0:width].astype(np.float64)
    xd = np.stack([(u - K[0, 2]) / FOCAL_PX, (v - K[1, 2]) / FOCAL_PX], -1)
    xn = undistort(xd, k1)
    Rs, ts = ring_poses(n_frames)
    noise = np.random.default_rng(seed + 1)
    imgs = np.stack([
        np.clip(_cast(shapes, R, t, xn) + noise.normal(scale=0.5, size=(height, width)),
                0, 255)
        for R, t in zip(Rs, ts)])
    out = {"images": imgs.astype(np.float32), "K": K.astype(np.float32),
           "k1": float(k1), "R": Rs.astype(np.float32), "t": ts.astype(np.float32)}
    if directory is not None:
        out["paths"] = write_ring(directory, out["images"])
    return out


def write_ring(directory, images):
    """Write each [H, W] frame as ``viff.NNN.ppm`` (8-bit P5, rounded) and
    frame 0 once more after the last, as the dino's files close the
    ring; returns the n + 1 paths in order."""
    paths = []
    for i, img in enumerate([*images, images[0]]):
        p = os.path.join(directory, f"viff.{i:03d}.ppm")
        write_pgm(p, img)
        paths.append(p)
    return paths


# The 12-frame injected ring of tests/test_turntable.py's end-to-end
# test, in numpy: cameras orbit the origin about a slightly tilted axis
# at radius 5, f = 1800 px at (360, 288), 160 points with track-unique
# descriptors.
INJECTED_FRAMES = 12
INJECTED_F_PX = 1800.0
INJECTED_C_PX = (360.0, 288.0)
INJECTED_K = np.array([[INJECTED_F_PX, 0, INJECTED_C_PX[0]],
                       [0, INJECTED_F_PX, INJECTED_C_PX[1]], [0, 0, 1]], np.float32)


def _so3_log(R):
    """Axis-angle of a rotation (float64; angles well inside (0, pi))."""
    R = np.asarray(R, np.float64)
    theta = np.arccos(np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0))
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return v * (theta / (2.0 * np.sin(theta)))


def injected_ring(seed: int = 11, n_pts: int = 160, radius: float = 5.0):
    """tests/test_turntable.py:test_reconstruct_turntable_end_to_end's
    ring and its draws: 12 frames of injected features (per-frame 0.3 px
    pixel noise, descriptors with 0.05 noise), the true poses, and the
    bas-relief-collapsed chain (every step's rotation compressed to 0.45
    of itself about its own axis, chords kept) that the turntable path
    starts from.  Returns (frames: dicts of x, y, valid, descriptors;
    R_chain, t_chain, R_gt, t_gt), float32."""
    from helpers import rot

    rng = np.random.default_rng(seed)
    n, step = INJECTED_FRAMES, 2 * np.pi / INJECTED_FRAMES
    axis = np.array([0.05, 1.0, 0.02]) / np.linalg.norm([0.05, 1.0, 0.02])
    X = rng.uniform(-0.8, 0.8, size=(n_pts, 3)).astype(np.float32)
    C0 = radius * np.array([0.0, 0.0, -1.0], np.float32)
    z = -C0 / np.linalg.norm(C0)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    R0 = np.stack([x, np.cross(z, x), z]).astype(np.float32)
    Rs, ts = [], []
    for i in range(n):
        Rot_i = rot(axis, step * i).astype(np.float32)
        Ri = R0 @ Rot_i.T
        Rs.append(Ri)
        ts.append(-Ri @ (Rot_i @ C0))
    R, t = np.stack(Rs), np.stack(ts)
    D = rng.normal(size=(n_pts, 128)).astype(np.float32)
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    frames = []
    for i in range(n):
        Xc = X @ R[i].T + t[i]
        uv = Xc[:, :2] / Xc[:, 2:]
        pix = (INJECTED_C_PX + INJECTED_F_PX * uv
               + rng.normal(scale=0.3, size=uv.shape)).astype(np.float32)
        Df = D + rng.normal(scale=0.05, size=D.shape).astype(np.float32)
        Df /= np.linalg.norm(Df, axis=1, keepdims=True)
        frames.append({"x": pix[:, 0], "y": pix[:, 1], "valid": np.ones(n_pts, bool),
                       "descriptors": Df})
    # Bas-relief collapse: rotations compressed, chords kept.
    C = -np.einsum("mij,mi->mj", R, t)
    Rc, Cc = [R[0]], [C[0]]
    for i in range(1, n):
        rv = _so3_log(R[i - 1].T @ R[i])
        Rc.append(Rc[-1] @ rot(rv / np.linalg.norm(rv), np.linalg.norm(rv) * 0.45))
        Cc.append(Cc[-1] + (C[i] - C[i - 1]))
    Rc = np.stack(Rc).astype(np.float32)
    Cc = np.stack(Cc).astype(np.float32)
    return frames, Rc, -np.einsum("mij,mj->mi", Rc, Cc), R, t
