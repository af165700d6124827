"""The benchmark's turntable ring rendered with torch on the card.

The scene, cameras, distortion and noise of the repository's synthetic
ring (``tests/synthetic_ring.py``), frozen here so the benchmark's
traffic cannot move with the tests: a textured box (four sides and a
top, each with its own dead-leaves texture, ``scene._dead_leaves``) on
a textured disc that turns with it, over a black background, seen by a
fixed camera while the object turns ``step_deg`` a frame.  In the
object's frame the camera orbits the world y axis at ``DISTANCE``,
raised ``ELEVATION_DEG`` and rolled ``ROLL_DEG``.  Radial distortion
k1 is applied at render time (each pixel's distorted normalized
coordinate is undistorted by fixed-point iteration before its ray is
cast), so a point at normalized x_n lands at pixel c + f x_n (1 + k1
|x_n|^2).  The draws (``scene``: the six textures, ``noise``: the
sensor noise) come from a ``scene.TorchDraws`` (the benchmark's runs)
or a ``scene.NumpyDraws`` (the CPU test that holds this renderer to
``tests/synthetic_ring.py``'s images).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.gen import scene as render

F64 = torch.float64
DISTANCE = 14.0         # camera centre to the turntable axis
ELEVATION_DEG = 15.0    # camera height above the table, as an angle
ROLL_DEG = 3.0          # camera roll about its optical axis
DISC_RADIUS = 0.8
BOX_HALF = (0.45, 0.35)  # box half extents along world x and z
BOX_HEIGHT = 1.6
BOX_OFFSET = (0.06, 0.04)  # box footprint centre off the axis (x, z)
TEXTURE_N = 512


def _faces():
    """(kind, anchor, normal, u_axis, v_axis, extent) per face: the box's
    four sides and top, then the disc (extent its radius)."""
    hx, hz = BOX_HALF
    ox, oz = BOX_OFFSET
    mid = -BOX_HEIGHT / 2
    ex, ey, ez = np.eye(3)
    return [
        ("rect", (ox + hx, mid, oz), ex, ez, ey, (hz, BOX_HEIGHT / 2)),
        ("rect", (ox - hx, mid, oz), -ex, ez, ey, (hz, BOX_HEIGHT / 2)),
        ("rect", (ox, mid, oz + hz), ez, ex, ey, (hx, BOX_HEIGHT / 2)),
        ("rect", (ox, mid, oz - hz), -ez, ex, ey, (hx, BOX_HEIGHT / 2)),
        ("rect", (ox, -BOX_HEIGHT, oz), -ey, ex, ez, (hx, hz)),
        ("disc", (0.0, 0.0, 0.0), -ey, ex, ez, DISC_RADIUS),
    ]


def _camera0():
    """Camera 0's world -> camera (R0, C0): looking at the axis point at
    the box's mid-height, rolled by ``ROLL_DEG``."""
    e = np.deg2rad(ELEVATION_DEG)
    target = np.array([0.0, -BOX_HEIGHT / 2, 0.0])
    C0 = target + DISTANCE * np.array([0.0, -np.sin(e), -np.cos(e)])
    z = target - C0
    z /= np.linalg.norm(z)
    x = np.cross([0.0, 1.0, 0.0], z)
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z])
    return render._rot([0.0, 0.0, 1.0], np.deg2rad(ROLL_DEG)) @ R, C0


def ring_poses(n_frames: int, step_deg: float):
    """World -> camera poses (R [n, 3, 3], t [n, 3]), float64: R_i = R0
    Rot(y, phi_i)^T and C_i = Rot(y, phi_i) C0 with phi_i = i *
    ``step_deg``."""
    R0, C0 = _camera0()
    Rs, ts = [], []
    for i in range(n_frames):
        rot = render._rot([0.0, 1.0, 0.0], np.deg2rad(step_deg * i))
        R = R0 @ rot.T
        Rs.append(R)
        ts.append(-R @ (rot @ C0))
    return np.stack(Rs), np.stack(ts)


def _cast(faces, R, t, xn, texel, device):
    """Intensity [H, W] (0 where no face is hit) of the faces seen from
    camera (R, t) through the undistorted normalized coordinates xn."""
    def d(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device)

    rays = torch.cat([xn, torch.ones_like(xn[..., :1])], -1) @ d(R)
    C = d(-np.asarray(R).T @ np.asarray(t))
    depth = torch.full(xn.shape[:-1], math.inf, dtype=F64, device=device)
    img = torch.zeros(xn.shape[:-1], dtype=F64, device=device)
    for (kind, anchor, normal, u_axis, v_axis, extent), tex in faces:
        den = rays @ d(normal)
        s = ((d(anchor) - C) @ d(normal)) / torch.where(torch.abs(den) < 1e-12,
                                                         torch.full_like(den, 1e-12), den)
        X = C + s[..., None] * rays
        a = (X - d(anchor)) @ d(u_axis)
        b = (X - d(anchor)) @ d(v_axis)
        hit = (s > 0) & (s < depth)
        if kind == "disc":
            hit &= a * a + b * b <= extent * extent
        else:
            hit &= (torch.abs(a) <= extent[0]) & (torch.abs(b) <= extent[1])
        depth = torch.where(hit, s, depth)
        img = torch.where(hit, render._lookup(tex, a, b, texel), img)
    return img


def synthetic_ring(height, width, n_frames, step_deg, focal_px, k1, *, scene, noise,
                   device, texture_n: int = TEXTURE_N):
    """images [n, H, W] float32 on ``device``; K [3, 3], R [n, 3, 3] and
    t [n, 3] numpy float32.  ``texture_n``: the textures' side in texels
    (``TEXTURE_N``, the repository's ring; smaller only for a rehearsal
    on the CPU)."""
    dev = torch.device(device)
    K = np.array([[focal_px, 0.0, width / 2.0], [0.0, focal_px, height / 2.0],
                  [0.0, 0.0, 1.0]])
    faces = [(f, render._dead_leaves(scene, texture_n, rmin=3.0)) for f in _faces()]
    texel = DISTANCE / focal_px     # one texel ~ one pixel at the axis's distance
    v, u = torch.meshgrid(torch.arange(height, device=dev, dtype=F64),
                          torch.arange(width, device=dev, dtype=F64), indexing="ij")
    xd = torch.stack([(u - K[0, 2]) / focal_px, (v - K[1, 2]) / focal_px], -1)
    xn = xd
    for _ in range(20):
        xn = xd / (1.0 + k1 * torch.sum(xn * xn, -1, keepdim=True))
    Rs, ts = ring_poses(n_frames, step_deg)
    imgs = torch.stack([render._noisy(_cast(faces, R, t, xn, texel, dev), noise)
                        for R, t in zip(Rs, ts)])
    return {"images": imgs, "K": K.astype(np.float32), "R": Rs.astype(np.float32),
            "t": ts.astype(np.float32)}
