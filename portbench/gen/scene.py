"""The benchmark's scenes rendered with torch on the card.

The same four textured planes, cameras and noise as ``scene_np`` (the
frozen numpy copy of the repository's synthetic scenes), computed in
float64 on the device: the random draws come from a ``Draws`` object,
the textures are synthesised by FFT, the dead-leaves shapes are painted
all at once (each pixel takes the last shape that covers it, as the
numpy loop paints later shapes on top), then the planes are ray-cast
and the textures looked up.  Images come out as float32 on the device.

``TorchDraws`` draws on the device from a ``torch.Generator`` (the
benchmark's runs); ``NumpyDraws`` replays ``numpy.random.default_rng``
in the numpy copy's order, so the CPU test can hold the two renderers
to the same images.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F64 = torch.float64


class TorchDraws:
    """Uniform and normal float64 draws on ``device`` from one seed."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed) % (1 << 63))

    def normal(self, shape):
        return torch.randn(shape, generator=self.gen, device=self.device, dtype=F64)

    def random(self, shape):
        return torch.rand(shape, generator=self.gen, device=self.device, dtype=F64)


class NumpyDraws:
    """The draws of ``numpy.random.default_rng(seed)``, moved to ``device``."""

    def __init__(self, seed: int, device="cpu"):
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)

    def normal(self, shape):
        return torch.as_tensor(self.rng.normal(size=shape), device=self.device)

    def random(self, shape):
        return torch.as_tensor(self.rng.random(shape), device=self.device)


def _rot(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * (Kx @ Kx)


def _freq2(n, device):
    f = torch.fft.fftfreq(n, device=device, dtype=F64)
    return f[:, None] ** 2 + f[None, :] ** 2


def _std(x):
    return torch.std(x, correction=0)


def _texture(draws, n=1024):
    """[n, n] noise texture in 0..255 with blobs at 3 scales (texels)."""
    f2 = _freq2(n, draws.device)
    out = torch.zeros((n, n), dtype=F64, device=draws.device)
    for sigma, weight in ((1.6, 1.0), (3.5, 0.8), (8.0, 0.6)):
        spec = torch.fft.fft2(draws.normal((n, n)))
        band = torch.fft.ifft2(spec * torch.exp(-2 * math.pi ** 2 * sigma ** 2 * f2)).real
        out += weight * band / _std(band)
    out = out / _std(out)
    return torch.clamp(128.0 + 45.0 * out, 0.0, 255.0)


def _dead_leaves(draws, n=1024, rmin=4.0):
    """[n, n] dead-leaves texture in 0..255 (``scene_np._dead_leaves``):
    the shapes are drawn as there, then painted in groups of one box
    size; each pixel keeps the highest shape index that covers it."""
    dev = draws.device
    rmax = n / 12.0
    count = int(3 * n * n / (rmin * rmax))
    r = rmin / (1.0 - draws.random(count) * (1.0 - rmin / rmax))
    cxy = draws.random((2, count)) * n
    cx, cy = cxy[0], cxy[1]
    theta = draws.random(count) * math.pi
    aspect = 0.3 + 0.7 * draws.random(count)
    level = draws.normal(count)
    rect = draws.random(count) < 0.5
    e_all = torch.ceil(r).to(torch.int64) + 1
    top = torch.full((n * n,), -1, dtype=torch.int64, device=dev)
    e_host = e_all.cpu().numpy()
    for e in np.unique(e_host):
        sel = torch.as_tensor(np.nonzero(e_host == e)[0], device=dev)
        e = int(e)
        off = torch.arange(-e, e + 1, device=dev)
        x0 = torch.floor(cx[sel]).to(torch.int64)      # int() of a non-negative
        y0 = torch.floor(cy[sel]).to(torch.int64)
        xx = x0[:, None, None] + off[None, None, :]    # [G, 1, B]
        yy = y0[:, None, None] + off[None, :, None]    # [G, B, 1]
        dx = xx.to(F64) + 0.5 - cx[sel, None, None]
        dy = yy.to(F64) + 0.5 - cy[sel, None, None]
        th = theta[sel, None, None]
        c, s = torch.cos(th), torch.sin(th)
        u = c * dx + s * dy
        v = (c * dy - s * dx) / aspect[sel, None, None]
        rr = r[sel, None, None]
        inside = torch.where(rect[sel, None, None],
                             torch.maximum(torch.abs(u), torch.abs(v)) <= rr,
                             u * u + v * v <= rr ** 2)
        pix = (yy % n) * n + (xx % n)
        idx = sel[:, None, None].expand_as(inside)
        top.scatter_reduce_(0, pix[inside], idx[inside], reduce="amax")
    out = torch.where(top >= 0, level[top.clamp(min=0)],
                      torch.zeros((), dtype=F64, device=dev)).reshape(n, n)
    f2 = _freq2(n, dev)
    out = torch.fft.ifft2(torch.fft.fft2(out) * torch.exp(-2 * math.pi ** 2 * 0.49 * f2)).real
    out = out / _std(out)
    return torch.clamp(128.0 + 45.0 * out, 0.0, 255.0)


def _lookup(tex, a, b, texel):
    """Bilinear, wrapping texture lookup at plane coords (a, b)."""
    n = tex.shape[0]
    u = a / texel + n / 2
    v = b / texel + n / 2
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = u - u0
    fv = v - v0
    i0 = u0.to(torch.int64) % n
    j0 = v0.to(torch.int64) % n
    i1 = (i0 + 1) % n
    j1 = (j0 + 1) % n
    flat = tex.reshape(-1)

    def at(j, i):
        return flat[j * n + i]

    return ((1 - fv) * ((1 - fu) * at(j0, i0) + fu * at(j0, i1))
            + fv * ((1 - fu) * at(j1, i0) + fu * at(j1, i1)))


def _planes(draws, f, n=1024, texture=_texture):
    """(anchor, normal, u_axis, v_axis, half_extent or None, texture,
    texel) per plane; geometry on the host, textures on the device."""
    specs = [
        ((0.0, 0.0, 12.0), _rot([0, 1, 0], 0.25) @ np.array([0, 0, -1.0]), None),
        ((0.0, 1.6, 7.0), np.array([0.0, -1.0, 0.0]), (6.0, 6.0)),
        ((-1.3, -0.3, 7.0), _rot([0, 1, 0], -0.5) @ np.array([0, 0, -1.0]),
         (1.6, 1.6)),
        ((1.1, -0.4, 4.5), _rot([1, 0.3, 0], 0.35) @ np.array([0, 0, -1.0]),
         (0.9, 0.8)),
    ]
    planes = []
    for anchor, normal, extent in specs:
        anchor = np.asarray(anchor)
        normal = normal / np.linalg.norm(normal)
        up = [0.0, 0.0, 1.0] if abs(normal[1]) > 0.9 else [0.0, 1.0, 0.0]
        u_axis = np.cross(up, normal)
        u_axis /= np.linalg.norm(u_axis)
        v_axis = np.cross(normal, u_axis)
        texel = anchor[2] / f
        planes.append((anchor, normal, u_axis, v_axis, extent,
                       texture(draws, n), texel))
    return planes


def _render(planes, K, R, t, H, W, device):
    """Ray-cast the planes from camera (R, t) (numpy float64): [H, W]
    float64 on ``device``."""
    dev = torch.device(device)

    def d(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    v, u = torch.meshgrid(torch.arange(H, device=dev, dtype=F64),
                          torch.arange(W, device=dev, dtype=F64), indexing="ij")
    rays_c = torch.stack([u, v, torch.ones_like(u)], -1) @ d(np.linalg.inv(K).T)
    rays = rays_c @ d(R)
    C = d(-np.asarray(R).T @ np.asarray(t))
    depth = torch.full(u.shape, math.inf, dtype=F64, device=dev)
    img = torch.zeros(u.shape, dtype=F64, device=dev)
    for anchor, normal, u_axis, v_axis, extent, tex, texel in planes:
        nrm = d(normal)
        den = rays @ nrm
        s = ((d(anchor) - C) @ nrm) / torch.where(torch.abs(den) < 1e-12,
                                                  torch.full_like(den, 1e-12), den)
        X = C + s[..., None] * rays
        a = (X - d(anchor)) @ d(u_axis)
        b = (X - d(anchor)) @ d(v_axis)
        hit = (s > 0) & (s < depth)
        if extent is not None:
            hit &= (torch.abs(a) <= extent[0]) & (torch.abs(b) <= extent[1])
        depth = torch.where(hit, s, depth)
        img = torch.where(hit, _lookup(tex, a, b, texel), img)
    return img


def _intrinsics(height, width):
    f = 1.1 * width
    return f, np.array([[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0, 0, 1.0]])


def _noisy(img, noise):
    return torch.clamp(img + 0.5 * noise.normal(tuple(img.shape)), 0, 255).to(torch.float32)


def synthetic_pair(height=576, width=720, *, scene, noise, device):
    """``scene_np.synthetic_pair``: img1, img2 ([H, W] float32 on the
    device), K, R, t (numpy float32; t unit)."""
    f, K = _intrinsics(height, width)
    planes = _planes(scene, f)
    R = _rot([0.1, 1.0, -0.05], np.deg2rad(-3.0))
    t = np.array([-0.5, 0.06, 0.12])
    img1 = _render(planes, K, np.eye(3), np.zeros(3), height, width, device)
    img2 = _render(planes, K, R, t, height, width, device)
    img1, img2 = _noisy(img1, noise), _noisy(img2, noise)
    return {"img1": img1, "img2": img2, "K": K.astype(np.float32),
            "R": R.astype(np.float32), "t": (t / np.linalg.norm(t)).astype(np.float32)}


def rotation_pair(height=960, width=1280, *, scene, noise, device):
    """``scene_np.rotation_pair``: dead-leaves planes seen from one
    centre, the second camera rotated 5 degrees; H_gt = K R K^-1."""
    f, K = _intrinsics(height, width)
    n = 64 * int(np.ceil(1.25 * max(height, width) / 64))
    planes = _planes(scene, f, n, _dead_leaves)
    R = _rot([0.3, 1.0, 0.5], np.deg2rad(5.0))
    img1 = _render(planes, K, np.eye(3), np.zeros(3), height, width, device)
    img2 = _render(planes, K, R, np.zeros(3), height, width, device)
    img1, img2 = _noisy(img1, noise), _noisy(img2, noise)
    H_gt = K @ R @ np.linalg.inv(K)
    return {"img1": img1, "img2": img2, "K": K.astype(np.float32),
            "R": R.astype(np.float32), "H_gt": (H_gt / H_gt[2, 2]).astype(np.float32)}
