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

Imports neither jax nor torch, so the JAX tests, the port's tests and
the GPU smoke run share it.
"""

from __future__ import annotations

import numpy as np


def _rot(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * (Kx @ Kx)


def _texture(rng, n=1024):
    """[n, n] noise texture in 0..255 with blobs at 3 scales (texels)."""
    f = np.fft.fftfreq(n)
    f2 = f[:, None] ** 2 + f[None, :] ** 2
    out = np.zeros((n, n))
    for sigma, weight in ((1.6, 1.0), (3.5, 0.8), (8.0, 0.6)):
        spec = np.fft.fft2(rng.normal(size=(n, n)))
        band = np.real(np.fft.ifft2(spec * np.exp(-2 * np.pi ** 2 * sigma ** 2 * f2)))
        out += weight * band / band.std()
    out = out / out.std()
    return np.clip(128.0 + 45.0 * out, 0.0, 255.0)


def _dead_leaves(rng, n=1024, rmin=4.0):
    """[n, n] dead-leaves texture in 0..255: opaque shapes of random grey
    levels painted over each other (later ones on top), half rotated
    rectangles and half ellipses of aspect 0.3-1, radii in texels drawn
    with density ~ 1/r^2 on [rmin, n / 12], wrapping at the border, ~7
    layers deep on average (E[r^2] = rmin * rmax).  Their corners,
    T-junctions and occluding edges give SIFT descriptors far more
    distinct than blob noise does."""
    rmax = n / 12.0
    count = int(3 * n * n / (rmin * rmax))
    r = rmin / (1.0 - rng.random(count) * (1.0 - rmin / rmax))
    cx, cy = rng.random((2, count)) * n
    theta = rng.random(count) * np.pi
    aspect = 0.3 + 0.7 * rng.random(count)
    level = rng.normal(size=count)
    rect = rng.random(count) < 0.5
    out = np.zeros((n, n))
    for i in range(count):
        e = int(np.ceil(r[i])) + 1
        x0, y0 = int(cx[i]) - e, int(cy[i]) - e
        yy, xx = np.mgrid[y0:y0 + 2 * e + 1, x0:x0 + 2 * e + 1]
        dx, dy = xx + 0.5 - cx[i], yy + 0.5 - cy[i]
        c, s = np.cos(theta[i]), np.sin(theta[i])
        u, v = c * dx + s * dy, (c * dy - s * dx) / aspect[i]
        inside = (np.maximum(np.abs(u), np.abs(v)) <= r[i] if rect[i]
                  else u * u + v * v <= r[i] ** 2)
        out[yy[inside] % n, xx[inside] % n] = level[i]
    # Anti-alias the edges (sigma 0.7 texel).
    f = np.fft.fftfreq(n)
    f2 = f[:, None] ** 2 + f[None, :] ** 2
    out = np.real(np.fft.ifft2(np.fft.fft2(out) * np.exp(-2 * np.pi ** 2 * 0.49 * f2)))
    out = out / out.std()
    return np.clip(128.0 + 45.0 * out, 0.0, 255.0)


def _lookup(tex, a, b, texel):
    """Bilinear texture lookup at plane coords (a, b) in world units;
    the texture is centred on the plane's anchor point and wraps."""
    n = tex.shape[0]
    u = a / texel + n / 2
    v = b / texel + n / 2
    u0 = np.floor(u)
    v0 = np.floor(v)
    fu = u - u0
    fv = v - v0
    i0 = u0.astype(np.int64) % n
    j0 = v0.astype(np.int64) % n
    i1 = (i0 + 1) % n
    j1 = (j0 + 1) % n
    return ((1 - fv) * ((1 - fu) * tex[j0, i0] + fu * tex[j0, i1])
            + fv * ((1 - fu) * tex[j1, i0] + fu * tex[j1, i1]))


def _planes(rng, f, n=1024, texture=_texture):
    """(anchor, normal, u_axis, v_axis, half_extent or None, texture,
    texel) per plane; the texel is ~1 px at the plane's depth and the
    textures are n x n (``texture(rng, n)``)."""
    specs = [
        # background: everywhere, tilted about y
        ((0.0, 0.0, 12.0), _rot([0, 1, 0], 0.25) @ np.array([0, 0, -1.0]), None),
        # floor below the cameras: depth grows continuously up the image
        ((0.0, 1.6, 7.0), np.array([0.0, -1.0, 0.0]), (6.0, 6.0)),
        # middle slab on the left
        ((-1.3, -0.3, 7.0), _rot([0, 1, 0], -0.5) @ np.array([0, 0, -1.0]),
         (1.6, 1.6)),
        # near plane on the right
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
                       texture(rng, n), texel))
    return planes


def _cast(planes, K, R, t, u, v):
    """Ray-cast the planes from camera (R, t) through pixels (u, v):
    (intensity, world point of the nearest hit [..., 3]), float64."""
    rays_c = np.stack([u, v, np.ones_like(u)], -1) @ np.linalg.inv(K).T
    rays = rays_c @ R                   # camera -> world: R^T d
    C = -R.T @ t
    depth = np.full(u.shape, np.inf)
    img = np.zeros(u.shape)
    point = np.zeros(u.shape + (3,))
    for anchor, normal, u_axis, v_axis, extent, tex, texel in planes:
        den = rays @ normal
        s = ((anchor - C) @ normal) / np.where(np.abs(den) < 1e-12, 1e-12, den)
        X = C + s[..., None] * rays
        a = (X - anchor) @ u_axis
        b = (X - anchor) @ v_axis
        hit = (s > 0) & (s < depth)
        if extent is not None:
            hit &= (np.abs(a) <= extent[0]) & (np.abs(b) <= extent[1])
        depth = np.where(hit, s, depth)
        img = np.where(hit, _lookup(tex, a, b, texel), img)
        point = np.where(hit[..., None], X, point)
    return img, point


def _render(planes, K, R, t, H, W):
    """Ray-cast the planes from camera (R, t): [H, W] float64."""
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    return _cast(planes, K, R, t, u, v)[0]


def synthetic_pair(height: int = 576, width: int = 720, seed: int = 0):
    """Render the pair.  Returns dict with img1, img2 ([H, W] float32,
    0..255), K [3, 3], R [3, 3], t [3] (unit; X2 = R X1 + t up to the
    scale of t) as float32 arrays."""
    rng = np.random.default_rng(seed)
    f = 1.1 * width
    K = np.array([[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0, 0, 1.0]])
    planes = _planes(rng, f)
    R = _rot([0.1, 1.0, -0.05], np.deg2rad(-3.0))
    t = np.array([-0.5, 0.06, 0.12])
    img1 = _render(planes, K, np.eye(3), np.zeros(3), height, width)
    img2 = _render(planes, K, R, t, height, width)
    noise = np.random.default_rng(seed + 1)
    img1 = np.clip(img1 + noise.normal(scale=0.5, size=img1.shape), 0, 255)
    img2 = np.clip(img2 + noise.normal(scale=0.5, size=img2.shape), 0, 255)
    out = {"img1": img1, "img2": img2, "K": K, "R": R,
           "t": t / np.linalg.norm(t)}
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def rotation_pair(height: int = 960, width: int = 1280, seed: int = 0,
                  with_scene: bool = False):
    """The same planes, with dead-leaves textures (``_dead_leaves``), seen
    twice from ONE camera centre (t = 0), the second camera rotated by 5
    degrees (mostly yaw, some roll), so the two views are related by the
    exact homography H_gt = K R K^-1 (x2 ~ H_gt x1 in pixels) at every
    depth.  Returns dict with img1, img2 ([H, W] float32, 0..255, with
    the same 0.5-level noise as ``synthetic_pair``), K, R and H_gt
    (H_gt[2, 2] = 1) as float32;
    ``with_scene`` adds the scene in float64 ("scene": planes, K, R,
    for ``_cast``)."""
    rng = np.random.default_rng(seed)
    f = 1.1 * width
    K = np.array([[f, 0.0, width / 2.0], [0.0, f, height / 2.0], [0, 0, 1.0]])
    # Textures wide enough not to repeat across the view.
    n = 64 * int(np.ceil(1.25 * max(height, width) / 64))
    planes = _planes(rng, f, n, _dead_leaves)
    R = _rot([0.3, 1.0, 0.5], np.deg2rad(5.0))
    img1 = _render(planes, K, np.eye(3), np.zeros(3), height, width)
    img2 = _render(planes, K, R, np.zeros(3), height, width)
    noise = np.random.default_rng(seed + 1)
    img1 = np.clip(img1 + noise.normal(scale=0.5, size=img1.shape), 0, 255)
    img2 = np.clip(img2 + noise.normal(scale=0.5, size=img2.shape), 0, 255)
    H_gt = K @ R @ np.linalg.inv(K)
    out = {"img1": img1, "img2": img2, "K": K, "R": R, "H_gt": H_gt / H_gt[2, 2]}
    out = {k: np.asarray(v, np.float32) for k, v in out.items()}
    if with_scene:
        out["scene"] = (planes, K, R)
    return out


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


def write_pgm(path, img):
    """Write an [H, W] 0..255 float image as an 8-bit binary PGM (P5),
    rounded to the nearest level: the form the command-line drivers of
    both packages read."""
    a = np.clip(np.rint(np.asarray(img, np.float64)), 0, 255).astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(b"P5\n%d %d\n255\n" % (a.shape[1], a.shape[0]))
        fh.write(a.tobytes())
