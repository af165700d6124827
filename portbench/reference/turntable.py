"""The turntable ring in float64, plain PyTorch, written apart from the
port: the reference that the ring cell's tracks, pinned LM,
self-calibration, free bundle adjustment and snap are judged by.

It computes what ``reconstruct_turntable``'s rules state, from each
frame's keypoints (pixels, validity), the matches of the ring pairs,
frames 0 and 1's poses and K:

1. ring tracks: the pairs (i, i + g mod n) for g in ``gaps``, i over the
   ring (with ``wrap``; else while i + g < n), in that order; a match
   row joins its two observations where both keypoints are valid and
   they lie more than ``min_disparity_px`` apart, unless the two tracks
   hold observations of one frame (the first link wins); tracks of
   ``min_track_len`` or more observations, each in the order of its
   first observation;
2. the scale of the start: the tracks seen in frames 0 and 1,
   triangulated from those two observations at the two poses given;
   the median depth in frame 0 (8 or more needed);
3. the model: axis a (unit), a point c on it, frame 0's pose (R0, C0)
   and a direction s: R_i = R0 Rot(a, s phi_i)^T, C_i = c + Rot(a, s
   phi_i)(C0 - c), phi_i = 2 pi i / n; it starts with a = R0^T
   ``axis_hint``, c = C0 plus the depth times frame 0's viewing
   direction, less its part along a;
4. the pinned LM (``refine``): rounds of (every track triangulated from
   its kept observations, undistorted, at the model's poses: the
   least-squares point of the cross-product rows with ridge 1e-6, two
   or more observations; the observations kept where their pixel
   residual is under the prune, six times the prune in the first
   round), then ``iters`` LM steps with X held on the 8 parameters
   (a turned by two tangent angles in the frame (b1, b2, a) where b1 =
   a x e (e = x, or y where |a_x| >= 0.9), b2 = a x b1; c shifted; log
   f / f0; k1; k2, which stays 0): the Huber cost of the kept pixel
   residuals of x_n (1 + k1 r^2 + k2 r^4) f + c_K, the
   Jacobian by forward mode, the damped normal equations (G + lam
   diag(G)), a step kept where it lowers the cost, lam from 1e-3, x0.3
   or x6 within [1e-8, 1e8]; the pose deltas restart each round, the
   intrinsics carry over; after the rounds one more triangulation and
   prune, and the rms of the kept residuals; pixels undistorted by 5
   fixed-point steps of x_n = x_d / (1 + k1 r^2 + k2 r^4), the
   denominator at least 0.25 in size;
5. both directions s = +1, -1 through the anneal (Huber, prune px)
   (64, 4000), (16, 64), (4, 16) at 12 steps x 2 rounds with the
   intrinsics fixed; the one keeping more observations (+1 on a tie);
   then 15 steps x 3 rounds at (2, 8) estimating f and k1;
6. the free BA (``FREE_BA_SCHEDULE``), from the pinned LM's poses on
   the observations undistorted at its f and k1: per stage (Huber,
   prune), every track triangulated from the observations the last
   stage kept (all of them at the first stage), the observations of
   triangulated tracks within the prune of their projection kept, then
   ``ba_iters`` LM steps (``lm``) with no camera held, and the
   observations under the prune after them kept;
7. the snap (``SNAP_SCHEDULE``): the ring fitted to the free BA's poses
   (``fit``), its poses at the pinned phases, and the free BA's stages
   again from them with every observation; the steps, the total turn
   with the wrap, and the rms of the kept pixel residuals (f0 = K's).

``lm`` is ``run_ba``'s rule: the Huber cost (``delta`` in the
normalized plane) of the reprojection residuals, the camera moved by R
exp([w]x) and t + dt, the point by X + dX; the damped normal equations
(each diagonal block plus lam times its mean diagonal plus 1e-6 lam)
solved exactly; a step taken where it lowers the cost; lam from 1e-3,
x0.33 or x8 within [1e-9, 1e6].

Departures from the port, where float64 makes the exact form the
natural one: the linear solves (the LM's 8 x 8, the circle fit's 3 x 3,
the BA's reduced camera system) by ``torch.linalg.solve`` with the
points eliminated block by block (the port: a dense LU of the padded
system, or CG); masked observations are left out of the BA rather
than weighted 0; the tracks' union-find keeps each track's frames as a
set (the port: parent pointers).  Frames 0 and 1's poses come from
``reference/sequence.py``'s bootstrap (item 2 of its docstring), the
first step of its chain: the ring reads the chain only for frame 0's
pose (the identity on both sides) and for the scale of the start,
which no judged number sees.

``control=True`` computes the same one precision down from the f32
(TF32 off) the configuration states: float32 with the operands of the
products in the normal equations, the triangulations and the BA
rounded to TF32 (the pinned LM's forward-mode Jacobian stays float32).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

# (Huber px, prune px) per stage of the annealed free BA, from the
# pinned LM's poses, then after the snap.
FREE_BA_SCHEDULE = ((8.0, 64.0), (2.0, 12.0))
SNAP_SCHEDULE = ((4.0, 24.0), (2.0, 8.0))
ANNEAL = ((64.0, 4000.0), (16.0, 64.0), (4.0, 16.0))


class Arith:
    """float64, or under the control float32 with TF32 product operands,
    on ``device``."""

    def __init__(self, control: bool, device="cpu"):
        self.control = control
        self.dt = torch.float32 if control else torch.float64
        self.dev = torch.device(device)

    def t(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.dev, self.dt)
        return torch.as_tensor(np.asarray(x), dtype=self.dt, device=self.dev)

    def ein(self, spec, *ops) -> torch.Tensor:
        ops = [tf32(o) if self.control else o.to(self.dt) for o in ops]
        return torch.einsum(spec, *ops)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa (to nearest, ties
    to even)."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & -8192
    return b.view(torch.float32)


# --- rotations ---

def skew(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def rodrigues(w):
    """[..., 3] axis-angle -> [..., 3, 3]."""
    th2 = torch.sum(w * w, -1)[..., None, None]
    small = th2 < 1e-24
    th = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    K = skew(w)
    a = torch.where(small, torch.ones_like(th), torch.sin(th) / th)
    b = torch.where(small, torch.full_like(th, 0.5), (1.0 - torch.cos(th)) / (th * th))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * K + b * (K @ K)


def log_rotation(R):
    """[..., 3, 3] -> [..., 3] axis-angle, for angles away from 0 and pi."""
    cos_t = torch.clamp((torch.diagonal(R, dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0, -1, 1)
    th = torch.arccos(cos_t)
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1)
    return v * (th / (2.0 * torch.sin(th)))[..., None]


def angle_deg(R) -> np.ndarray:
    """Rotation angles [...] of R [..., 3, 3] (float64, numpy), from the
    Frobenius distance to the identity (stable near 0)."""
    R = np.asarray(R, np.float64)
    d = np.linalg.norm(R - np.eye(3), axis=(-2, -1))
    return np.degrees(2.0 * np.arcsin(np.clip(d / (2.0 * math.sqrt(2.0)), 0.0, 1.0)))


# --- tracks ---

def ring_pairs(n, gaps=(1, 2), wrap=True) -> list:
    return [(i, (i + g) % n) for g in gaps for i in range(n if wrap else n - g)]


class Tracks(NamedTuple):
    cam: np.ndarray     # [O] frame of each observation
    slot: np.ndarray    # [O] keypoint slot in its frame
    pt: np.ndarray      # [O] track
    uv: np.ndarray      # [O, 2] pixels, float64
    n: int


def build_tracks(uv, kp_valid, matches, pairs, min_disparity_px=1.5, min_len=2) -> Tracks:
    """Item 1 of the module docstring.  ``matches[(i, j)]`` = (index [K]
    into frame j's slots, valid [K])."""
    uv = np.asarray(uv, np.float64)
    kp_valid = np.asarray(kp_valid, bool)
    track_of, members, frames = {}, {}, {}
    order = []                         # nodes by first appearance

    def track(node):
        if node not in track_of:
            track_of[node] = len(order)
            members[len(order)] = [node]
            frames[len(order)] = {node[0]}
            order.append(node)
        return track_of[node]

    for i, j in pairs:
        index, valid = matches[(i, j)]
        index = np.asarray(index, np.int64)
        ok = np.asarray(valid, bool) & kp_valid[i] & kp_valid[j][index]
        ok &= np.linalg.norm(uv[i] - uv[j][index], axis=1) > min_disparity_px
        for a in np.nonzero(ok)[0]:
            ta, tb = track((i, int(a))), track((j, int(index[a])))
            if ta == tb or frames[ta] & frames[tb]:
                continue
            if len(members[ta]) < len(members[tb]):
                ta, tb = tb, ta
            for node in members[tb]:
                track_of[node] = ta
            members[ta] += members.pop(tb)
            frames[ta] |= frames.pop(tb)
    groups = {}
    for node in order:
        groups.setdefault(track_of[node], []).append(node)
    cam, slot, pt = [], [], []
    n_tracks = 0
    for nodes in groups.values():
        if len(nodes) < min_len:
            continue
        for f, s in nodes:
            cam.append(f)
            slot.append(s)
            pt.append(n_tracks)
        n_tracks += 1
    cam, slot = np.asarray(cam, np.int64), np.asarray(slot, np.int64)
    return Tracks(cam, slot, np.asarray(pt, np.int64),
                  uv[cam, slot] if len(cam) else np.zeros((0, 2)), n_tracks)


# --- geometry ---

def triangulate(A: Arith, R, t, cam, pt, uvn, mask, n_points):
    """Item 4's triangulation: (X [P, 3], ok [P])."""
    Rj, tj = R[cam], t[cam]
    u, v = uvn[:, 0:1], uvn[:, 1:2]
    m = mask.to(A.dt)
    rows = torch.stack([u * Rj[:, 2] - Rj[:, 0], v * Rj[:, 2] - Rj[:, 1]], 1) * m[:, None, None]
    rhs = -torch.stack([u[:, 0] * tj[:, 2] - tj[:, 0], v[:, 0] * tj[:, 2] - tj[:, 1]], 1) * m[:, None]
    AtA = torch.zeros((n_points, 3, 3), dtype=A.dt, device=A.dev).index_add_(
        0, pt, A.ein("oki,okj->oij", rows, rows))
    Atb = torch.zeros((n_points, 3), dtype=A.dt, device=A.dev).index_add_(
        0, pt, A.ein("oki,ok->oi", rows, rhs))
    nobs = torch.zeros((n_points,), dtype=A.dt, device=A.dev).index_add_(0, pt, m)
    X = torch.linalg.solve(AtA + 1e-6 * torch.eye(3, dtype=A.dt, device=A.dev), Atb)
    ok = (nobs >= 2) & torch.isfinite(X).all(1)
    return torch.where(ok[:, None], X, torch.zeros_like(X)), ok


def project(Xc):
    z = Xc[..., 2:3]
    z = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    return Xc[..., :2] / z


def undistort(uv, c, f, k1, k2, iters=5):
    xd = (uv - c) / f
    xn = xd
    for _ in range(iters):
        r2 = torch.sum(xn * xn, -1, keepdim=True)
        den = 1.0 + k1 * r2 + k2 * r2 * r2
        den = torch.where(den.abs() < 0.25, torch.full_like(den, 0.25), den)
        xn = xd / den
    return xn


class Model(NamedTuple):
    axis: torch.Tensor
    center: torch.Tensor
    R0: torch.Tensor
    C0: torch.Tensor
    sign: float


def basis(axis):
    e = torch.zeros(3, dtype=axis.dtype, device=axis.device)
    e[0 if abs(float(axis[0])) < 0.9 else 1] = 1.0
    b1 = torch.linalg.cross(axis, e)
    b1 = b1 / torch.linalg.vector_norm(b1)
    return b1, torch.linalg.cross(axis, b1)


def poses(model: Model, phases):
    rot = rodrigues(model.axis / torch.linalg.vector_norm(model.axis)
                    * (model.sign * phases)[:, None])
    R = model.R0 @ rot.transpose(-1, -2)
    C = model.center + torch.einsum("nij,j->ni", rot, model.C0 - model.center)
    return R, -torch.einsum("nij,nj->ni", R, C)


def moved(model: Model, p, b1, b2):
    """The model at the parameters p[:5] (item 4)."""
    d = rodrigues(torch.cat([p[:2], torch.zeros_like(p[:1])]))[:, 2]
    axis = b1 * d[0] + b2 * d[1] + model.axis * d[2]
    return model._replace(axis=axis, center=model.center + p[2:5])


def fit(A: Arith, R, t, n):
    """The ring of poses (R, t): the mean of the steps' axes, the circle
    through the centres in the plane normal to it (least squares), its
    radius scaled so the mean step's chord spans 2 pi / n, frame 0 held,
    the direction that moves C0 toward C1."""
    C = -torch.einsum("mij,mi->mj", R, t)
    rv = log_rotation(R[:-1].transpose(-1, -2) @ R[1:])
    ang = torch.linalg.vector_norm(rv, dim=1)
    axis = torch.sum(rv / ang[:, None], 0)
    axis = axis / torch.linalg.vector_norm(axis)
    th = torch.mean(ang)
    d = (C - C.mean(0)) @ axis
    P = C - d[:, None] * axis
    b1, b2 = basis(axis)
    Q = (P - P.mean(0)) @ torch.stack([b1, b2]).T
    M = torch.cat([2 * Q, torch.ones_like(Q[:, :1])], 1)
    sol = torch.linalg.solve(M.T @ M, M.T @ torch.sum(Q * Q, 1))
    rad = torch.sqrt(torch.clamp(sol[2] + sol[:2] @ sol[:2], min=1e-18))
    center = P.mean(0) + sol[0] * b1 + sol[1] * b2 + d.mean() * axis
    rad = rad * torch.sin(th / 2) / math.sin(math.pi / n)
    u = center - C[0]
    u = u - (u @ axis) * axis
    center = C[0] + u * rad / torch.linalg.vector_norm(u)
    step = [center + rodrigues(axis * s * th) @ (C[0] - center) for s in (1.0, -1.0)]
    sign = 1.0 if torch.sum((step[0] - C[1]) ** 2) <= torch.sum((step[1] - C[1]) ** 2) else -1.0
    return Model(axis, center, R[0], C[0], sign)


# --- the pinned LM ---

def refine(A: Arith, model: Model, tr: Tracks, mask, K, n, *, iters, rounds, huber, prune,
           intrinsics):
    """Item 4: (model, (f, k1, k2), R, t, X, keep, rms px)."""
    cam, pt = torch.as_tensor(tr.cam, device=A.dev), torch.as_tensor(tr.pt, device=A.dev)
    uv = A.t(tr.uv)
    K = A.t(K)
    f0 = 0.5 * (K[0, 0] + K[1, 1])
    c = torch.stack([K[0, 2], K[1, 2]])
    phases = (2.0 * math.pi / n) * torch.arange(n, dtype=A.dt, device=A.dev)
    free = torch.ones(8, dtype=A.dt, device=A.dev)
    free[7] = 0.0
    if not intrinsics:
        free[5:] = 0.0

    def residuals(p, X, base, b1, b2):
        R, t = poses(moved(base, p, b1, b2), phases)
        xn = project(torch.einsum("oij,oj->oi", R[cam], X[pt]) + t[cam])
        r2 = torch.sum(xn * xn, -1, keepdim=True)
        f = f0 * torch.exp(p[5:6])
        return xn * (1.0 + p[6:7] * r2 + p[7:8] * r2 * r2) * f + c - uv

    jac = torch.func.jacfwd(residuals)

    def cost(p, X, base, b1, b2, keep):
        rn = torch.sqrt(torch.clamp(torch.sum(residuals(p, X, base, b1, b2) ** 2, 1),
                                    min=1e-24))
        h = torch.where(rn <= huber, 0.5 * rn * rn, huber * (rn - 0.5 * huber))
        return torch.sum(h * keep)

    def observed(q, base, keep, thr):
        b1, b2 = basis(base.axis)
        R, t = poses(base, phases)
        f = f0 * torch.exp(q[5])
        X, ok = triangulate(A, R, t, cam, pt, undistort(uv, c, f, q[6], q[7]), keep, tr.n)
        rn = torch.linalg.vector_norm(residuals(torch.cat([torch.zeros_like(q[:5]), q[5:]]),
                                                X, base, b1, b2), dim=1)
        return R, t, X, mask & ok[pt] & (rn < thr), rn

    base, q, keep = model, torch.zeros(8, dtype=A.dt, device=A.dev), mask
    for k in range(rounds):
        _, _, X, keep, _ = observed(q, base, keep, 6.0 * prune if k == 0 else prune)
        b1, b2 = basis(base.axis)
        p = torch.cat([torch.zeros_like(q[:5]), q[5:]])
        lam = 1e-3
        c0 = cost(p, X, base, b1, b2, keep)
        for _ in range(iters):
            r = residuals(p, X, base, b1, b2)
            J = jac(p, X, base, b1, b2) * free
            rn2 = torch.sum(r * r, 1)
            w = torch.where(rn2 <= huber * huber, torch.ones_like(rn2),
                            huber / torch.sqrt(torch.clamp(rn2, min=1e-24))) * keep
            G = A.ein("oki,okj->ij", J * w[:, None, None], J) + torch.diag(1.0 - free)
            g = A.ein("oki,ok->i", J * w[:, None, None], r)
            D = torch.diag(torch.clamp(torch.diagonal(G), min=1e-12))
            dp = -torch.linalg.solve(G + lam * D, g) * free
            dp = torch.where(torch.isfinite(dp), dp, torch.zeros_like(dp))
            c1 = cost(p + dp, X, base, b1, b2, keep)
            if c1 < c0:
                p, c0, lam = p + dp, c1, max(lam * 0.3, 1e-8)
            else:
                lam = min(lam * 6.0, 1e8)
        base = moved(base, p, b1, b2)
        q = torch.cat([torch.zeros_like(p[:5]), p[5:]])
    R, t, X, kept, rn = observed(q, base, keep, prune)
    keep = keep & kept
    rms = torch.sqrt(torch.sum(rn * rn * keep) / max(int(keep.sum()), 1))
    return base, (f0 * torch.exp(q[5]), q[6], q[7]), R, t, X, keep, float(rms)


# --- the free BA ---

def lm(A: Arith, R, t, X, cam, pt, uv, delta, iters, lam=1e-3):
    """``run_ba``'s LM (module docstring) over the observations (cam, pt,
    uv normalized), no camera held.  Returns (R, t, X, costs)."""
    M, P = R.shape[0], X.shape[0]
    eye3 = torch.eye(3, dtype=A.dt, device=A.dev)
    eye6 = torch.eye(6, dtype=A.dt, device=A.dev)

    def residuals(R, t, X):
        return project(torch.einsum("oij,oj->oi", R[cam], X[pt]) + t[cam]) - uv

    def cost(R, t, X):
        rn = torch.sqrt(torch.clamp(torch.sum(residuals(R, t, X) ** 2, 1), min=1e-24))
        return float(torch.sum(torch.where(rn <= delta, 0.5 * rn * rn,
                                           delta * (rn - 0.5 * delta))))

    c = cost(R, t, X)
    costs = [c]
    for _ in range(iters):
        Rc, Xp = R[cam], X[pt]
        Xc = torch.einsum("oij,oj->oi", Rc, Xp) + t[cam]
        r = project(Xc) - uv
        z = torch.where(Xc[:, 2].abs() < 1e-8, torch.full_like(Xc[:, 2], 1e-8), Xc[:, 2])
        live = (Xc[:, 2].abs() >= 1e-8).to(A.dt)
        o = torch.zeros_like(z)
        Pj = torch.stack([torch.stack([1 / z, o, -Xc[:, 0] / z ** 2 * live], -1),
                          torch.stack([o, 1 / z, -Xc[:, 1] / z ** 2 * live], -1)], 1)
        Jc = torch.cat([-A.ein("oab,obk->oak", Pj, Rc @ skew(Xp)), Pj], -1)   # [O, 2, 6]
        Jp = A.ein("oab,obk->oak", Pj, Rc)                                      # [O, 2, 3]
        rn = torch.sqrt(torch.clamp(torch.sum(r * r, 1), min=1e-24))
        w = torch.where(rn <= delta, torch.ones_like(rn), delta / rn)[:, None, None]
        U = torch.zeros((M, 6, 6), dtype=A.dt, device=A.dev).index_add_(
            0, cam, A.ein("oai,oaj->oij", Jc * w, Jc))
        V = torch.zeros((P, 3, 3), dtype=A.dt, device=A.dev).index_add_(
            0, pt, A.ein("oai,oaj->oij", Jp * w, Jp))
        gc = torch.zeros((M, 6), dtype=A.dt, device=A.dev).index_add_(
            0, cam, A.ein("oai,oa->oi", Jc * w, r))
        gp = torch.zeros((P, 3), dtype=A.dt, device=A.dev).index_add_(
            0, pt, A.ein("oai,oa->oi", Jp * w, r))
        W = torch.zeros((P * M, 6, 3), dtype=A.dt, device=A.dev).index_add_(
            0, pt * M + cam, A.ein("oai,oaj->oij", Jc * w, Jp)).reshape(P, M, 6, 3)
        trU = torch.diagonal(U, dim1=1, dim2=2).sum(-1)
        trV = torch.diagonal(V, dim1=1, dim2=2).sum(-1)
        Ud = U + lam * (trU / 6.0 + 1e-6)[:, None, None] * eye6
        Vi = torch.linalg.inv(V + lam * (trV / 3.0 + 1e-6)[:, None, None] * eye3)
        B = A.ein("pmix,pxy->pmiy", W, Vi)
        S = -A.ein("pmiy,pnjy->minj", B, W).reshape(6 * M, 6 * M) + torch.block_diag(*Ud)
        rhs = (gc - A.ein("pmiy,py->mi", B, gp)).reshape(-1)
        dc = -torch.linalg.solve(S, rhs).reshape(M, 6)
        dp = -A.ein("pxy,py->px", Vi, gp + A.ein("pmiy,mi->py", W, dc))
        Rn = R @ rodrigues(dc[:, :3])
        tn, Xn = t + dc[:, 3:], X + dp
        cn = cost(Rn, tn, Xn)
        if cn < c:
            R, t, X, c = Rn, tn, Xn, cn
            lam = max(lam * 0.33, 1e-9)
        else:
            lam = min(lam * 8.0, 1e6)
        costs.append(c)
    return R, t, X, costs


def _resid_px(R, t, X, cam, pt, uvn, f0):
    return torch.linalg.vector_norm(
        project(torch.einsum("oij,oj->oi", R[cam], X[pt]) + t[cam]) - uvn, dim=1) * f0


def free_ba(A: Arith, R, t, tr: Tracks, uvn, f0, schedule, iters):
    """Item 6: (R, t, X, keep, residual px, the last stage's observations)."""
    cam, pt = torch.as_tensor(tr.cam, device=A.dev), torch.as_tensor(tr.pt, device=A.dev)
    keep = torch.ones(len(tr.cam), dtype=torch.bool, device=A.dev)
    for hub, pru in schedule:
        X, ok = triangulate(A, R, t, cam, pt, uvn, keep, tr.n)
        okm = ok[pt]
        obs = okm & (_resid_px(R, t, X, cam, pt, uvn, f0) < pru)
        sel = torch.nonzero(obs).flatten()
        ids, sub = torch.unique(pt[sel], return_inverse=True)
        Rn, tn, Xs, _ = lm(A, R, t, X[ids], cam[sel], sub, uvn[sel], hub / f0, iters)
        R, t, X = Rn, tn, X.index_copy(0, ids, Xs)
        r = _resid_px(R, t, X, cam, pt, uvn, f0)
        keep = okm & (r < pru)
    return R, t, X, keep, r, obs


class Ring(NamedTuple):
    R: np.ndarray            # [n, 3, 3]
    t: np.ndarray            # [n, 3]
    X: np.ndarray            # [P, 3]
    f: float
    k1: float
    k2: float
    keep: np.ndarray         # [O] the kept observations
    tracks: Tracks
    rms_px: float
    step_deg: np.ndarray     # [n - 1]
    total_deg: float
    ba_obs: np.ndarray       # [O] the last LM's observations
    sign: float


def start_poses(uv, kp_valid, matches, K, cfg, draw, control=False):
    """Frames 0 and 1's poses (R [2, 3, 3], t [2, 3], float64 numpy) by
    ``reference/sequence.py``'s bootstrap on the pair (0, 1) with the
    minimal sets ``draw`` gives."""
    from portbench.reference import sequence

    A = sequence.Arith(control)
    uv = np.asarray(uv, np.float64)
    kp_valid = np.asarray(kp_valid, bool)
    index, valid = matches[(0, 1)]
    index = np.asarray(index, np.int64)
    ok = np.asarray(valid, bool) & kp_valid[0] & kp_valid[1][index]
    sel = ok & (np.sum((uv[0] - uv[1][index]) ** 2, 1) > cfg.ransac.min_disparity_px ** 2)
    x = sequence.normalized(uv[:2], K, A)
    m = sequence._Map(A, 2, uv.shape[1], uv.shape[1])
    sequence._bootstrap(A, m, x[0], x[1][torch.as_tensor(index)], index, sel, draw, cfg)
    return m.R.detach().numpy().astype(np.float64), m.t.detach().numpy().astype(np.float64)


def run(uv, kp_valid, matches, R01, t01, K, *, gaps=(1, 2), wrap=True, ba_iters=20,
        snap_rounds=1, axis_hint=(0.0, 1.0, 0.0), min_track_len=2, min_disparity_px=1.5,
        control=False, device="cpu") -> Ring:
    """The ring of frames with keypoints ``uv`` [n, K, 2] (pixels) and
    ``kp_valid`` [n, K], the matches ``matches[(i, j)]`` of its ring
    pairs, frames 0 and 1's poses (R01, t01) and K (module docstring)."""
    A = Arith(control, device)
    n = len(uv)
    tr = build_tracks(uv, kp_valid, matches, ring_pairs(n, gaps, wrap), min_disparity_px,
                      min_track_len)
    Kd = np.asarray(K, np.float64)
    f0 = 0.5 * (Kd[0, 0] + Kd[1, 1])
    c = A.t(Kd[:2, 2])
    cam = torch.as_tensor(tr.cam, device=A.dev)
    pt = torch.as_tensor(tr.pt, device=A.dev)
    uvn0 = (A.t(tr.uv) - c) / f0
    mask = torch.ones(len(tr.cam), dtype=torch.bool, device=A.dev)

    # Item 2: the start's scale.
    both = np.intersect1d(tr.pt[tr.cam == 0], tr.pt[tr.cam == 1])
    sel = torch.as_tensor(np.isin(tr.pt, both) & (tr.cam <= 1), device=A.dev)
    X01, ok01 = triangulate(A, A.t(R01), A.t(t01), cam.clamp(max=1), pt, uvn0, sel, tr.n)
    seen = torch.as_tensor(both, device=A.dev)
    seen = seen[ok01[seen]]
    if len(seen) < 8:
        raise ValueError(f"only {len(seen)} tracks of frames 0 and 1 triangulated")
    R0, t0 = A.t(R01[0]), A.t(t01[0])
    depth = float(np.median((X01[seen] @ R0.T + t0)[:, 2].cpu().numpy()))
    C0 = -R0.T @ t0
    axis = R0.T @ A.t(axis_hint)
    axis = axis / torch.linalg.vector_norm(axis)
    u = depth * R0.T[:, 2]
    centre = C0 + u - (u @ axis) * axis

    # Item 5: both directions through the anneal, then self-calibration.
    best = None
    for sign in (1.0, -1.0):
        model = Model(axis, centre, R0, C0, sign)
        for hub, pru in ANNEAL:
            model, _, _, _, _, keep, _ = refine(A, model, tr, mask, Kd, n, iters=12, rounds=2,
                                                huber=hub, prune=pru, intrinsics=False)
        if best is None or int(keep.sum()) > best[0]:
            best = (int(keep.sum()), model)
    model, (f, k1, k2), R, t, _, _, _ = refine(A, best[1], tr, mask, Kd, n, iters=15,
                                               rounds=3, huber=2.0, prune=8.0,
                                               intrinsics=True)

    # Items 6-7: the free BA, the snap.
    uvn = undistort(A.t(tr.uv), c, f, k1, k2)
    R, t, X, keep, r, obs = free_ba(A, R, t, tr, uvn, f0, FREE_BA_SCHEDULE, ba_iters)
    phases = (2.0 * math.pi / n) * torch.arange(n, dtype=A.dt, device=A.dev)
    for _ in range(snap_rounds):
        R, t = poses(fit(A, R, t, n), phases)
        R, t, X, keep, r, obs = free_ba(A, R, t, tr, uvn, f0, SNAP_SCHEDULE, ba_iters)

    def host(x):
        return x.detach().cpu().numpy().astype(np.float64)

    Rh = host(R)
    steps = angle_deg(Rh[1:] @ np.swapaxes(Rh[:-1], 1, 2))
    wrap_deg = float(angle_deg(Rh[0] @ Rh[-1].T))
    keep_h = host(keep).astype(bool)
    rh = host(r)
    rms = float(np.sqrt(np.mean(rh[keep_h] ** 2))) if keep_h.any() else 0.0
    return Ring(R=Rh, t=host(t), X=host(X), f=float(f), k1=float(k1), k2=float(k2),
                keep=keep_h, tracks=tr, rms_px=rms, step_deg=steps,
                total_deg=float(steps.sum()) + wrap_deg, ba_obs=host(obs).astype(bool),
                sign=best[1].sign)


# --- the judged numbers' pieces ---

def canonical(R, t, X):
    """(R, t, X) in the gauge where frame 0's pose is the identity and the
    other frames' offsets t_i - R_i R_0^-1 t_0 (|C_i - C_0| for a rotation)
    have rms 1, rounded to float32 (the port's precision): the same for
    every similarity transform of the input, its rotations float32's
    near-rotations included, but where a value sits within float64's
    rounding of a float32 tie."""
    R, t, X = (np.asarray(a, np.float64) for a in (R, t, X))
    R0inv = np.linalg.inv(R[0])
    Rn = R @ R0inv
    off = t - np.einsum("mij,j->mi", Rn, t[0])
    s = 1.0 / max(math.sqrt(np.mean(np.sum(off ** 2, 1))), 1e-300)
    Xn = s * (X @ R[0].T + t[0])
    return tuple(a.astype(np.float32).astype(np.float64) for a in (Rn, s * off, Xn))


def _camera_decrements(A: Arith, R, t, X, cam, pt, uv, delta):
    """Per camera, the cost that one Gauss-Newton step of that camera
    alone (its points held) would take off: 1/2 g^T U^-1 g of its Huber-
    weighted blocks."""
    Rc, Xp = R[cam], X[pt]
    Xc = torch.einsum("oij,oj->oi", Rc, Xp) + t[cam]
    r = project(Xc) - uv
    z = torch.where(Xc[:, 2].abs() < 1e-8, torch.full_like(Xc[:, 2], 1e-8), Xc[:, 2])
    o = torch.zeros_like(z)
    Pj = torch.stack([torch.stack([1 / z, o, -Xc[:, 0] / z ** 2], -1),
                      torch.stack([o, 1 / z, -Xc[:, 1] / z ** 2], -1)], 1)
    Jc = torch.cat([-A.ein("oab,obk->oak", Pj, Rc @ skew(Xp)), Pj], -1)
    rn = torch.sqrt(torch.clamp(torch.sum(r * r, 1), min=1e-24))
    w = torch.where(rn <= delta, torch.ones_like(rn), delta / rn)[:, None, None]
    M = R.shape[0]
    U = torch.zeros((M, 6, 6), dtype=A.dt).index_add_(0, cam, A.ein("oai,oaj->oij", Jc * w, Jc))
    g = torch.zeros((M, 6), dtype=A.dt).index_add_(0, cam, A.ein("oai,oa->oi", Jc * w, r))
    step = torch.linalg.solve(U + 1e-12 * torch.eye(6, dtype=A.dt), g)
    return 0.5 * torch.sum(g * step, 1)


def ba_descent(R, t, X, tracks: Tracks, obs, f, k1, k2, K, delta, iters=5) -> tuple:
    """From (R, t, X) in the ``canonical`` gauge, over the observations
    ``obs`` undistorted at (f, k1, k2) and their Huber cost: (the relative
    cost drop of ``iters`` float64 LM steps, ``lm`` with no camera held;
    the largest cost one camera's own Gauss-Newton step would take off,
    its points held, over the mean frame's cost).  The second sees one
    frame's fault that the first spreads over the ring and that the
    ring's slow valley, which moves every camera and point together,
    does not reach."""
    A = Arith(False)
    obs = np.asarray(obs, bool)
    if not obs.any():
        return math.inf, math.inf
    Rc, tc, Xc = canonical(R, t, X)
    Kd = np.asarray(K, np.float64)
    uvn = undistort(A.t(tracks.uv[obs]), A.t(Kd[:2, 2]), f, k1, k2)
    ids, sub = np.unique(tracks.pt[obs], return_inverse=True)
    cam, pt = torch.as_tensor(tracks.cam[obs]), torch.as_tensor(sub.reshape(-1))
    R0, t0, X0 = A.t(Rc), A.t(tc), A.t(Xc[ids])
    _, _, _, costs = lm(A, R0, t0, X0, cam, pt, uvn, delta, iters)
    frame = _camera_decrements(A, R0, t0, X0, cam, pt, uvn, delta).max() * len(Rc) / costs[0]
    return (costs[0] - costs[-1]) / max(costs[0], 1e-300), float(frame)


def aligned_rotation_gaps(Rg, Rr) -> tuple:
    """Per frame, the angle (deg) between R_got Q^T and R_ref, where Q is
    the rotation nearest the chordal mean of R_ref_i^T R_got_i (the
    world rotation that best maps one side's frames onto the other's);
    and the same angles without it."""
    Rg, Rr = np.asarray(Rg, np.float64), np.asarray(Rr, np.float64)
    U, _, Vt = np.linalg.svd(np.einsum("nji,njk->ik", Rr, Rg))
    Q = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
    after = angle_deg(Rg @ Q.T @ np.swapaxes(Rr, 1, 2))
    before = angle_deg(Rg @ np.swapaxes(Rr, 1, 2))
    return after, before, Q


def step_gaps(Rg, Rr) -> np.ndarray:
    """Per step i (i - 1 -> i, the wrap 35 -> 0 first), the angle (deg)
    between the two sides' relative rotations R_i R_{i-1}^T."""
    Rg, Rr = np.asarray(Rg, np.float64), np.asarray(Rr, np.float64)
    rel = lambda R: R @ np.swapaxes(np.roll(R, 1, 0), 1, 2)   # noqa: E731
    return angle_deg(rel(Rg) @ np.swapaxes(rel(Rr), 1, 2))


def centre_gaps(Rg, tg, Rr, tr_) -> np.ndarray:
    """Per frame, the distance between the camera centres after the
    least-squares similarity maps the judged ones onto the reference's,
    over the reference ring's rms radius about its mean."""
    Cg = -np.einsum("mji,mj->mi", np.asarray(Rg, np.float64), np.asarray(tg, np.float64))
    Cr = -np.einsum("mji,mj->mi", np.asarray(Rr, np.float64), np.asarray(tr_, np.float64))
    a, b = Cg - Cg.mean(0), Cr - Cr.mean(0)
    U, S, Vt = np.linalg.svd(b.T @ a)
    D = np.diag([1.0, 1.0, np.linalg.det(U @ Vt)])
    Q = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / max(np.sum(a * a), 1e-300)
    spread = math.sqrt(np.mean(np.sum(b * b, 1)))
    return np.linalg.norm(s * a @ Q.T - b, axis=1) / max(spread, 1e-300)
