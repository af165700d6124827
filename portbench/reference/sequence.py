"""Incremental multi-view reconstruction in float64, plain PyTorch on the
CPU, written apart from the port: the reference that the sequence
cell's registration, tracks, closure and bundle adjustment are judged
by.  The bootstrap's two-view pieces are ``reference/geometry.py``'s
(float64 NumPy).

It computes what ``run_incremental``'s settings state, from each
frame's keypoints (pixels, validity), the matches of the pairs the
sequence uses and K, with the RANSAC minimal sets given by a callable
per frame (the rows' valid mask -> indices), called where the draw is:

1. rays x = K^-1 [u, v, 1]; a map of ``pt_capacity`` = frames x slots
   // 4 point slots (a point past it is not made), a pose and a
   point-id table row per frame;
2. the bootstrap on frames (0, 1): the rows the matcher keeps with a
   disparity over ``min_disparity_px``; the 8-point bank of the minimal
   sets (Hartley-normalized, the SVD null vector, singular values
   (1, 1, 0)), counted by the symmetric squared epipolar distance under
   ``threshold``; the first with the most, refit ``refit_iters`` times
   by the least-squares 8-point solution over its inliers while that
   keeps at least as many; the branch of that E with most inliers in
   front of both cameras (DLT); ``refine_iters`` LM steps over the
   inliers (``geometry.refine_pose``); the branch of the refined E with
   most inliers in front; every inlier triangulated (DLT) and kept
   where finite and in front of both;
3. frame i against the ``n_back`` frames before it, nearest first
   (the list padded with the farthest and no matches): the rows are
   every previous frame's matched slots whose point exists, in frame
   order, with the current frame's rays; PnP with ``threshold * 4``:
   the points centred and scaled by their mean distance; the 6-point
   DLT of every minimal set (the least eigenvector, its sign by the
   determinant of the left 3 x 3, that block's mean singular value as
   scale, its nearest rotation), each counted by the rows whose
   squared reprojection error in the normalized plane is under the
   gate (in front of the camera); the first with the most; the nearest
   frame's pose instead where it counts more at a 16x gate; three LO
   rounds at gates 16, 4 and 4 x: the support of the incumbent at that
   gate polishes it (``pnp_refine``: 8 LM steps on the Huber cost,
   delta 3e-3, of the reprojection errors) and is refit by the weighted
   DLT then polished, the refit kept where it counts at least as many,
   and the better of the two replaces the incumbent where it counts
   strictly more; the inliers under the gate; the pose kept where 12
   or more;
4. the current frame's point ids: each inlier row's point, the
   farthest previous frame first so that a nearer one overwrites, the
   last row of a frame winning a slot; fresh points from the nearest
   frame's matched slots with no point: triangulated between the two
   poses and kept where finite, in front of both and under the gate in
   both, with ids in slot order, written to both frames' tables;
5. after each frame the windowed local BA: the observations of the
   last ``local_ba_window`` frames' cameras and every other camera's
   observations of the points those see, the window's first
   (``(window + n_back + 2) x slots`` at most, the others shed first),
   ``local_ba_iters`` LM steps with the cameras before the window, the
   first one and any unregistered one fixed; after the last frame 3 LM
   steps of the points alone over the whole map;
6. each closure pair (i, j), gated at ``threshold * 4 * 64``: a matched
   slot whose point is valid in i and not in j (or the reverse), under
   the gate in the other view, gives its id to the other frame; two
   valid different points under the gate in both merge (j's id becomes
   i's in every table, the last row winning, chains followed through;
   j's point retired); slots with no point in either are triangulated
   between the two poses as in 4;
7. LM: the Huber cost (delta 3e-3) of the reprojection residuals in the
   normalized plane, the camera moved by R exp([w]x) and t + dt, the
   point by X + dX; its damped normal equations (the diagonal blocks
   scaled by 1 + lam times the block's mean diagonal plus 1e-6 lam)
   solved exactly (the points eliminated by their 3 x 3 blocks, the
   cameras' system by a direct solve); a step taken where it lowers the
   cost; lam from 1e-3, times 0.33 after a step taken and 8 otherwise,
   within [1e-9, 1e6];
8. the global BA: ``ba_iters`` LM steps over every observation of a
   valid point in a registered frame; observations pruned at 25 x the
   median squared residual; a point left with fewer than 2 observations
   triangulated again from all of its observations (least squares of
   the cross-product rows, ridge 1e-6) and taken, with the observations
   under the gate against it, where 2 or more are; ``ba_iters // 2``
   (at least 5) more LM steps over the kept observations; their mean
   squared residual.

Departures from the port, where the float64 arithmetic makes the exact
form the natural one: null vectors and least eigenvectors by
``eigh`` / ``svd`` (the port: Gram-Jacobi sweeps and inverse
iteration), the nearest rotation and the singular values by ``svd``,
and the LM solve by an exact elimination with no padding slots.

``control=True`` computes the same one precision down from the f32
(TF32 off) that the configuration states: float32 arithmetic with the
operands of every matrix product rounded to TF32 (``geometry.tf32``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference import geometry as g2

HUBER = 3e-3


class Sequence(NamedTuple):
    R: np.ndarray            # [M, 3, 3] world -> camera
    t: np.ndarray            # [M, 3]
    pose_valid: np.ndarray   # [M] bool
    X: np.ndarray            # [P, 3]
    X_valid: np.ndarray      # [P] bool
    point_id: np.ndarray     # [M, K] int64, -1 = no point
    kept: np.ndarray         # [M * K] bool: the global BA's last observations
    mean_reproj: float
    ba_costs: list


class Arith:
    """float64, or under the control float32 with TF32 product operands."""

    def __init__(self, control: bool):
        self.control = control
        self.dt = torch.float32 if control else torch.float64
        self.np = g2._Arith(control)

    def t(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=self.dt)

    def ein(self, spec, *ops) -> torch.Tensor:
        if self.control:
            ops = [torch.from_numpy(g2.tf32(o.detach().numpy())) for o in ops]
        else:
            ops = [o.to(self.dt) for o in ops]
        return torch.einsum(spec, *ops)


# --- integer bookkeeping (numpy) ---

def set_last(dst, idx, vals, keep):
    """``dst`` with ``dst[idx[n]] = vals[n]`` for every n where ``keep``;
    where several n name one slot, the largest n wins."""
    out = np.array(dst, copy=True)
    rows = np.nonzero(keep)[0]
    if len(rows):
        _, first = np.unique(idx[rows][::-1], return_index=True)
        last = rows[::-1][first]
        out[idx[last]] = vals[last]
    return out


# --- geometry in torch ---

def skew(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def rodrigues(w):
    """[..., 3] axis-angle -> [..., 3, 3]."""
    th2 = torch.sum(w * w, -1)[..., None, None]
    th = torch.sqrt(th2)
    K = skew(w)
    small = th2 < 1e-24
    a = torch.where(small, torch.ones_like(th), torch.sin(th) / torch.where(small, 1.0, th))
    b = torch.where(small, 0.5 * torch.ones_like(th),
                    (1.0 - torch.cos(th)) / torch.where(small, 1.0, th2))
    return torch.eye(3, dtype=w.dtype) + a * K + b * (K @ K)


def nearest_rotation(M):
    U, _, Vt = torch.linalg.svd(M)
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.ones(M.shape[:-1], dtype=M.dtype)
    D[..., 2] = torch.where(d == 0, torch.ones_like(d), d)
    return (U * D[..., None, :]) @ Vt


def camera_points(A: Arith, R, t, X):
    """R X + t for R [..., 3, 3], t [..., 3] against X [..., N, 3]."""
    return A.ein("...ij,...nj->...ni", R, X) + t[..., None, :]


def project(Xc):
    """(Xc[:2] / z with |z| < 1e-8 read as 1e-8, that z, whether guarded)."""
    z = Xc[..., 2]
    small = z.abs() < 1e-8
    zs = torch.where(small, torch.full_like(z, 1e-8), z)
    return Xc[..., :2] / zs[..., None], zs, small


def sq_reprojection(A: Arith, R, t, x, X):
    """[..., N] squared reprojection errors in the normalized plane of
    rays x [N, 3] and points X [N, 3]; 1e6 behind the camera."""
    Xc = camera_points(A, R, t, X)
    p, _, _ = project(Xc)
    d = torch.sum((p - x[..., :2] / x[..., 2:3]) ** 2, -1)
    return torch.where(Xc[..., 2] > 0, d, torch.full_like(d, 1e6))


def point_jacobians(A: Arith, R, X, Xc):
    """d p / d(w, dt) [N, 2, 6] and d p / dX [N, 2, 3] of p = proj(R
    exp([w]x) X + t + dt) at w = 0 (and X + dX)."""
    p, zs, small = project(Xc)
    iz = 1.0 / zs
    dz = torch.where(small, torch.zeros_like(iz), iz)
    o = torch.zeros_like(iz)
    P = torch.stack([torch.stack([iz, o, -p[..., 0] * dz], -1),
                     torch.stack([o, iz, -p[..., 1] * dz], -1)], -2)        # [N, 2, 3]
    # d(R exp([w]x) X) / dw = R [w]x X / dw = -R [X]x
    dR = -A.ein("...ij,...jk->...ik", R, skew(X))
    return (torch.cat([A.ein("nab,nbk->nak", P, dR), P], -1),
            A.ein("nab,nbk->nak", P, R.expand(P.shape[0], 3, 3)))


def huber_cost(rn2, w=None):
    rn = torch.sqrt(rn2)
    c = torch.where(rn <= HUBER, 0.5 * rn2, HUBER * (rn - 0.5 * HUBER))
    return torch.sum(c if w is None else c * w)


def huber_weight(rn2):
    rn = torch.sqrt(rn2)
    return torch.where(rn <= HUBER, torch.ones_like(rn), HUBER / torch.clamp(rn, min=1e-300))


def triangulate(A: Arith, R1, t1, R2, t2, x1, x2):
    """DLT points [N, 3] of rays x1 in camera (R1, t1) and x2 in (R2, t2):
    the least eigenvector of each 4 x 4 system's normal matrix; and
    whether each is finite (|w| * 5 > |X_h| * 1e-6)."""
    P1 = torch.cat([R1, t1[:, None]], 1)
    P2 = torch.cat([R2, t2[:, None]], 1)
    u1, u2 = x1[:, :2] / x1[:, 2:], x2[:, :2] / x2[:, 2:]
    M = torch.stack([u1[:, :1] * P1[2] - P1[0], u1[:, 1:] * P1[2] - P1[1],
                     u2[:, :1] * P2[2] - P2[0], u2[:, 1:] * P2[2] - P2[1]], 1)
    Xh = torch.linalg.eigh(A.ein("nki,nkj->nij", M, M))[1][:, :, 0]
    w = Xh[:, 3]
    finite = w.abs() * 5.0 > torch.linalg.vector_norm(Xh[:, :3], dim=1) * 1e-6
    den = torch.where(w.abs() < 1e-12, torch.where(w < 0, -1e-12, 1e-12).to(w.dtype), w)
    return Xh[:, :3] / den[:, None], finite


def depth(A: Arith, R, t, X):
    return camera_points(A, R, t, X)[..., 2]


# --- PnP ---

def pnp_dlt(A: Arith, x, X, w=None):
    """6-point (or weighted least-squares) DLT: x [..., N, 3], X [..., N, 3]
    -> (R [..., 3, 3], t [..., 3])."""
    u = x[..., 0] / x[..., 2]
    v = x[..., 1] / x[..., 2]
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)
    z = torch.zeros_like(Xh)
    rows = torch.cat([torch.cat([Xh, z, -u[..., None] * Xh], -1),
                      torch.cat([z, Xh, -v[..., None] * Xh], -1)], -2)      # [..., 2N, 12]
    if w is not None:
        rows = rows * torch.cat([w, w], -1)[..., None].sqrt()
    G = A.ein("...ni,...nj->...ij", rows, rows)
    P = torch.linalg.eigh(G)[1][..., :, 0].reshape(*G.shape[:-2], 3, 4)
    d = torch.sign(torch.linalg.det(P[..., :, :3]))
    P = P * torch.where(d == 0, torch.ones_like(d), d)[..., None, None]
    s = torch.linalg.svdvals(P[..., :, :3]).mean(-1).clamp(min=1e-12)
    return nearest_rotation(P[..., :, :3] / s[..., None, None]), P[..., :, 3] / s[..., None]


def pnp_refine(A: Arith, R, t, x, X, w, iters=8):
    """LM on the Huber cost of the reprojection residuals of rays x, points
    X, weights w, over R exp([w]x), t + dt; lam from 1e-4 times the
    normal matrix's mean diagonal, x0.33 / x8 within [1e-10, 1e4]."""
    obs = x[:, :2] / x[:, 2:]

    def residuals(R, t):
        return project(camera_points(A, R, t, X))[0] - obs

    def cost(r):
        return huber_cost(torch.sum(r * r, -1), w)

    lam = 1e-4
    for _ in range(iters):
        r = residuals(R, t)
        J, _ = point_jacobians(A, R, X, camera_points(A, R, t, X))
        hw = (w * huber_weight(torch.sum(r * r, -1)))[:, None, None]
        H = A.ein("nai,naj->ij", J * hw, J)
        g = A.ein("nai,na->i", J * hw, r)
        H = H + lam * max(float(torch.trace(H)) / 6.0, 1e-10) * torch.eye(6, dtype=A.dt)
        step = -torch.linalg.solve(H, g)
        Rn, tn = A.ein("ij,jk->ik", R, rodrigues(step[:3])), t + step[3:]
        if cost(residuals(Rn, tn)) < cost(r):
            R, t = Rn, tn
            lam = max(lam * 0.33, 1e-10)
        else:
            lam = min(lam * 8.0, 1e4)
    return R, t


def ransac_pnp(A: Arith, x, X, mask, draw, thr, R_init, t_init, chunk=128):
    """Registration of rays x [N, 3] against points X [N, 3] on rows
    ``mask`` (item 3 of the module docstring).  Returns (R, t, inliers
    [N] bool)."""
    n = len(mask)
    rows = np.nonzero(mask)[0]
    if len(rows) < 6:    # no minimal set: no pose
        return R_init, t_init, np.zeros(n, bool)
    pos = np.cumsum(mask) - 1
    xv, Xv = x[rows], X[rows]
    c = Xv.mean(0)
    scale = max(float(torch.linalg.vector_norm(Xv - c, dim=1).mean()), 1e-3)
    Xn = (Xv - c) / scale

    def count(R, t, gate):
        return int(torch.sum(sq_reprojection(A, R, t, xv, Xn) < gate))

    sets = pos[np.asarray(draw(torch.as_tensor(mask)), np.int64)]
    counts = []
    for s in range(0, len(sets), chunk):
        idx = torch.as_tensor(sets[s:s + chunk])
        Rb, tb = pnp_dlt(A, xv[idx], Xn[idx])
        counts.append(torch.sum(sq_reprojection(A, Rb, tb, xv, Xn) < thr, -1))
    best = int(torch.argmax(torch.cat(counts)))
    idx = torch.as_tensor(sets[best:best + 1])
    Rb, tb = pnp_dlt(A, xv[idx], Xn[idx])
    R0, t0 = Rb[0], tb[0]
    t_prior = (A.ein("ij,j->i", R_init, c) + t_init) / scale
    if count(R_init, t_prior, thr * 16) > count(R0, t0, thr * 16):
        R0, t0 = R_init, t_prior
    best_c = count(R0, t0, thr)
    for mult in (16.0, 4.0, 4.0):
        wl = (sq_reprojection(A, R0, t0, xv, Xn) < thr * mult).to(A.dt)
        R1, t1 = pnp_refine(A, R0, t0, xv, Xn, wl)
        R2, t2 = pnp_dlt(A, xv, Xn, wl)
        R2, t2 = pnp_refine(A, R2, t2, xv, Xn, wl)
        c1, c2 = count(R1, t1, thr), count(R2, t2, thr)
        if c2 >= c1:
            R1, t1, c1 = R2, t2, c2
        if c1 > best_c:
            R0, t0, best_c = R1, t1, c1
    inl = np.zeros(n, bool)
    inl[rows] = (sq_reprojection(A, R0, t0, xv, Xn) < thr).numpy()
    return R0, scale * t0 - A.ein("ij,j->i", R0, c), inl


# --- bundle adjustment ---

class Problem(NamedTuple):
    cam: torch.Tensor       # [O] int64
    pt: torch.Tensor        # [O] int64, 0 .. P - 1
    uv: torch.Tensor        # [O, 2] normalized observations
    fixed: torch.Tensor     # [M] bool


def lm(A: Arith, R, t, X, prob: Problem, iters, lam=1e-3):
    """LM bundle adjustment (item 7).  Returns (R, t, X, costs)."""
    M, P = R.shape[0], X.shape[0]
    free = torch.nonzero(~prob.fixed).flatten()
    nf = len(free)

    def residuals(R, t, X):
        return project(camera_points(A, R[prob.cam], t[prob.cam], X[prob.pt][:, None])[:, 0]
                       )[0] - prob.uv

    def cost(R, t, X):
        r = residuals(R, t, X)
        return float(huber_cost(torch.sum(r * r, -1)))

    c = cost(R, t, X)
    costs = [c]
    eye3 = torch.eye(3, dtype=A.dt)
    eye6 = torch.eye(6, dtype=A.dt)
    for _ in range(iters):
        Rc = R[prob.cam]
        Xc = camera_points(A, Rc, t[prob.cam], X[prob.pt][:, None])[:, 0]
        r = project(Xc)[0] - prob.uv
        Jc, Jp = point_jacobians(A, Rc, X[prob.pt], Xc)
        w = huber_weight(torch.sum(r * r, -1))[:, None, None]
        U = torch.zeros((M, 6, 6), dtype=A.dt).index_add_(0, prob.cam,
                                                          A.ein("oai,oaj->oij", Jc * w, Jc))
        V = torch.zeros((P, 3, 3), dtype=A.dt).index_add_(0, prob.pt,
                                                          A.ein("oai,oaj->oij", Jp * w, Jp))
        gc = torch.zeros((M, 6), dtype=A.dt).index_add_(0, prob.cam,
                                                        A.ein("oai,oa->oi", Jc * w, r))
        gp = torch.zeros((P, 3), dtype=A.dt).index_add_(0, prob.pt,
                                                        A.ein("oai,oa->oi", Jp * w, r))
        Wo = A.ein("oai,oaj->oij", Jc * w, Jp)                                # [O, 6, 3]
        trU = torch.diagonal(U, dim1=1, dim2=2).sum(-1)
        trV = torch.diagonal(V, dim1=1, dim2=2).sum(-1)
        Ud = U + lam * (trU / 6.0 + 1e-6)[:, None, None] * eye6
        Vi = torch.linalg.inv(V + lam * (trV / 3.0 + 1e-6)[:, None, None] * eye3)
        # Eliminate the points: S = Ud - sum_p W_p V_p^-1 W_p^T over the
        # free cameras, rhs = gc - sum_p W_p V_p^-1 gp.
        Wg = torch.zeros((P, M, 6, 3), dtype=A.dt).index_put_(
            (prob.pt, prob.cam), Wo, accumulate=True)[:, free]                # [P, F, 6, 3]
        B = A.ein("pmix,pxy->pmiy", Wg, Vi)
        S = -A.ein("pmiy,pnjy->minj", B, Wg).reshape(6 * nf, 6 * nf)
        S = S + torch.block_diag(*Ud[free]) if nf else S
        rhs = (gc[free] - A.ein("pmiy,py->mi", B, gp)).reshape(-1)
        dc = torch.zeros((M, 6), dtype=A.dt)
        if nf:
            dc[free] = -torch.linalg.solve(S, rhs).reshape(nf, 6)
        dp = -A.ein("pxy,py->px", Vi, gp + A.ein("pmiy,mi->py", Wg, dc[free]))
        Rn = A.ein("mij,mjk->mik", R, rodrigues(dc[:, :3]))
        tn, Xn = t + dc[:, 3:], X + dp
        cn = cost(Rn, tn, Xn)
        if cn < c:
            R, t, X, c = Rn, tn, Xn, cn
            lam = max(lam * 0.33, 1e-9)
        else:
            lam = min(lam * 8.0, 1e6)
        costs.append(c)
    return R, t, X, costs


class _Map:
    """The map: poses, points, point-id tables."""

    def __init__(self, A, n_frames, slots, capacity):
        self.A = A
        self.R = torch.eye(3, dtype=A.dt).repeat(n_frames, 1, 1)
        self.t = torch.zeros((n_frames, 3), dtype=A.dt)
        self.pose_valid = np.zeros(n_frames, bool)
        self.X = torch.zeros((capacity, 3), dtype=A.dt)
        self.X_valid = np.zeros(capacity, bool)
        self.n = 0
        self.pid = np.full((n_frames, slots), -1, np.int64)

    def append(self, X_new, good):
        """New points for the rows ``good``, in row order, past the
        capacity none; their ids (-1 elsewhere)."""
        ids = np.full(len(good), -1, np.int64)
        rows = np.nonzero(good)[0][: max(len(self.X_valid) - self.n, 0)]
        if not len(rows):
            return ids
        ids[rows] = self.n + np.arange(len(rows))
        self.X[torch.as_tensor(ids[rows])] = X_new[torch.as_tensor(rows)]
        self.X_valid[ids[rows]] = True
        self.n += len(rows)
        return ids

    def observations(self, kp_valid):
        """Flat (frame * slots + slot) mask of the observations of valid
        points in registered frames."""
        pid = self.pid
        ok = (pid >= 0) & kp_valid & self.pose_valid[:, None]
        ok &= self.X_valid[np.clip(pid, 0, None)]
        return ok.reshape(-1)


def _problem(m: _Map, obs, uvn, fixed):
    """LM problem over the flat observations ``obs``, its points
    renumbered in id order: (Problem, point ids)."""
    slots = m.pid.shape[1]
    cam = obs // slots
    ids, pt = np.unique(m.pid.reshape(-1)[obs], return_inverse=True)
    return Problem(torch.as_tensor(cam), torch.as_tensor(pt.reshape(-1)),
                   uvn.reshape(-1, 2)[torch.as_tensor(obs)], torch.as_tensor(fixed)), ids


def _adjust(A, m: _Map, obs, uvn, fixed, iters, move_cameras=True):
    prob, ids = _problem(m, obs, uvn, fixed)
    R, t, X, costs = lm(A, m.R, m.t, m.X[torch.as_tensor(ids)], prob, iters)
    if move_cameras:
        m.R, m.t = R, t
    m.X[torch.as_tensor(ids)] = X
    return costs


def ba_descent(R, t, X, point_id, kept, uvn, pose_valid, iters=5) -> float:
    """The relative cost drop of ``iters`` float64 LM steps from (R, t,
    X) over the observations ``kept`` (flat frame * slots + slot), the
    first frame and unregistered ones fixed."""
    A = Arith(False)
    slots = point_id.shape[1]
    obs = np.nonzero(np.asarray(kept, bool))[0]
    if not len(obs):
        return float("inf")
    ids, pt = np.unique(point_id.reshape(-1)[obs], return_inverse=True)
    fixed = ~np.asarray(pose_valid, bool)
    fixed[0] = True
    prob = Problem(torch.as_tensor(obs // slots), torch.as_tensor(pt.reshape(-1)),
                   A.t(uvn).reshape(-1, 2)[torch.as_tensor(obs)], torch.as_tensor(fixed))
    _, _, _, costs = lm(A, A.t(R), A.t(t), A.t(X)[torch.as_tensor(ids)], prob, iters)
    return (costs[0] - costs[-1]) / max(costs[0], 1e-300)


def normalized(uv, K, A: Arith):
    """Rays K^-1 [u, v, 1] [..., 3] of pixels uv [..., 2]."""
    uv = A.t(uv)
    Kinv = A.t(np.linalg.inv(np.asarray(K, np.float64)))
    return A.ein("ij,...j->...i", Kinv, torch.cat([uv, torch.ones_like(uv[..., :1])], -1))


def _bootstrap(A, m: _Map, x0, x1m, idx01, sel, draw, cfg):
    """Item 2: frames (0, 1) from rays x0 [K, 3], x1m = frame 1's rays at
    the matched slots, the RANSAC rows ``sel``."""
    rc = cfg.ransac
    An = A.np
    x1, x2 = x0.numpy().astype(An.dt), x1m.numpy().astype(An.dt)
    w = sel.astype(An.dt)
    T1, T2 = g2._hartley(x1, w), g2._hartley(x2, w)
    y1, y2 = An.ein("ij,nj->ni", T1, x1), An.ein("ij,nj->ni", T2, x2)
    rows = (y2[:, :, None] * y1[:, None, :]).reshape(len(x1), 9)
    sets = np.asarray(draw(torch.as_tensor(sel)), np.int64)
    e = np.linalg.svd(rows[sets])[2][:, -1, :].reshape(-1, 3, 3)
    bank = g2._to_essential(An.ein("ji,hjk,kl->hil", T2, e, T1))
    counts = np.concatenate([np.sum((g2.epipolar_distance(An, bank[s:s + 256], x1, x2)
                                     < rc.threshold) & sel, 1)
                             for s in range(0, len(bank), 256)])
    E = bank[int(np.argmax(counts))]
    r = g2.epipolar_distance(An, E, x1, x2)
    for _ in range(rc.refit_iters):
        wr = ((r < rc.threshold) & sel).astype(An.dt)
        v = np.linalg.eigh(An.ein("ni,nj->ij", rows * wr[:, None], rows))[1][:, 0]
        E_new = g2._to_essential(An.ein("ji,jk,kl->il", T2, v.reshape(3, 3), T1))
        r_new = g2.epipolar_distance(An, E_new, x1, x2)
        if np.sum((r_new < rc.threshold) & sel) >= wr.sum():
            E, r = E_new, r_new
    inl = (r < rc.threshold) & sel
    wi = inl.astype(An.dt)
    R, t = g2._branch_by_vote(An, E, x1, x2, wi)
    R, t = g2.refine_pose(An, R, t, x1, x2, wi, iters=cfg.refine_iters, huber=HUBER)
    R, t = g2._branch_by_vote(An, g2._skew(t) @ R, x1, x2, wi)
    X, z1, z2, finite = g2.triangulate(An, R, t, x1, x2)
    good = inl & finite & (z1 > 0) & (z2 > 0)
    ids = m.append(A.t(X), good)
    m.R[1], m.t[1] = A.t(R), A.t(t)
    m.pose_valid[:2] = True
    m.pid[0] = ids
    m.pid[1] = set_last(m.pid[1], idx01, ids, ids >= 0)


def _register(A, m: _Map, i, backs, x, matches, draw, thr):
    """Items 3-4: frame i against ``backs`` (nearest first, padded)."""
    slots = m.pid.shape[1]
    pid_prev = np.stack([m.pid[p] for p in backs])                        # [B, K]
    idx = np.stack([mi for mi, _ in matches])
    ok = np.stack([mo for _, mo in matches])
    safe = np.clip(pid_prev, 0, None)
    corr = (pid_prev >= 0) & ok & m.X_valid[safe]
    x_obs = x[i][torch.as_tensor(idx)]                                   # [B, K, 3]
    X_corr = m.X[torch.as_tensor(safe)]
    p0 = backs[0]
    R_new, t_new, inl = ransac_pnp(A, x_obs.reshape(-1, 3), X_corr.reshape(-1, 3),
                                   corr.reshape(-1), draw, thr, m.R[p0], m.t[p0])
    pose_ok = int(inl.sum()) >= 12
    inl = inl.reshape(len(backs), slots)
    # Item 4 as it reads: every inlier row names its point for the
    # current frame's slot; the writes run from the farthest frame to the
    # nearest and in row order, so the last one stands.
    named = {}
    for b in reversed(range(len(backs))):
        for k in np.nonzero(corr[b] & inl[b])[0]:
            named[int(idx[b, k])] = int(pid_prev[b, k])
    fresh = ok[0] & (pid_prev[0] < 0)
    good = np.zeros(slots, bool)
    if pose_ok:
        Xn, finite = triangulate(A, m.R[p0], m.t[p0], R_new, t_new, x[p0], x_obs[0])
        good = fresh & (finite & (depth(A, m.R[p0], m.t[p0], Xn) > 0)
                        & (depth(A, R_new, t_new, Xn) > 0)
                        & (sq_reprojection(A, m.R[p0], m.t[p0], x[p0], Xn) < thr)
                        & (sq_reprojection(A, R_new, t_new, x_obs[0], Xn) < thr)).numpy()
    new = m.append(Xn if pose_ok else None, good)
    for k in np.nonzero(new >= 0)[0]:     # a fresh point is both frames' own
        m.pid[p0, k] = new[k]
        named[int(idx[0, k])] = int(new[k])
    m.pid[i] = -1
    for slot, point in named.items():
        m.pid[i, slot] = point
    m.R[i] = R_new if pose_ok else torch.eye(3, dtype=A.dt)
    m.t[i] = t_new if pose_ok else torch.zeros(3, dtype=A.dt)
    m.pose_valid[i] = pose_ok


def _closure(A, m: _Map, i, j, x, idx, ok, gate):
    """Item 6, slot by slot: each matched slot k of frame i and its
    partner idx[k] of frame j, with the points they hold (valid ones
    only) and whether each point reprojects under the gate in the other
    frame's view."""
    valid = lambda p: p >= 0 and bool(m.X_valid[p])      # noqa: E731
    xj = x[j][torch.as_tensor(idx)]
    held_i = m.pid[i].copy()
    held_j = m.pid[j][idx]
    X_i = m.X[torch.as_tensor(np.clip(held_i, 0, None))]
    X_j = m.X[torch.as_tensor(np.clip(held_j, 0, None))]
    i_fits_j = (sq_reprojection(A, m.R[j], m.t[j], xj, X_i) < gate).numpy()
    j_fits_i = (sq_reprojection(A, m.R[i], m.t[i], x[i], X_j) < gate).numpy()
    into, to_j, to_i, bare = {}, [], [], []
    for k in np.nonzero(ok)[0]:
        a, b = int(held_i[k]), int(held_j[k])
        if valid(a) and valid(b):
            if a != b and i_fits_j[k] and j_fits_i[k]:
                into[b] = a                 # j's point is i's; the last slot stands
        elif valid(a):
            if i_fits_j[k]:
                to_j.append(k)
        elif valid(b):
            if j_fits_i[k]:
                to_i.append(k)
        elif a < 0 and b < 0:
            bare.append(k)

    def final(p):
        """Where a merged point went, through every later merge."""
        seen = set()
        while p in into and p not in seen:
            seen.add(p)
            p = into[p]
        return p

    for p in into:
        m.X_valid[p] = False
    m.pid = np.vectorize(lambda p: final(p) if p >= 0 else -1, otypes=[np.int64])(m.pid)
    for k in to_j:
        m.pid[j, idx[k]] = m.pid[i, k]
    for k in to_i:
        m.pid[i, k] = final(int(held_j[k]))
    sel = np.zeros(len(ok), bool)
    sel[bare] = True
    Xn, finite = triangulate(A, m.R[i], m.t[i], m.R[j], m.t[j], x[i], xj)
    good = sel & (finite & (depth(A, m.R[i], m.t[i], Xn) > 0)
                  & (depth(A, m.R[j], m.t[j], Xn) > 0)
                  & (sq_reprojection(A, m.R[i], m.t[i], x[i], Xn) < gate)
                  & (sq_reprojection(A, m.R[j], m.t[j], xj, Xn) < gate)).numpy()
    new = m.append(Xn, good)
    for k in np.nonzero(new >= 0)[0]:
        m.pid[i, k] = new[k]
        m.pid[j, idx[k]] = new[k]


def _point_of_track(A, m: _Map, obs, uvn):
    """The least-squares point of the observations ``obs`` (flat frame *
    slots + slot) of one track (item 8), or None where it is not finite."""
    slots = m.pid.shape[1]
    cam = torch.as_tensor(obs // slots)
    uv = uvn.reshape(-1, 2)[torch.as_tensor(obs)]
    R, t = m.R[cam], m.t[cam]
    rows = torch.cat([uv[:, :1] * R[:, 2] - R[:, 0], uv[:, 1:] * R[:, 2] - R[:, 1]])
    rhs = -torch.cat([uv[:, 0] * t[:, 2] - t[:, 0], uv[:, 1] * t[:, 2] - t[:, 1]])
    X = torch.linalg.solve(A.ein("ki,kj->ij", rows, rows) + 1e-6 * torch.eye(3, dtype=A.dt),
                           A.ein("ki,k->i", rows, rhs))
    return X if bool(torch.isfinite(X).all()) else None


def _sq_residuals(A, m: _Map, X, uvn):
    """[M * K] squared residuals of every slot's point (0 where none)."""
    slots = m.pid.shape[1]
    cam = torch.arange(m.pid.size) // slots
    Xc = camera_points(A, m.R[cam], m.t[cam], X[torch.as_tensor(np.clip(m.pid, 0, None))
                                                 .reshape(-1)][:, None])[:, 0]
    r = project(Xc)[0] - uvn.reshape(-1, 2)
    return torch.sum(r * r, -1)


def _global_ba(A, m: _Map, kp_valid, uvn, iters):
    """Item 8: (kept [M * K], mean squared residual, costs)."""
    obs0 = m.observations(kp_valid)
    fixed = ~m.pose_valid.copy()
    fixed[0] = True
    costs = _adjust(A, m, np.nonzero(obs0)[0], uvn, fixed, iters)
    rn2 = _sq_residuals(A, m, m.X, uvn).numpy()
    gate = 25.0 * float(torch.quantile(torch.as_tensor(rn2[obs0]), 0.5)) + 1e-12
    keep = obs0 & (rn2 < gate)
    # The rescue, track by track: one left with fewer than two kept
    # observations takes its least-squares point where two or more of
    # its observations fit that under the gate, and keeps those.
    tracks = {}
    for o in np.nonzero(obs0)[0]:
        tracks.setdefault(int(m.pid.reshape(-1)[o]), []).append(o)
    slots = m.pid.shape[1]
    for point, obs in tracks.items():
        obs = np.asarray(obs)
        if len(obs) < 2 or keep[obs].sum() >= 2:
            continue
        X = _point_of_track(A, m, obs, uvn)
        if X is None:
            continue
        cam = torch.as_tensor(obs // slots)
        r = project(camera_points(A, m.R[cam], m.t[cam], X[None, None])[:, 0])[0]
        fits = (torch.sum((r - uvn.reshape(-1, 2)[torch.as_tensor(obs)]) ** 2, -1)
                < gate).numpy()
        if fits.sum() >= 2:
            m.X[point] = X
            keep[obs] = fits
    costs += _adjust(A, m, np.nonzero(keep)[0], uvn, fixed, max(iters // 2, 5))
    rn2 = _sq_residuals(A, m, m.X, uvn).numpy()
    return keep, float(rn2[keep].sum() / max(keep.sum(), 1)), costs


def run(uv, kp_valid, matches, K, cfg, draws, *, n_back=3, local_ba_iters=5,
        local_ba_window=5, ba_iters=20, closure_pairs=(), closure_gate_mult=64.0,
        control=False) -> Sequence:
    """The reconstruction of frames with keypoints ``uv`` [M, K, 2] (pixels)
    and ``kp_valid`` [M, K], the matches ``matches[(p, i)]`` = (index [K]
    into frame i's slots, valid [K]) of every pair the sequence uses, K,
    ``cfg`` (a ``PipelineConfig``: its RANSAC settings and
    ``refine_iters``) and ``draws[i]``: the rows' valid mask (torch bool)
    -> minimal sets (0: the bootstrap's 8-point sets, i >= 2: frame i's
    6-point sets)."""
    A = Arith(control)
    kp_valid = np.asarray(kp_valid, bool)
    uv = np.asarray(uv, np.float64)
    M, slots = kp_valid.shape
    x = normalized(uv, K, A)                                             # [M, K, 3]
    uvn = x[..., :2] / x[..., 2:]
    m = _Map(A, M, slots, M * slots // 4)
    thr = cfg.ransac.threshold

    def matched(p, i):
        index, valid = matches[(p, i)]
        index = np.asarray(index, np.int64)
        return index, np.asarray(valid, bool) & kp_valid[p] & kp_valid[i][index]

    idx01, ok01 = matched(0, 1)
    sel = ok01 & (np.sum((uv[0] - uv[1][idx01]) ** 2, 1) > cfg.ransac.min_disparity_px ** 2)
    _bootstrap(A, m, x[0], x[1][torch.as_tensor(idx01)], idx01, sel, draws[0], cfg)
    cap_obs = (local_ba_window + n_back + 2) * slots
    for i in range(2, M):
        backs = list(range(i - 1, max(i - 1 - n_back, -1), -1))
        pairs = [matched(p, i) for p in backs]
        while len(backs) < n_back:
            backs.append(backs[-1])
            pairs.append((pairs[-1][0], np.zeros(slots, bool)))
        _register(A, m, i, backs, x, pairs, draws[i], thr * 4)
        if local_ba_iters:
            lo = i - local_ba_window + 1
            obs = m.observations(kp_valid)
            cam = np.arange(M * slots) // slots
            inside = (cam >= lo) & (cam <= i)
            seen = np.zeros(len(m.X_valid), bool)
            seen[m.pid.reshape(-1)[obs & inside]] = True
            keep = obs & seen[np.clip(m.pid.reshape(-1), 0, None)]
            order = np.concatenate([np.nonzero(keep & inside)[0],
                                    np.nonzero(keep & ~inside)[0]])[:cap_obs]
            fixed = ~m.pose_valid | (np.arange(M) < lo)
            fixed[0] = True
            _adjust(A, m, np.sort(order), uvn, fixed, local_ba_iters)
    if local_ba_iters:
        _adjust(A, m, np.nonzero(m.observations(kp_valid))[0], uvn, np.ones(M, bool), 3,
                move_cameras=False)
    for ci, cj in closure_pairs:
        idx, ok = matched(ci, cj)
        _closure(A, m, ci, cj, x, idx, ok, thr * 4 * closure_gate_mult)
    kept, mean_reproj, costs = _global_ba(A, m, kp_valid, uvn, ba_iters)

    def host(v):
        return v.detach().numpy().astype(np.float64)

    return Sequence(R=host(m.R), t=host(m.t), pose_valid=m.pose_valid.copy(), X=host(m.X),
                    X_valid=m.X_valid.copy(), point_id=m.pid.copy(), kept=kept,
                    mean_reproj=mean_reproj, ba_costs=costs)
