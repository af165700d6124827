"""Two-view geometry in float64 NumPy, written apart from the port: the
reference that the pair cell's pose, inliers and points are judged by.

It computes what ``two_view_geometry``'s configuration states (the
knobs of ``PipelineConfig`` named below), from the pixel
correspondences, K and the 8-point minimal sets:

1. rays x = K^-1 [u, v, 1]; RANSAC rows: ``mask`` and a disparity over
   ``min_disparity_px``;
2. the bank: the 8-point essential matrix of every minimal set
   (Hartley-normalized over the RANSAC rows, the SVD null vector,
   projected onto singular values (1, 1, 0)), each counted by the RANSAC
   rows whose symmetric squared epipolar distance is under
   ``threshold``; the first with the most, refit ``refit_iters`` times
   by the least-squares 8-point solution over its inliers while that
   keeps at least as many;
3. the score of a pose: the rows in ``mask``, under ``threshold`` and in
   front of both cameras (two-ray midpoint depths), with those under
   ``threshold * score_tight_mult`` counted first
   (tight * (N + 1) + all);
4. multi-start: the four branches of the refit E and of the
   ``restart_k`` bank draws that counted most (ties to the lower index);
   each candidate's best branch; the ``probe_starts`` candidates that
   score most refined ``probe_iters`` steps over their own scored rows;
   the best of them;
5. ``refine_rounds`` rounds: refine ``refine_iters`` steps over the
   current scored rows, take the branch of the refined E that puts most
   RANSAC inliers (the first ``vote_cap``) in front (DLT), score it, and
   keep it only where it scores strictly more;
6. the kept E's inliers (``mask``, under ``threshold``), its branch with
   most of them in front, and every row triangulated in that pose (the
   eigenvector of the least eigenvalue of its DLT system's normal
   matrix).

A refinement step is Levenberg-Marquardt on the Huber cost (``huber``)
of the Sampson residuals, over R exp([w]x) and t moved in its tangent
plane: the damping starts at 1e-4 of the normal matrix's mean diagonal,
shrinks by 0.33 after a step that lowers the cost and grows by 8 after
one that does not, which is then not taken.

``control=True`` computes the same one precision down from the f32
(TF32 off) that the configuration states: float32 arithmetic with the
operands of every matrix product rounded to TF32 (10-bit mantissa).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Geometry(NamedTuple):
    R: np.ndarray             # [3, 3] second camera's rotation
    t: np.ndarray             # [3] unit translation
    inliers: np.ndarray       # [N] bool
    num_inliers: int
    points: np.ndarray        # [N, 3] in the first camera's frame
    point_valid: np.ndarray   # [N] bool: inlier, in front of both, finite


def tf32(x) -> np.ndarray:
    """float32 ``x`` rounded to TF32's 10-bit mantissa (to nearest, ties
    to even)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0xFFF) + ((b >> np.uint32(13)) & np.uint32(1))) & np.uint32(0xFFFFE000)
    return b.view(np.float32)


class _Arith:
    def __init__(self, control: bool):
        self.control = control
        self.dt = np.float32 if control else np.float64

    def arr(self, x) -> np.ndarray:
        return np.asarray(x, self.dt)

    def ein(self, spec, *ops) -> np.ndarray:
        """A matrix product: operands in TF32 under the control."""
        ops = [tf32(o) if self.control else self.arr(o) for o in ops]
        return np.einsum(spec, *ops).astype(self.dt)


def _skew(v):
    z = np.zeros(v.shape[:-1], v.dtype)
    return np.stack([np.stack([z, -v[..., 2], v[..., 1]], -1),
                     np.stack([v[..., 2], z, -v[..., 0]], -1),
                     np.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _rodrigues(w):
    th = float(np.linalg.norm(w))
    K = _skew(w)
    if th < 1e-12:
        return np.eye(3, dtype=w.dtype) + K + 0.5 * (K @ K)
    return (np.eye(3, dtype=w.dtype) + (np.sin(th) / th) * K
            + ((1.0 - np.cos(th)) / th ** 2) * (K @ K)).astype(w.dtype)


def _perp_basis(t):
    """[3, 2] orthonormal basis of the plane perpendicular to unit t."""
    a = np.array([1.0, 0.0, 0.0]) if abs(t[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    b1 = np.cross(t, a)
    b1 /= np.linalg.norm(b1)
    return np.stack([b1, np.cross(t, b1)], 1).astype(t.dtype)


def _hartley(x, w):
    xy = x[:, :2]
    n = max(float(w.sum()), 1.0)
    c = (xy * w[:, None]).sum(0) / n
    d = float((np.linalg.norm(xy - c, axis=1) * w).sum() / n)
    s = np.sqrt(2.0) / max(d, 1e-3)
    return np.array([[s, 0.0, -s * c[0]], [0.0, s, -s * c[1]], [0.0, 0.0, 1.0]], x.dtype)


def _to_essential(E):
    U, _, Vt = np.linalg.svd(E)
    return (U * np.array([1.0, 1.0, 0.0], E.dtype)[..., None, :]) @ Vt


def _lines(A: _Arith, E, x1, x2):
    """(E x1, E^T x2, x2^T E x1) for E [..., 3, 3] against rows [N, 3]."""
    l1 = A.ein("...ij,nj->...ni", E, x1)
    l2 = A.ein("...ji,nj->...ni", E, x2)
    return l1, l2, A.ein("ni,...ni->...n", x2, l1)


def epipolar_distance(A: _Arith, E, x1, x2):
    """Symmetric squared epipolar distance [..., N]."""
    l1, l2, num = _lines(A, E, x1, x2)
    tiny = np.finfo(A.dt).tiny
    return num ** 2 * (1.0 / np.maximum(l1[..., 0] ** 2 + l1[..., 1] ** 2, tiny)
                       + 1.0 / np.maximum(l2[..., 0] ** 2 + l2[..., 1] ** 2, tiny))


def _sampson_and_jacobian(A: _Arith, R, t, B, x1, x2):
    """Signed Sampson residuals r [N] of E = [t]x R and their derivatives
    J [N, 5] along R exp([w]x) (w in R^3) and t + B b (b in R^2)."""
    E = _skew(t) @ R
    dE = np.concatenate([_skew(t)[None] @ R[None] @ _skew(np.eye(3, dtype=R.dtype)),
                         _skew(B.T) @ R[None]])                       # [5, 3, 3]
    l1, l2, n = _lines(A, E, x1, x2)
    m1, m2, dn = _lines(A, dE, x1, x2)                                # [5, N, 3], [5, N]
    D = l1[:, 0] ** 2 + l1[:, 1] ** 2 + l2[:, 0] ** 2 + l2[:, 1] ** 2
    dD = 2.0 * (l1[:, 0] * m1[..., 0] + l1[:, 1] * m1[..., 1]
                + l2[:, 0] * m2[..., 0] + l2[:, 1] * m2[..., 1])
    sD = np.sqrt(np.maximum(D, np.finfo(A.dt).tiny))
    r = n / sD
    J = dn / sD - 0.5 * n * dD / (sD ** 3)
    return r, J.T


def _huber_cost(r, w, delta):
    a = np.abs(r)
    return float(np.sum(w * np.where(a <= delta, 0.5 * r * r, delta * (a - 0.5 * delta))))


def refine_pose(A: _Arith, R, t, x1, x2, w, *, iters: int, huber: float):
    """``iters`` Levenberg-Marquardt steps on the Huber cost of the Sampson
    residuals over the rows with weight ``w``."""
    lam = 1e-4
    t = t / np.linalg.norm(t)
    r, J = _sampson_and_jacobian(A, R, t, _perp_basis(t), x1, x2)
    cost = _huber_cost(r, w, huber)
    for _ in range(iters):
        hw = w * np.where(np.abs(r) <= huber, 1.0, huber / np.maximum(np.abs(r), np.finfo(A.dt).tiny))
        H = A.ein("ni,nj->ij", J * hw[:, None], J)
        g = A.ein("ni,n->i", J * hw[:, None], r)
        H = H + (1e-8 + lam) * max(np.trace(H) / 5.0, 1e-12) * np.eye(5, dtype=A.dt)
        step = -np.linalg.solve(H, g).astype(A.dt)
        Rn = R @ _rodrigues(step[:3])
        tn = t + _perp_basis(t) @ step[3:]
        tn = tn / np.linalg.norm(tn)
        rn, Jn = _sampson_and_jacobian(A, Rn, tn, _perp_basis(tn), x1, x2)
        cn = _huber_cost(rn, w, huber)
        if cn < cost:
            R, t, r, J, cost = Rn, tn, rn, Jn, cn
            lam = max(lam * 0.33, 1e-10)
        else:
            lam = min(lam * 8.0, 1e4)
    return R, t


def pose_branches(E):
    """The four (R, t) of an essential matrix."""
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    Ra, Rb = U @ W @ Vt, U @ W.T @ Vt
    u = U[:, 2]
    return [(Ra, u), (Ra, -u), (Rb, u), (Rb, -u)]


def triangulate(A: _Arith, R, t, x1, x2):
    """DLT points [N, 3] of cameras [I | 0] and [R | t] (the eigenvector
    of the least eigenvalue of each 4x4 system's normal matrix), their
    depths in both, and whether each is finite."""
    P1 = np.eye(3, 4, dtype=A.dt)
    P2 = np.concatenate([R, t[:, None]], 1).astype(A.dt)
    M = np.stack([x1[:, 0:1] * P1[2] - P1[0], x1[:, 1:2] * P1[2] - P1[1],
                  x2[:, 0:1] * P2[2] - P2[0], x2[:, 1:2] * P2[2] - P2[1]], 1)
    Xh = np.linalg.eigh(A.ein("nki,nkj->nij", M, M))[1][:, :, 0]
    w = Xh[:, 3]
    finite = np.abs(w) * 5.0 > np.linalg.norm(Xh[:, :3], axis=1) * 1e-6
    X = Xh[:, :3] / np.where(np.abs(w) < 1e-12, np.where(w < 0, -1e-12, 1e-12), w)[:, None]
    z2 = A.ein("ij,nj->ni", R, X)[:, 2] + t[2]
    return X, X[:, 2], z2, finite


def midpoint_depths(A: _Arith, R, t, x1, x2):
    """Depths (z1, z2) of the two rays' closest points: x1 from the first
    centre, R^T x2 from the second, C2 = -R^T t."""
    b = A.ein("ji,nj->ni", R, x2)
    C2 = -(R.T @ t)
    aa, bb, ab = np.sum(x1 * x1, 1), np.sum(b * b, 1), np.sum(x1 * b, 1)
    ac, bc = x1 @ C2, b @ C2
    det = aa * bb - ab * ab
    det = np.where(np.abs(det) < 1e-12, 1e-12, det)
    return (bb * ac - ab * bc) / det, (ab * ac - aa * bc) / det


def _branch_by_vote(A, E, x1, x2, w):
    """The branch of E with most weight ``w`` in front of both cameras
    (DLT), the first on a tie."""
    branches = pose_branches(E)
    votes = []
    for R, t in branches:
        _, z1, z2, _ = triangulate(A, R, t, x1, x2)
        votes.append(float(np.sum(((z1 > 0) & (z2 > 0)) * w)))
    return branches[int(np.argmax(votes))]


def _stable_top(scores, k):
    return np.argsort(-np.asarray(scores), kind="stable")[:k]


def two_view_geometry(uv1, uv2, mask, K, minimal_sets, cfg, *, huber: float = 3e-3,
                      chunk: int = 256, control: bool = False) -> Geometry:
    """The pose, inliers and points of pixel correspondences ``uv1``,
    ``uv2`` [N, 2] (rows where ``mask`` holds) from the 8-point minimal
    sets ``minimal_sets`` [H, 8] (indices of rows), under ``cfg`` (a
    ``PipelineConfig``; its multi-start probe path, no translation
    re-vote)."""
    if cfg.restart_k < 1 or cfg.probe_starts < 2 or cfg.tvote_rounds:
        raise ValueError("the reference follows the multi-start probe path "
                         "(restart_k > 0, probe_starts > 1, tvote_rounds 0) only")
    rc = cfg.ransac
    thr = rc.threshold
    A = _Arith(control)
    mask = np.asarray(mask, bool)
    uv1, uv2 = np.asarray(uv1, np.float64), np.asarray(uv2, np.float64)
    Kinv = np.linalg.inv(np.asarray(K, np.float64))
    ones = np.ones((len(uv1), 1))
    x1 = A.ein("ij,nj->ni", Kinv, np.concatenate([uv1, ones], 1))
    x2 = A.ein("ij,nj->ni", Kinv, np.concatenate([uv2, ones], 1))
    n = len(x1)
    sel = mask & (np.sum((uv1 - uv2) ** 2, 1) > rc.min_disparity_px ** 2)

    def dist(E):
        return epipolar_distance(A, E, x1, x2)

    # 2: the bank, its best draw and the refit.
    T1, T2 = _hartley(x1, sel.astype(A.dt)), _hartley(x2, sel.astype(A.dt))
    y1, y2 = A.ein("ij,nj->ni", T1, x1), A.ein("ij,nj->ni", T2, x2)
    rows = (y2[:, :, None] * y1[:, None, :]).reshape(n, 9)
    idx = np.asarray(minimal_sets, np.int64)
    e = np.linalg.svd(rows[idx])[2][:, -1, :].reshape(-1, 3, 3)
    E_bank = _to_essential(A.ein("ji,hjk,kl->hil", T2, e, T1))
    counts = np.concatenate([np.sum((dist(E_bank[s:s + chunk]) < thr) & sel, 1)
                             for s in range(0, len(E_bank), chunk)])
    E = E_bank[int(np.argmax(counts))]
    r = dist(E)
    for _ in range(rc.refit_iters):
        w = ((r < thr) & sel).astype(A.dt)
        v = np.linalg.eigh(A.ein("ni,nj->ij", rows * w[:, None], rows))[1][:, 0]
        E_new = _to_essential(A.ein("ji,jk,kl->il", T2, v.reshape(3, 3), T1))
        r_new = dist(E_new)
        if np.sum((r_new < thr) & sel) >= w.sum():
            E, r = E_new, r_new
    ransac_inl = (r < thr) & sel

    # 3: scores, (tight, all) compared in that order.
    def scored(E, R, t):
        r = dist(E)
        z1, z2 = midpoint_depths(A, R, t, x1, x2)
        front = mask & (z1 > 0) & (z2 > 0)
        valid = (r < thr) & front
        tight = (r < thr * cfg.score_tight_mult) & front
        return (r < thr) & mask, valid, (int(tight.sum()), int(valid.sum()))

    # 4: multi-start and probes.
    starts = []
    for Ec in [E] + list(E_bank[_stable_top(counts, min(cfg.restart_k, len(E_bank)))]):
        options = [(scored(Ec, R, t), R, t) for R, t in pose_branches(Ec)]
        (_, valid, score), R, t = max(options, key=lambda o: o[0][2])
        starts.append((score, R, t, valid))
    order = sorted(range(len(starts)), key=lambda c: starts[c][0], reverse=True)
    probes = []
    for c in order[: cfg.probe_starts]:
        _, R, t, valid = starts[c]
        R, t = refine_pose(A, R, t, x1, x2, valid.astype(A.dt), iters=cfg.probe_iters,
                           huber=huber)
        Ep = _skew(t) @ R
        probes.append((scored(Ep, R, t), Ep, R, t))
    (inl, w, best_score), E_p, R, t = max(probes, key=lambda p: p[0][2])
    best = (E_p, inl)

    # 5: refine rounds.
    vote = np.zeros(n, A.dt)
    vote[np.flatnonzero(ransac_inl)[: cfg.vote_cap or n]] = 1.0
    for _ in range(max(cfg.refine_rounds, 1)):
        R, t = refine_pose(A, R, t, x1, x2, w.astype(A.dt), iters=cfg.refine_iters,
                           huber=huber)
        Er = _skew(t) @ R
        R, t = _branch_by_vote(A, Er, x1, x2, vote)
        inl, w, score = scored(Er, R, t)
        if score > best_score:
            best, best_score = (Er, inl), score

    # 6: the final branch and points.
    E, inl = best
    R, t = _branch_by_vote(A, E, x1, x2, inl.astype(A.dt))
    X, z1, z2, finite = triangulate(A, R, t, x1, x2)
    return Geometry(R=R, t=t, inliers=inl, num_inliers=int(inl.sum()), points=X,
                    point_valid=inl & (z1 > 0) & (z2 > 0) & finite)


def judge_at_pose(uv1, uv2, mask, K, R, t, cfg):
    """In float64, at a given pose (R, t): each row's inlier flag (``mask``
    and under ``threshold``), its DLT point, and whether that point is
    valid (an inlier, in front of both cameras, finite)."""
    A = _Arith(False)
    Kinv = np.linalg.inv(np.asarray(K, np.float64))
    ones = np.ones((len(uv1), 1))
    x1 = np.concatenate([np.asarray(uv1, np.float64), ones], 1) @ Kinv.T
    x2 = np.concatenate([np.asarray(uv2, np.float64), ones], 1) @ Kinv.T
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    inl = (epipolar_distance(A, _skew(t) @ R, x1, x2) < cfg.ransac.threshold) & np.asarray(
        mask, bool)
    X, z1, z2, finite = triangulate(A, R, t, x1, x2)
    return inl, X, inl & (z1 > 0) & (z2 > 0) & finite
