"""Batched small-matrix linear algebra (counterpart of
``sfm_tpu/ops/linalg.py``).

The SAME algorithms as the JAX package: cyclic Jacobi for symmetric
eigenproblems, the 3x3 SVD built on it (and the polar factor
``so3_project``), Householder QR for the minimal 8x9 null vectors,
ridge inverse iteration for the least-squares polish, and the
closed-form routes: ``eigh3x3`` (Cardano eigenvalues, an anchored
cross-product eigenvector and the exact 2x2 complement problem) behind
``svd3x3(method="analytic")``, and ``gram_nullvec4_adj`` (the adjugate
of the 4x4 Gram matrix) behind ``triangulate(solver="adj")``.  Jacobi
stays the default of both.  ``torch.linalg.eigh`` or ``svd`` are
deliberately not substituted: near-degenerate 3x3s (the
essential-matrix case s ~ (1, 1, 0)) pick their eigenvector directions
by the algorithm, and parity with the JAX package depends on it.  The
closed forms branch with ``torch.where`` only, never in Python.
"""

from __future__ import annotations

import math

import torch

from sfm_tpu_torch.utils.precision import f32_matmul


def _jacobi_rotation(app, aqq, apq):
    """Batched symmetric Jacobi rotation (c, s); identity where apq ~ 0."""
    small = apq.abs() <= 1e-36
    apq_safe = torch.where(small, torch.ones_like(apq), apq)
    tau = (aqq - app) / (2.0 * apq_safe)
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0.0, torch.ones_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    c = torch.where(small, torch.ones_like(c), c)
    s = torch.where(small, torch.zeros_like(s), s)
    return c, s


@f32_matmul
def jacobi_eigh(A, *, sweeps: int = 10, sort: bool = True):
    """Eigendecomposition of batched symmetric ``[..., n, n]`` matrices
    by ``sweeps`` cyclic Jacobi sweeps.

    Returns (w [..., n], V [..., n, n]) with eigenvectors in columns,
    eigenvalues ascending when ``sort``.
    """
    n = A.shape[-1]
    A = 0.5 * (A + A.transpose(-1, -2))
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                c, s = _jacobi_rotation(A[..., p, p], A[..., q, q],
                                        A[..., p, q])
                c_ = c[..., None]
                s_ = s[..., None]
                col_p = A[..., :, p].clone()
                col_q = A[..., :, q].clone()
                A[..., :, p] = c_ * col_p - s_ * col_q
                A[..., :, q] = s_ * col_p + c_ * col_q
                row_p = A[..., p, :].clone()
                row_q = A[..., q, :].clone()
                A[..., p, :] = c_ * row_p - s_ * row_q
                A[..., q, :] = s_ * row_p + c_ * row_q
                v_p = V[..., :, p].clone()
                v_q = V[..., :, q].clone()
                V[..., :, p] = c_ * v_p - s_ * v_q
                V[..., :, q] = s_ * v_p + c_ * v_q
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    if sort:
        order = torch.argsort(w, dim=-1, stable=True)
        w = torch.gather(w, -1, order)
        V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    return w, V


def smallest_eigvec(A, *, sweeps: int = 10):
    """Unit eigenvector ``[..., n]`` of the smallest eigenvalue."""
    w, V = jacobi_eigh(A, sweeps=sweeps, sort=False)
    idx = torch.argmin(w, dim=-1)
    v = torch.gather(V, -1, idx[..., None, None].expand(*V.shape[:-1], 1))
    v = v[..., 0]
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def gram_nullvec(A, *, sweeps: int = 10):
    """Smallest right-singular vector of ``[..., m, n]`` systems via the
    smallest eigenvector of the Gram matrix A^T A."""
    G = torch.einsum("...mi,...mj->...ij", A, A)
    return smallest_eigvec(G, sweeps=sweeps)


def _minor3(G, rs, cs):
    """Determinant of the 3x3 submatrix of G at rows ``rs``, columns ``cs``."""
    return det3(torch.stack([torch.stack([G[..., r, c] for c in cs], dim=-1)
                             for r in rs], dim=-2))


def gram_nullvec4_adj(A):
    """Null vector of [..., m, 4] systems from the ADJUGATE of G = A^T A.

    adj(G) = det(G) G^{-1} is dominated by the smallest eigenvalue's
    term, so its strongest column (the largest diagonal entry) is the
    null direction: 16 cofactor 3x3 determinants instead of a Jacobi
    chain.  G is first divided by its largest diagonal entry (the
    cofactors are cubic in G and overflow f32 from row scales ~1e3);
    the vector is normalized at the end, so the scale cancels.  Zero
    systems fall back to e3 = (0, 0, 0, 1).
    """
    G = torch.einsum("...mi,...mj->...ij", A, A)
    d0 = torch.diagonal(G, dim1=-2, dim2=-1).max(dim=-1).values
    G = G / torch.where(d0 > 1e-30, d0, torch.ones_like(d0))[..., None, None]
    idx = (0, 1, 2, 3)
    cols = []
    for j in range(4):
        rs = tuple(r for r in idx if r != j)
        cols.append(torch.stack(
            [((-1.0) ** (i + j)) * _minor3(G, rs, tuple(c for c in idx if c != i))
             for i in range(4)], dim=-1))   # adj(G)[:, j] (G symmetric)
    adj = torch.stack(cols, dim=-1)                            # [..., 4, 4]
    j = torch.argmax(torch.diagonal(adj, dim1=-2, dim2=-1), dim=-1)
    v = torch.gather(adj, -1, j[..., None, None].expand(*adj.shape[:-1], 1))[..., 0]
    n2 = torch.sum(v * v, dim=-1)
    ok = n2 > 1e-36
    den = torch.sqrt(torch.where(ok, n2, torch.ones_like(n2)))[..., None]
    fb = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=A.dtype, device=A.device)
    return torch.where(ok[..., None], v / den, fb.expand(v.shape))


@f32_matmul
def smallest_eigvec_power(G, *, iters: int = 5):
    """Smallest eigenvector of symmetric PSD ``[..., n, n]`` matrices by
    ridge inverse iteration (``iters`` batched n x n solves)."""
    n = G.shape[-1]
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    eps = (tr / n * 1e-7 + 1e-20)[..., None, None]
    A = G + eps * torch.eye(n, dtype=G.dtype, device=G.device)
    v = torch.ones(G.shape[:-1], dtype=G.dtype, device=G.device) / (n ** 0.5)
    for _ in range(iters):
        # solve_ex: no error check, which would wait for the card.
        w = torch.linalg.solve_ex(A, v[..., None])[0][..., 0]
        nw = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
        v = w / torch.clamp(nw, min=1e-30)
    return v


def det3(B):
    """Determinant of ``[..., 3, 3]`` by cofactor expansion."""
    return (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
    )


def _unit(v, eps=1e-20):
    return v / torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=eps))


def _eigvec_for(A, lam):
    """Eigenvector of symmetric 3x3 ``A`` for eigenvalue ``lam``: the
    largest cross product of two rows of A - lam I, normalized exactly
    by its norm; a canonical axis where every cross product vanishes
    (isotropic A, where any unit vector is one)."""
    M = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    c0 = torch.linalg.cross(M[..., 0, :], M[..., 1, :])
    c1 = torch.linalg.cross(M[..., 0, :], M[..., 2, :])
    c2 = torch.linalg.cross(M[..., 1, :], M[..., 2, :])
    n0 = torch.sum(c0 * c0, dim=-1)
    n1 = torch.sum(c1 * c1, dim=-1)
    n2 = torch.sum(c2 * c2, dim=-1)
    c01 = torch.where((n0 >= n1)[..., None], c0, c1)
    n01 = torch.maximum(n0, n1)
    c = torch.where((n01 >= n2)[..., None], c01, c2)
    n = torch.maximum(n01, n2)
    ok = n > 1e-36
    den = torch.sqrt(torch.where(ok, n, torch.ones_like(n)))[..., None]
    fb = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype, device=A.device)
    return torch.where(ok[..., None], c / den, fb.expand(c.shape))


@f32_matmul
def eigh3x3(A):
    """Closed-form eigendecomposition of batched symmetric 3x3 matrices:
    (w ascending [..., 3], V [..., 3, 3] orthonormal columns).

    A is scaled by its largest |entry| first (the cross products are
    quadratic in A); Cardano's eigenvalues with the ``acos`` argument
    clamped to [-1, 1]; the cross-product eigenvector of the
    better-separated extreme eigenvalue (the anchor), which stays
    accurate for a near-degenerate pair such as an essential matrix's
    s ~ (1, 1, 0); the other two from the exact 2x2 problem in the
    anchor's complement.  The eigenvalues returned are the Rayleigh
    quotients of the vectors, scaled back.
    """
    A = 0.5 * (A + A.transpose(-1, -2))
    dt, dev = A.dtype, A.device
    eye = torch.eye(3, dtype=dt, device=dev)
    amax = A.abs().amax(dim=(-2, -1))
    ascale = torch.where(amax > 1e-30, amax, torch.ones_like(amax))
    A = A / ascale[..., None, None]
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    d0 = A[..., 0, 0] - q
    d1 = A[..., 1, 1] - q
    d2 = A[..., 2, 2] - q
    off2 = A[..., 0, 1] ** 2 + A[..., 0, 2] ** 2 + A[..., 1, 2] ** 2
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * off2
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    scale = torch.where(p > 1e-30, p, torch.ones_like(p))
    B = (A - q[..., None, None] * eye) / scale[..., None, None]
    r = torch.clamp(det3(B) / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    lmax = q + 2.0 * p * torch.cos(phi)
    lmin = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lmid = 3.0 * q - lmax - lmin

    use_max = (lmax - lmid) >= (lmid - lmin)
    v_anchor = _eigvec_for(A, torch.where(use_max, lmax, lmin))
    # Orthonormal basis {u, w} of the anchor's complement.
    ref = torch.where((v_anchor[..., 0].abs() < 0.9)[..., None],
                      eye[0].expand(v_anchor.shape), eye[1].expand(v_anchor.shape))
    u = _unit(torch.linalg.cross(v_anchor, ref))
    w = torch.linalg.cross(v_anchor, u)
    Au = torch.einsum("...ij,...j->...i", A, u)
    Aw = torch.einsum("...ij,...j->...i", A, w)
    s00 = torch.sum(u * Au, dim=-1)
    s01 = torch.sum(u * Aw, dim=-1)
    s11 = torch.sum(w * Aw, dim=-1)
    theta = 0.5 * torch.atan2(2.0 * s01, s00 - s11)
    c = torch.cos(theta)
    s = torch.sin(theta)
    e0 = c[..., None] * u + s[..., None] * w
    e1 = -s[..., None] * u + c[..., None] * w
    mu0 = s00 * c * c + 2.0 * s01 * c * s + s11 * s * s
    mu1 = s00 * s * s - 2.0 * s01 * c * s + s11 * c * c
    swap = mu0 > mu1
    e_lo = torch.where(swap[..., None], e1, e0)
    e_hi = torch.where(swap[..., None], e0, e1)
    mu_lo = torch.where(swap, mu1, mu0)
    mu_hi = torch.where(swap, mu0, mu1)
    # Columns ascending: anchor = max -> (e_lo, e_hi, anchor); anchor =
    # min -> (anchor, e_lo, e_hi).
    um = use_max[..., None]
    V = torch.stack([torch.where(um, e_lo, v_anchor), torch.where(um, e_hi, e_lo),
                     torch.where(um, v_anchor, e_hi)], dim=-1)
    lam_a = torch.sum(v_anchor * torch.einsum("...ij,...j->...i", A, v_anchor), dim=-1)
    w_out = torch.stack([torch.where(use_max, mu_lo, lam_a),
                         torch.where(use_max, mu_hi, mu_lo),
                         torch.where(use_max, lam_a, mu_hi)], dim=-1)
    return w_out * ascale[..., None], V


@f32_matmul
def qr_nullvec(A):
    """Null vector of ``[..., m, n]`` systems with m < n: the trailing
    column of the complete QR of A^T (linear, not squared, conditioning
    for the minimal 8x9 systems)."""
    Q, _ = torch.linalg.qr(A.transpose(-1, -2), mode="complete")
    return Q[..., :, -1]


def _safe_unit(v, fallback):
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    ok = n > 1e-12
    unit = v / torch.where(ok, n, torch.ones_like(n))
    fb = torch.tensor(fallback, dtype=v.dtype, device=v.device).expand(v.shape)
    return torch.where(ok, unit, fb)


def _orthonormal_u_from(E, V, s):
    """U columns of a 3x3 SVD from right vectors V and singular values s:
    u_i = E v_i / s_i for the dominant pair, u_2 = u_0 x u_1."""
    u0 = (E @ V[..., :, 0:1])[..., 0] / torch.clamp(s[..., 0:1], min=1e-20)
    u0 = _safe_unit(u0, [1.0, 0.0, 0.0])
    u1 = (E @ V[..., :, 1:2])[..., 0]
    u1 = u1 - torch.sum(u1 * u0, dim=-1, keepdim=True) * u0
    n1 = torch.linalg.vector_norm(u1, dim=-1, keepdim=True)
    ok1 = n1 > 1e-12
    zero = torch.zeros_like(u0[..., 0])
    perp_a = torch.stack([-u0[..., 1], u0[..., 0], zero], dim=-1)
    perp_b = torch.stack([zero, -u0[..., 2], u0[..., 1]], dim=-1)
    na = torch.linalg.vector_norm(perp_a, dim=-1, keepdim=True)
    nb = torch.linalg.vector_norm(perp_b, dim=-1, keepdim=True)
    perp = torch.where(na > 0.5, perp_a / torch.clamp(na, min=1e-12),
                       perp_b / torch.clamp(nb, min=1e-12))
    u1 = torch.where(ok1, u1 / torch.where(ok1, n1, torch.ones_like(n1)), perp)
    u2 = torch.linalg.cross(u0, u1, dim=-1)
    return torch.stack([u0, u1, u2], dim=-1), u2


def _align_v2(E, V, u2):
    """Flip V's third column so E v2 aligns with u2."""
    Ev2 = (E @ V[..., :, 2:3])[..., 0]
    d = torch.sum(Ev2 * u2, dim=-1)
    sign = torch.where(d < 0, -1.0, 1.0).to(V.dtype)
    V = V.clone()
    V[..., :, 2] = V[..., :, 2] * sign[..., None]
    return V


@f32_matmul
def svd3x3(E, *, sweeps: int = 8, method: str = "jacobi"):
    """Batched 3x3 SVD ``E = U diag(s) V^T``, s descending, from the
    eigendecomposition of E^T E: ``method="jacobi"`` (the default,
    ``sweeps`` cyclic Jacobi sweeps) or ``"analytic"`` (``eigh3x3``)."""
    if method not in ("analytic", "jacobi"):
        raise ValueError(f"svd3x3: unknown method {method!r}")
    G = torch.einsum("...ji,...jk->...ik", E, E)
    if method == "analytic":
        w, V = eigh3x3(G)
    else:
        w, V = jacobi_eigh(G, sweeps=sweeps, sort=True)
    w = torch.flip(w, dims=(-1,))
    V = torch.flip(V, dims=(-1,))
    s = torch.sqrt(torch.clamp(w, min=0.0))
    U, u2 = _orthonormal_u_from(E, V, s)
    V = _align_v2(E, V, u2)
    return U, s, V


@f32_matmul
def project_to_essential(E, *, sweeps: int = 8):
    """Nearest matrices with singular values (1, 1, 0)."""
    U, _, V = svd3x3(E, sweeps=sweeps)
    d = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return torch.einsum("...ik,k,...jk->...ij", U, d, V)


@f32_matmul
def so3_project(M, *, sweeps: int = 8):
    """Nearest rotation matrices (polar decomposition, det = +1):
    R = U diag(1, 1, det(U V^T)) V^T."""
    U, _, V = svd3x3(M, sweeps=sweeps)
    det = det3(torch.einsum("...ik,...jk->...ij", U, V))
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    return torch.einsum("...ik,...k,...jk->...ij", U, d, V)


def cross_matrix(t):
    """Skew-symmetric [t]_x for ``t`` of shape [..., 3]."""
    z = torch.zeros_like(t[..., 0])
    return torch.stack(
        [
            torch.stack([z, -t[..., 2], t[..., 1]], dim=-1),
            torch.stack([t[..., 2], z, -t[..., 0]], dim=-1),
            torch.stack([-t[..., 1], t[..., 0], z], dim=-1),
        ],
        dim=-2,
    )
