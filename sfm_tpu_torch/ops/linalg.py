"""Batched small-matrix linear algebra (counterpart of
``sfm_tpu/ops/linalg.py``).

Only what the two-view and multi-view paths call is ported, with the
SAME fixed-sweep algorithms: cyclic Jacobi for symmetric eigenproblems,
the 3x3 SVD built on it (and the polar factor ``so3_project``),
Householder QR for the minimal 8x9 null vectors and ridge inverse
iteration for the least-squares polish.  ``torch.linalg.eigh`` or
``svd`` are deliberately not substituted: near-degenerate 3x3s
(the essential-matrix case s ~ (1, 1, 0)) pick their eigenvector
directions by the algorithm, and parity with the JAX package depends
on it.
"""

from __future__ import annotations

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
def svd3x3(E, *, sweeps: int = 8):
    """Batched 3x3 SVD ``E = U diag(s) V^T``, s descending, via the
    fixed-sweep Jacobi eigendecomposition of E^T E (the JAX package's
    default ``method="jacobi"``)."""
    G = torch.einsum("...ji,...jk->...ik", E, E)
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
