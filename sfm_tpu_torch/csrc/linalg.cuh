// Device forms of ops/linalg.py's Jacobi routines, shared by K11
// (pnp_lo.cu) and K12 (pose.cu).
//
// Each mirrors its plain route operation by operation in f32.  Where the
// plain route runs one PyTorch elementwise operation per rounding, the
// code rounds once per operation with the _rn intrinsics, which nvcc
// never contracts into an FMA.  Where it runs a cuBLAS product (E^T E,
// E v, a 4 x 4 Gram), the code takes an FMA chain over the inner index
// in ascending order.  Where it runs a PyTorch reduction over the last
// dimension (vector_norm, sum), the code adds in that reduction's order:
// three values as (a0 + a2) + a1, four as (a0 + a1) + (a2 + a3).  So a
// kernel and its plain route differ by the rounding of cuBLAS's and the
// reductions' own orders, where those differ from the above, and by
// nothing else.
#pragma once

#include <cuda_runtime.h>

namespace linalg {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// A cuBLAS product's entry: a0 b0 + a1 b1 + a2 b2 as an FMA chain.
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return fmaf(a2, b2, fmaf(a1, b1, mul(a0, b0)));
}

// A PyTorch reduction over a last dimension of 3 or 4.
__device__ __forceinline__ float sum3(float a0, float a1, float a2) {
  return add(add(a0, a2), a1);
}
__device__ __forceinline__ float norm3(float a0, float a1, float a2) {
  return __fsqrt_rn(sum3(mul(a0, a0), mul(a1, a1), mul(a2, a2)));
}
__device__ __forceinline__ float norm4(float a0, float a1, float a2, float a3) {
  return __fsqrt_rn(add(add(mul(a0, a0), mul(a1, a1)), add(mul(a2, a2), mul(a3, a3))));
}

// det3 of [3, 3] row-major, one rounding per operation.
__device__ __forceinline__ float det3(const float b[9]) {
  return add(sub(mul(b[0], sub(mul(b[4], b[8]), mul(b[5], b[7]))),
                 mul(b[1], sub(mul(b[3], b[8]), mul(b[5], b[6])))),
             mul(b[2], sub(mul(b[3], b[7]), mul(b[4], b[6]))));
}

// torch.linalg.cross: one PyTorch kernel, whose a*b - c*d nvcc contracts.
__device__ __forceinline__ void cross(const float a[3], const float b[3], float c[3]) {
  c[0] = fmaf(a[1], b[2], -mul(a[2], b[1]));
  c[1] = fmaf(a[2], b[0], -mul(a[0], b[2]));
  c[2] = fmaf(a[0], b[1], -mul(a[1], b[0]));
}

// _jacobi_rotation: (c, s), the identity where |apq| <= 1e-36.
__device__ __forceinline__ void jacobi_rotation(float app, float aqq, float apq, float& c,
                                                float& s) {
  const bool small = fabsf(apq) <= 1e-36f;
  const float tau = div(sub(aqq, app), mul(2.f, small ? 1.f : apq));
  const float sg = tau > 0.f ? 1.f : (tau < 0.f ? -1.f : tau);
  float t = div(sg, add(fabsf(tau), __fsqrt_rn(add(mul(tau, tau), 1.f))));
  if (tau == 0.f) t = 1.f;
  c = div(1.f, __fsqrt_rn(add(mul(t, t), 1.f)));
  s = mul(t, c);
  if (small) {
    c = 1.f;
    s = 0.f;
  }
}

// jacobi_eigh's sweeps on a symmetric [N, N] A (row-major, already
// symmetrised) with V = I on entry: the cyclic (p, q) order, each
// rotation applied to A's columns, then its rows, then V's columns.
template <int N>
__device__ __forceinline__ void jacobi_sweeps(float (&A)[N * N], float (&V)[N * N], int sweeps) {
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        float c, s;
        jacobi_rotation(A[N * p + p], A[N * q + q], A[N * p + q], c, s);
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float ap = A[N * i + p], aq = A[N * i + q];
          A[N * i + p] = sub(mul(c, ap), mul(s, aq));
          A[N * i + q] = add(mul(s, ap), mul(c, aq));
        }
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const float ap = A[N * p + j], aq = A[N * q + j];
          A[N * p + j] = sub(mul(c, ap), mul(s, aq));
          A[N * q + j] = add(mul(s, ap), mul(c, aq));
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float vp = V[N * i + p], vq = V[N * i + q];
          V[N * i + p] = sub(mul(c, vp), mul(s, vq));
          V[N * i + q] = add(mul(s, vp), mul(c, vq));
        }
      }
    }
  }
}

// svd3x3 (method "jacobi"): E = U diag(s) V^T, s descending, all
// [3, 3] row-major: `sweeps` Jacobi sweeps over E^T E, eigenvalues
// sorted ascending by a stable sort and flipped (equal ones in reverse
// index order), U's first two columns from E V / s (_orthonormal_u_from
// with _safe_unit's e0 fallback), its third their cross product, V's
// third column turned so that E v2 aligns with u2 (_align_v2).
__device__ inline void svd3x3(const float E[9], int sweeps, float U[9], float s[3],
                               float V[9]) {
  float A[9], W[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      A[3 * i + k] = dot3(E[i], E[3 + i], E[6 + i], E[k], E[3 + k], E[6 + k]);
  float S[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) S[3 * i + k] = mul(0.5f, add(A[3 * i + k], A[3 * k + i]));
  jacobi_sweeps<3>(S, W, sweeps);
  // Eigenvalue j's place after the stable ascending sort is its rank
  // (the smaller ones, then the equal ones before it); after the flip,
  // 2 - rank.  Picked by selects: no array indexed at run time.
  const float w[3] = {S[0], S[4], S[8]};
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    int rank = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i) rank += (w[i] < w[j] || (i < j && w[i] == w[j])) ? 1 : 0;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (k == 2 - rank) {
        s[k] = __fsqrt_rn(clamp_min(w[j], 0.f));
#pragma unroll
        for (int i = 0; i < 3; ++i) V[3 * i + k] = W[3 * i + j];
      }
  }
  float u0[3], u1[3], u2[3];
  const float s0 = clamp_min(s[0], 1e-20f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    u0[i] = div(dot3(E[3 * i], E[3 * i + 1], E[3 * i + 2], V[0], V[3], V[6]), s0);
    u1[i] = dot3(E[3 * i], E[3 * i + 1], E[3 * i + 2], V[1], V[4], V[7]);
  }
  const float n0 = norm3(u0[0], u0[1], u0[2]);
  const bool ok0 = n0 > 1e-12f;
#pragma unroll
  for (int i = 0; i < 3; ++i) u0[i] = ok0 ? div(u0[i], n0) : (i == 0 ? 1.f : 0.f);
  const float dt = sum3(mul(u1[0], u0[0]), mul(u1[1], u0[1]), mul(u1[2], u0[2]));
#pragma unroll
  for (int i = 0; i < 3; ++i) u1[i] = sub(u1[i], mul(dt, u0[i]));
  const float n1 = norm3(u1[0], u1[1], u1[2]);
  const bool ok1 = n1 > 1e-12f;
  const float pa[3] = {-u0[1], u0[0], 0.f}, pb[3] = {0.f, -u0[2], u0[1]};
  const float na = norm3(pa[0], pa[1], pa[2]), nb = norm3(pb[0], pb[1], pb[2]);
  const bool use_a = na > 0.5f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    u1[i] = ok1 ? div(u1[i], n1)
                : (use_a ? div(pa[i], clamp_min(na, 1e-12f)) : div(pb[i], clamp_min(nb, 1e-12f)));
  cross(u0, u1, u2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    U[3 * i] = u0[i];
    U[3 * i + 1] = u1[i];
    U[3 * i + 2] = u2[i];
  }
  float e[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    e[i] = mul(dot3(E[3 * i], E[3 * i + 1], E[3 * i + 2], V[2], V[5], V[8]), u2[i]);
  const float sg = sum3(e[0], e[1], e[2]) < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) V[3 * i + 2] = mul(V[3 * i + 2], sg);
}

}  // namespace linalg
