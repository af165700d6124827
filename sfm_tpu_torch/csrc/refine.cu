// K10: the two-view pose refinement (refine_relative_pose), its whole
// damped Gauss-Newton / Levenberg loop on SO(3) x S^2 in one launch.
//
// Replaces no TPU kernel: the JAX package runs this refinement through
// jax.jacfwd under XLA (sfm_tpu/geometry/refine.py).  The port's plain
// route (geometry/refine.py:refine_relative_pose_plain) takes five
// torch.func.jvp passes, the J^T W J products, a batched 5 x 5 solve and
// a trial pass per step: ~1.2k launches and host syncs for ~300 f32
// operations per point.  See sfm_tpu_torch/geometry/refine.py for the
// contract.
//
// What bounds it: nothing of the card's rate or bandwidth.  A step is
// ~350 f32 operations per correspondence (2,560 on the bench path) and
// reads 28 bytes of each; the loop is a dependent chain: per step two
// passes over the points, two block-wide reductions and one serial 5 x 5
// solve, so its time is latency.
//
// Design.  One block per start (the probe's 8, the rounds' 1); `iters`
// steps run inside the block and the accept / reject decision is the
// block's, so the loop needs nothing from the host.  Thread i takes
// points i, i + 512, ...: pass 1 evaluates each point's Sampson residual
// at the current pose with its five derivatives written out (dE/dw_k =
// [t]x R [e_k]x for the rotation, dE/db_j = [b_j]x R for the two columns
// of tangent_basis(t): what jvp gives at params = 0, t being unit) and
// accumulates the 15 upper-triangle entries of J^T W J and the 5 of
// J^T W r; a warp butterfly then one partial per warp reduce them.
// Thread 0 damps, solves by LU with partial pivoting (as solve_ex), and
// forms the trial pose (so3_exp with its Taylor guard, tangent_basis
// with its |t0| < 0.9 switch); pass 2 sums the Huber cost there; thread
// 0 accepts iff it is lower.  The residuals are not stored: pass 1
// evaluates them at the kept pose, where the plain route keeps the
// trial's, the same values up to the re-normalisation of t after a
// rejected step.  x1, x2 and the weights (28 bytes a point, 72 KB at
// 2,560) are read each pass through the read-only path, from L1 / L2.
// Plain f32: no TF32, no fast-math intrinsics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kParams = 5;
constexpr int kSums = 20;   // J^T W J's 15 upper-triangle entries, then J^T W r's 5

struct Params {
  const float* R0;   // [B, 3, 3]
  const float* t0;   // [B, 3]
  const float* x1;   // [n, 3]
  const float* x2;   // [n, 3]
  const float* w;    // [B or 1, n] (row b at b * w_stride) or null: all 1
  int w_stride, n, iters;
  float huber_delta, damping;
  float* R;          // [B, 3, 3]
  float* t;          // [B, 3]
  float* E;          // [B, 3, 3]
  float* cost;       // [B]
  float* cost0;      // [B]
};

// 3 x 3 matrices are row-major float[9].
__device__ __forceinline__ void cross_matrix(const float v[3], float m[9]) {
  m[0] = 0.f;   m[1] = -v[2]; m[2] = v[1];
  m[3] = v[2];  m[4] = 0.f;   m[5] = -v[0];
  m[6] = -v[1]; m[7] = v[0];  m[8] = 0.f;
}

__device__ __forceinline__ void matmul3(const float a[9], const float b[9], float c[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3], float c[3]) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void unit3(float v[3]) {
  const float n = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  v[0] = v[0] / n;
  v[1] = v[1] / n;
  v[2] = v[2] / n;
}

// E = [t]x R.
__device__ __forceinline__ void essential(const float t[3], const float R[9], float E[9]) {
  float tx[9];
  cross_matrix(t, tx);
  matmul3(tx, R, E);
}

// Rodrigues, Taylor-guarded at 0 (geometry/lie.py so3_exp).
__device__ void so3_exp(const float w[3], float R[9]) {
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float theta = sqrtf(fmaxf(theta2, 1e-24f));
  const bool small = theta2 < 1e-12f;
  const float a = small ? 1.f - theta2 / 6.f : sinf(theta) / theta;
  const float b = small ? 0.5f - theta2 / 24.f : (1.f - cosf(theta)) / theta2;
  float K[9], K2[9];
  cross_matrix(w, K);
  matmul3(K, K, K2);
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = (i % 4 == 0 ? 1.f : 0.f) + a * K[i] + b * K2[i];
}

// Orthonormal basis (b1, b2) of the plane perpendicular to t
// (geometry/lie.py tangent_basis).
__device__ void tangent_basis(const float t_in[3], float b1[3], float b2[3]) {
  float t[3] = {t_in[0], t_in[1], t_in[2]};
  unit3(t);
  const bool x_ok = fabsf(t[0]) < 0.9f;
  const float a[3] = {x_ok ? 1.f : 0.f, x_ok ? 0.f : 1.f, 0.f};
  cross3(t, a, b1);
  unit3(b1);
  cross3(t, b1, b2);
}

__device__ __forceinline__ float huber_cost(float r, float d) {
  const float a = fabsf(r);
  return a <= d ? 0.5f * r * r : d * (a - 0.5f * d);
}

__device__ __forceinline__ float weight(const float* w, int i) {
  return w == nullptr ? 1.f : __ldg(w + i);
}

__device__ __forceinline__ void load_point(const float* x, int i, float p[3]) {
  p[0] = __ldg(x + 3 * i);
  p[1] = __ldg(x + 3 * i + 1);
  p[2] = __ldg(x + 3 * i + 2);
}

// Epipolar lines l1 = E x1 and (the first two entries of) l2 = E^T x2.
__device__ __forceinline__ void lines(const float e[9], const float a[3], const float b[3],
                                      float l1[3], float l2[2]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) l1[i] = e[3 * i] * a[0] + e[3 * i + 1] * a[1] + e[3 * i + 2] * a[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) l2[i] = e[i] * b[0] + e[3 + i] * b[1] + e[6 + i] * b[2];
}

// Sum v[0..K) over the block; the sums land in out[0..K) (shared), read
// after the call.  Warp butterflies, then one partial per warp summed
// in warp order: the same order every launch.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float (*part)[kSums], float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) part[warp][k] = v[k];
  __syncthreads();
  if (threadIdx.x < K) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += part[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

struct State {
  float R[9], t[3], E[9];    // the kept pose and its E
  float dE[kParams][9];      // dE / d(w0, w1, w2, b0, b1) at the kept pose
  float b1[3], b2[3];        // tangent_basis(t)
  float Rn[9], tn[3], En[9]; // the trial pose
  float lam, cost;
};

// This thread's share of the Huber cost sum(w * rho(r)) at E.
__device__ float cost_pass(const Params& p, const float* w, const float (&Es)[9]) {
  float e[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) e[i] = Es[i];
  float c = 0.f;
  for (int i = threadIdx.x; i < p.n; i += kThreads) {
    float a[3], b[3], l1[3], l2[2];
    load_point(p.x1, i, a);
    load_point(p.x2, i, b);
    lines(e, a, b, l1, l2);
    const float num = b[0] * l1[0] + b[1] * l1[1] + b[2] * l1[2];
    const float den = l1[0] * l1[0] + l1[1] * l1[1] + l2[0] * l2[0] + l2[1] * l2[1];
    const float r = num / sqrtf(fmaxf(den, 1e-18f));
    c += huber_cost(r, p.huber_delta) * weight(w, i);
  }
  return c;
}

// This thread's share of J^T W J (upper triangle, row by row) and
// J^T W r at the kept pose, W = w * the residuals' Huber weights.
__device__ void normal_pass(const Params& p, const float* w, const State& st,
                            float (&acc)[kSums]) {
  float e[9], de[kParams][9];
#pragma unroll
  for (int i = 0; i < 9; ++i) e[i] = st.E[i];
#pragma unroll
  for (int k = 0; k < kParams; ++k)
#pragma unroll
    for (int i = 0; i < 9; ++i) de[k][i] = st.dE[k][i];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
  const float d = p.huber_delta;
  for (int i = threadIdx.x; i < p.n; i += kThreads) {
    float a[3], b[3], l1[3], l2[2];
    load_point(p.x1, i, a);
    load_point(p.x2, i, b);
    lines(e, a, b, l1, l2);
    const float num = b[0] * l1[0] + b[1] * l1[1] + b[2] * l1[2];
    const float den = l1[0] * l1[0] + l1[1] * l1[1] + l2[0] * l2[0] + l2[1] * l2[1];
    const bool clamped = den < 1e-18f;   // torch.clamp's branch: no derivative
    const float s = sqrtf(fmaxf(den, 1e-18f));
    const float r = num / s;
    const float half_num_s3 = clamped ? 0.f : 0.5f * num / (s * s * s);
    float J[kParams];
#pragma unroll
    for (int k = 0; k < kParams; ++k) {
      float dl1[3], dl2[2];
      lines(de[k], a, b, dl1, dl2);
      const float dnum = b[0] * dl1[0] + b[1] * dl1[1] + b[2] * dl1[2];
      const float dden = 2.f * (l1[0] * dl1[0] + l1[1] * dl1[1] + l2[0] * dl2[0] +
                                l2[1] * dl2[1]);
      J[k] = dnum / s - half_num_s3 * dden;
    }
    const float ar = fabsf(r);
    const float hw = weight(w, i) * (ar <= d ? 1.f : d / fmaxf(ar, 1e-18f));
    int m = 0;
#pragma unroll
    for (int k = 0; k < kParams; ++k) {
      const float jw = J[k] * hw;
#pragma unroll
      for (int l = k; l < kParams; ++l) acc[m++] += jw * J[l];
      acc[15 + k] += jw * r;
    }
  }
}

// Thread 0: the derivatives of E at the kept pose.
__device__ void derivatives(State& st) {
  tangent_basis(st.t, st.b1, st.b2);
#pragma unroll
  for (int k = 0; k < 3; ++k) {   // [t]x R [e_k]x = E [e_k]x
    const float ek[3] = {k == 0 ? 1.f : 0.f, k == 1 ? 1.f : 0.f, k == 2 ? 1.f : 0.f};
    float ex[9];
    cross_matrix(ek, ex);
    matmul3(st.E, ex, st.dE[k]);
  }
  essential(st.b1, st.R, st.dE[3]);   // [b_j]x R
  essential(st.b2, st.R, st.dE[4]);
}

// Thread 0: damp, solve H delta = -g by LU with partial pivoting (the
// first largest pivot, as getrf), and form the trial pose.
__device__ void trial(const Params& p, State& st, const float* sums) {
  float A[kParams][kParams + 1];
  int m = 0;
#pragma unroll
  for (int k = 0; k < kParams; ++k)
#pragma unroll
    for (int l = k; l < kParams; ++l) A[k][l] = A[l][k] = sums[m++];
  float tr = 0.f;
#pragma unroll
  for (int k = 0; k < kParams; ++k) tr += A[k][k];
  tr = tr / 5.f;
  const float damp = (p.damping + st.lam) * fmaxf(tr, 1e-12f);
#pragma unroll
  for (int k = 0; k < kParams; ++k) {
    A[k][k] += damp;
    A[k][kParams] = sums[15 + k];
  }
#pragma unroll
  for (int c = 0; c < kParams; ++c) {
    int piv = c;
    float best = fabsf(A[c][c]);
#pragma unroll
    for (int r = c + 1; r < kParams; ++r)
      if (fabsf(A[r][c]) > best) {
        best = fabsf(A[r][c]);
        piv = r;
      }
#pragma unroll
    for (int r = c + 1; r < kParams; ++r)
      if (r == piv)
#pragma unroll
        for (int j = c; j <= kParams; ++j) {
          const float tmp = A[r][j];
          A[r][j] = A[c][j];
          A[c][j] = tmp;
        }
#pragma unroll
    for (int r = c + 1; r < kParams; ++r) {
      const float f = A[r][c] / A[c][c];
#pragma unroll
      for (int j = c + 1; j <= kParams; ++j) A[r][j] -= f * A[c][j];
    }
  }
  float delta[kParams];
#pragma unroll
  for (int r = kParams - 1; r >= 0; --r) {
    float s = A[r][kParams];
#pragma unroll
    for (int j = r + 1; j < kParams; ++j) s -= A[r][j] * delta[j];
    delta[r] = s / A[r][r];
  }
#pragma unroll
  for (int k = 0; k < kParams; ++k) delta[k] = -delta[k];
  float dR[9];
  so3_exp(delta, dR);
  matmul3(st.R, dR, st.Rn);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    st.tn[i] = st.t[i] + (st.b1[i] * delta[3] + st.b2[i] * delta[4]);
  unit3(st.tn);
  essential(st.tn, st.Rn, st.En);
}

// Thread 0: keep the trial pose iff its cost is lower.
__device__ void accept(State& st, float cost_new) {
  const bool ok = cost_new < st.cost;
  if (ok) {
#pragma unroll
    for (int i = 0; i < 9; ++i) st.R[i] = st.Rn[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) st.t[i] = st.tn[i];
    st.cost = cost_new;
  } else {
    unit3(st.t);   // the plain route's t + B * 0, re-normalised
  }
  st.lam = fminf(fmaxf(ok ? st.lam * 0.33f : st.lam * 8.f, 1e-10f), 1e4f);
  essential(st.t, st.R, st.E);
}

__global__ void __launch_bounds__(kThreads) refine_kernel(Params p) {
  __shared__ State st;
  __shared__ float part[kWarps][kSums];
  __shared__ float sums[kSums];
  const int b = blockIdx.x;
  const float* w = p.w == nullptr ? nullptr : p.w + (int64_t)b * p.w_stride;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) st.R[i] = p.R0[9 * b + i];
#pragma unroll
    for (int i = 0; i < 3; ++i) st.t[i] = p.t0[3 * b + i];
    unit3(st.t);
    essential(st.t, st.R, st.E);
    st.lam = 1e-4f;
  }
  __syncthreads();
  float c[1] = {cost_pass(p, w, st.E)};
  block_sum<1>(c, part, sums);
  if (threadIdx.x == 0) {
    st.cost = sums[0];
    p.cost0[b] = sums[0];
  }
  for (int it = 0; it < p.iters; ++it) {
    if (threadIdx.x == 0) derivatives(st);
    __syncthreads();
    float acc[kSums];
    normal_pass(p, w, st, acc);
    block_sum<kSums>(acc, part, sums);
    if (threadIdx.x == 0) trial(p, st, sums);
    __syncthreads();
    float cn[1] = {cost_pass(p, w, st.En)};
    block_sum<1>(cn, part, sums);
    if (threadIdx.x == 0) accept(st, sums[0]);
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      p.R[9 * b + i] = st.R[i];
      p.E[9 * b + i] = st.E[i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) p.t[3 * b + i] = st.t[i];
    p.cost[b] = st.cost;
  }
}

}  // namespace

// B starts (R0 [B, 3, 3], t0 [B, 3]) refined independently against the
// n correspondences x1, x2 ([n, 3] each) for `iters` steps; weights w
// ([n] with w_stride 0, [B, n] with w_stride n, or null for all ones);
// f32, dense row-major, on the card.  Writes R, t, E ([B, 3, 3], [B, 3],
// [B, 3, 3]), the final and the initial cost ([B] each).
extern "C" int sfm_refine_relative_pose(const void* R0, const void* t0, const void* x1,
                                        const void* x2, const void* w, int w_stride,
                                        int B, int n, int iters, float huber_delta,
                                        float damping, void* R, void* t, void* E,
                                        void* cost, void* cost0, void* stream) {
  if (B < 1 || n < 0 || iters < 0 || w_stride < 0) return (int)cudaErrorInvalidValue;
  Params p{(const float*)R0, (const float*)t0, (const float*)x1, (const float*)x2,
           (const float*)w, w_stride, n, iters, huber_delta, damping,
           (float*)R, (float*)t, (float*)E, (float*)cost, (float*)cost0};
  refine_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
