// K11: PnP's local optimisation (the LO stage of ransac_pnp), its three
// annealed rounds of Gauss-Newton polishes and weighted DLT refits in
// one launch.
//
// Replaces no TPU kernel: the JAX package leaves the LO stage of
// sfm_tpu/geometry/pnp.py:ransac_pnp to XLA.  The port's plain route
// (geometry/pnp.py:pnp_lo_plain) runs it as ~8k PyTorch launches a
// round: two refine_pose chains of 8 damped steps (~1.9k each), the
// weighted pnp_dlt (~4.1k, ~3.9k of them in its two 3 x 3 Jacobi SVDs)
// and a host sync per refit (_safe_unit's constant).  See
// sfm_tpu_torch/geometry/pnp.py for the contract.
//
// What bounds it: nothing of the card's rate or bandwidth.  A call is
// ~61 passes over N <= 15,360 rows (the registration's 3 previous
// frames x 5,120 slots), ~150 f32 operations and 32 bytes a row each,
// and every pass waits for the one before: a step's trial pose needs
// the last pass's 28 sums and a serial 6 x 6 solve, a refit's pose the
// 40 sums of its Gram, an LU of the 12 x 12 ridge matrix and two Jacobi
// SVDs.  So its time is the chain's latency: per pass the slowest
// slice of rows, the reductions and the serial solve.
//
// Design.  One thread block cluster of 8 blocks (distributed shared
// memory); block k owns the k-th eighth of the rows and its threads own
// fixed rows, staged once into a scratch of two float4 a row (X, u; v,
// the mask, the round's gate weight), which the block alone reads and
// writes, so the rows stay in its SM's L1 between passes.  Each pass
// reduces in one fixed order: a warp butterfly, the warps in order, then
// the cluster's 8 blocks in rank order through DSMEM after one
// cluster.sync() (two buffers by pass parity, so one barrier a pass
// suffices).  Every block sums the same values in the same order, so
// each runs the serial step itself and no broadcast is needed; no
// atomics, so a call repeats bit for bit.  The step's candidate cost and
// the J^T W J, J^T W r at the candidate come from one pass and are
// adopted on accept; on reject the kept ones are reused (the plain
// route's R @ so3_exp(0) and t + 0 are the same pose).  The refit
// factors the ridge matrix once by a warp-wide LU with partial pivoting
// (a row a lane) for its 8 solves; the Gram is summed as its four
// symmetric 4 x 4 blocks.  Thread 0 solves the damped 6 x 6 system by
// LU with partial pivoting, as solve_ex.  Plain f32: no TF32, no
// fast-math intrinsics.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocks = 8;          // the cluster
constexpr int kMaxRounds = 4;
constexpr int kNormalSums = 28;     // J^T W J's 21 (upper triangle, row by row), J^T W r's 6, cost
constexpr int kGateSums = 29;       // the same and the strict count at the pose
constexpr int kGramSums = 40;       // the Gram's blocks S, U, V, Q, 10 each (4 x 4 upper triangles)
constexpr int kMaxSums = 40;

struct Params {
  const float* x;        // [n, 3] observations
  const float* X;        // [n, 3] conditioned points
  const uint8_t* mask;   // [n] bool
  const float* R0;       // [3, 3] the LO's start
  const float* t0;       // [3]
  float4* rows;          // [2 n] scratch: (X, u), (v, mask, the round's gate weight, 0)
  int n, iters, rounds;
  float threshold, huber_delta;
  float gate[kMaxRounds];  // each round's gate: threshold x its multiplier
  float* R;              // [3, 3] the kept pose
  float* t;              // [3]
  int* count;            // [1] its strict inliers
  uint8_t* inliers;      // [n] bool
};

struct Pose {
  float R[9], t[3];
};

struct Shared {
  float part[kWarps][kMaxSums];
  float mine[2][kMaxSums];   // this block's sums, read across the cluster (by pass parity)
  float sums[kMaxSums];      // the cluster's sums: the same in every block
  Pose at, at2;              // the poses the next pass evaluates
  Pose cur;                  // a chain's kept pose, and its normal equations and cost
  float H[21], g[6], cost, lam;
  Pose best, one;            // the incumbent; the round's better chain
  float c_best, gate_count;
  float p[12];               // the refit's null vector
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

__device__ __forceinline__ float det3(const float b[9]) {
  return b[0] * (b[4] * b[8] - b[5] * b[7]) - b[1] * (b[3] * b[8] - b[5] * b[6]) +
         b[2] * (b[3] * b[7] - b[4] * b[6]);
}

__device__ __forceinline__ float norm3(const float v[3]) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

__device__ __forceinline__ void copy_pose(const Pose& a, Pose& b) {
#pragma unroll
  for (int i = 0; i < 9; ++i) b.R[i] = a.R[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) b.t[i] = a.t[i];
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

// The symmetric Jacobi rotation (c, s) of ops/linalg.py _jacobi_rotation.
__device__ __forceinline__ void jacobi_rotation(float app, float aqq, float apq, float& c,
                                                float& s) {
  const bool small = fabsf(apq) <= 1e-36f;
  const float tau = (aqq - app) / (2.f * (small ? 1.f : apq));
  const float sg = tau > 0.f ? 1.f : (tau < 0.f ? -1.f : 0.f);
  float t = sg / (fabsf(tau) + sqrtf(1.f + tau * tau));
  if (tau == 0.f) t = 1.f;
  c = 1.f / sqrtf(1.f + t * t);
  s = t * c;
  if (small) {
    c = 1.f;
    s = 0.f;
  }
}

// u / |u| where |u| > 1e-12, else the fallback e0 (linalg._safe_unit).
__device__ __forceinline__ void safe_unit_e0(float u[3]) {
  const float n = norm3(u);
  const bool ok = n > 1e-12f;
  const float d = ok ? n : 1.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) u[i] = ok ? u[i] / d : (i == 0 ? 1.f : 0.f);
}

// ops/linalg.py svd3x3 (method "jacobi", 8 sweeps): E = U diag(s) V^T,
// s descending, from 8 cyclic Jacobi sweeps over E^T E, U's first two
// columns from E V / s, its third their cross product, V's third column
// turned so that E v2 aligns with u2.
__device__ void svd3x3(const float E[9], float U[9], float s[3], float V[9]) {
  float A[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      A[3 * i + k] = E[i] * E[k] + E[3 + i] * E[3 + k] + E[6 + i] * E[6 + k];
  float S[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) S[3 * i + k] = 0.5f * (A[3 * i + k] + A[3 * k + i]);
  float W[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
  for (int sweep = 0; sweep < 8; ++sweep) {
#pragma unroll
    for (int pq = 0; pq < 3; ++pq) {
      const int p = pq == 2 ? 1 : 0, q = pq == 0 ? 1 : 2;
      float c, sn;
      jacobi_rotation(S[4 * p], S[4 * q], S[3 * p + q], c, sn);
      float cp[3], cq[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        cp[i] = S[3 * i + p];
        cq[i] = S[3 * i + q];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        S[3 * i + p] = c * cp[i] - sn * cq[i];
        S[3 * i + q] = sn * cp[i] + c * cq[i];
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        cp[j] = S[3 * p + j];
        cq[j] = S[3 * q + j];
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        S[3 * p + j] = c * cp[j] - sn * cq[j];
        S[3 * q + j] = sn * cp[j] + c * cq[j];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        cp[i] = W[3 * i + p];
        cq[i] = W[3 * i + q];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        W[3 * i + p] = c * cp[i] - sn * cq[i];
        W[3 * i + q] = sn * cp[i] + c * cq[i];
      }
    }
  }
  // Eigenvalues ascending by a stable sort, then flipped: descending,
  // equal ones in reverse index order.
  const float w[3] = {S[0], S[4], S[8]};
  int o[3] = {0, 1, 2};
#pragma unroll
  for (int i = 1; i < 3; ++i)
#pragma unroll
    for (int j = i; j > 0; --j)
      if (w[o[j]] < w[o[j - 1]]) {
        const int tmp = o[j];
        o[j] = o[j - 1];
        o[j - 1] = tmp;
      }
  int d[3] = {o[2], o[1], o[0]};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s[k] = sqrtf(fmaxf(w[d[k]], 0.f));
#pragma unroll
    for (int i = 0; i < 3; ++i) V[3 * i + k] = W[3 * i + d[k]];
  }
  // U (linalg._orthonormal_u_from).
  float u0[3], u1[3], u2[3];
  const float s0 = fmaxf(s[0], 1e-20f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    u0[i] = (E[3 * i] * V[0] + E[3 * i + 1] * V[3] + E[3 * i + 2] * V[6]) / s0;
    u1[i] = E[3 * i] * V[1] + E[3 * i + 1] * V[4] + E[3 * i + 2] * V[7];
  }
  safe_unit_e0(u0);
  const float dot = u1[0] * u0[0] + u1[1] * u0[1] + u1[2] * u0[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) u1[i] = u1[i] - dot * u0[i];
  const float n1 = norm3(u1);
  const bool ok1 = n1 > 1e-12f;
  const float pa[3] = {-u0[1], u0[0], 0.f}, pb[3] = {0.f, -u0[2], u0[1]};
  const float na = norm3(pa), nb = norm3(pb);
  const bool use_a = na > 0.5f;
  const float dn = ok1 ? n1 : 1.f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    u1[i] = ok1 ? u1[i] / dn : (use_a ? pa[i] / fmaxf(na, 1e-12f) : pb[i] / fmaxf(nb, 1e-12f));
  u2[0] = u0[1] * u1[2] - u0[2] * u1[1];
  u2[1] = u0[2] * u1[0] - u0[0] * u1[2];
  u2[2] = u0[0] * u1[1] - u0[1] * u1[0];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    U[3 * i] = u0[i];
    U[3 * i + 1] = u1[i];
    U[3 * i + 2] = u2[i];
  }
  // linalg._align_v2.
  float dv = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    dv += (E[3 * i] * V[2] + E[3 * i + 1] * V[5] + E[3 * i + 2] * V[8]) * u2[i];
  const float sg = dv < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) V[3 * i + 2] *= sg;
}

// Nearest rotation, R = U diag(1, 1, det(U V^T)) V^T (linalg.so3_project).
__device__ void so3_project(const float M[9], float R[9]) {
  float U[9], s[3], V[9], UV[9];
  svd3x3(M, U, s, V);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      UV[3 * i + j] = U[3 * i] * V[3 * j] + U[3 * i + 1] * V[3 * j + 1] + U[3 * i + 2] * V[3 * j + 2];
  const float d = det3(UV);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      R[3 * i + j] = U[3 * i] * V[3 * j] + U[3 * i + 1] * V[3 * j + 1] + U[3 * i + 2] * d * V[3 * j + 2];
}

// Sum v[0..K) over the cluster: warp butterflies, the warps in order,
// then the blocks in rank order; the sums land in sh.sums[0..K) in
// every block, read after the call.
template <int K, int N>
__device__ __forceinline__ void cluster_sum(float (&v)[N], Shared& sh, cg::cluster_group& cluster,
                                            int& parity) {
  static_assert(K <= N && K <= kMaxSums && K <= kThreads, "cluster_sum: too many sums");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) sh.part[warp][k] = v[k];
  __syncthreads();
  float* mine = sh.mine[parity];
  if (threadIdx.x < K) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += sh.part[w][threadIdx.x];
    mine[threadIdx.x] = s;
  }
  cluster.sync();
  if (threadIdx.x < K) {
    float s = 0.f;
    for (int r = 0; r < kBlocks; ++r) s += cluster.map_shared_rank(mine, r)[threadIdx.x];
    sh.sums[threadIdx.x] = s;
  }
  parity ^= 1;
  __syncthreads();
}

__device__ __forceinline__ void load_pose(const Pose& a, float R[9], float t[3]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = a.R[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = a.t[i];
}

// The squared reprojection error of a row at (R, t), 1e6 behind the
// camera (pnp.reprojection_residuals), and the residual (r0, r1) with
// what the Jacobian needs (projection_jacobians).
struct Proj {
  float z, inv, dz, p0, p1, r0, r1, sq;
};

__device__ __forceinline__ Proj project(const float R[9], const float t[3], float X0, float X1,
                                        float X2, float u, float v) {
  Proj q;
  const float xc0 = R[0] * X0 + R[1] * X1 + R[2] * X2 + t[0];
  const float xc1 = R[3] * X0 + R[4] * X1 + R[5] * X2 + t[1];
  q.z = R[6] * X0 + R[7] * X1 + R[8] * X2 + t[2];
  const bool small = fabsf(q.z) < 1e-8f;
  const float zs = small ? 1e-8f : q.z;
  q.p0 = xc0 / zs;
  q.p1 = xc1 / zs;
  q.inv = 1.f / zs;
  q.dz = small ? 0.f : q.inv;
  q.r0 = q.p0 - u;
  q.r1 = q.p1 - v;
  q.sq = q.r0 * q.r0 + q.r1 * q.r1;
  return q;
}

// This thread's share of J^T W J, J^T W r and the Huber cost at sh.at,
// W the rows' gate weights times their Huber weights (refine_pose).
// With Gate, the round's gate weight of each row is set here first, at
// this pose, and acc[28] counts its strict inliers.
template <bool Gate>
__device__ void normal_pass(const Params& p, const Shared& sh, int lo, int hi, float gate,
                            float (&acc)[kGateSums]) {
  float R[9], t[3];
  load_pose(sh.at, R, t);
#pragma unroll
  for (int k = 0; k < kGateSums; ++k) acc[k] = 0.f;
  const float d = p.huber_delta, half_d = 0.5f * p.huber_delta;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float4 a = p.rows[2 * i];
    float4 b = p.rows[2 * i + 1];
    const Proj q = project(R, t, a.x, a.y, a.z, a.w, b.x);
    float w_in;
    if (Gate) {
      const float sq = q.z > 0.f ? q.sq : 1e6f;
      const bool live = b.y != 0.f;
      w_in = (sq < gate && live) ? 1.f : 0.f;
      b.z = w_in;
      p.rows[2 * i + 1] = b;
      acc[28] += (sq < p.threshold && live) ? 1.f : 0.f;
    } else {
      w_in = b.z;
    }
    const float rn = sqrtf(fmaxf(q.sq, 1e-24f));
    const bool inner = rn <= d;
    acc[27] += (inner ? 0.5f * q.sq : d * (rn - half_d)) * w_in;
    const float w = w_in * (inner ? 1.f : d / rn);
    // d(R exp(w) X)/dw = -R [X]x; J = Jproj [-R [X]x | I].
    float D[9];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      D[3 * r] = R[3 * r + 2] * a.y - R[3 * r + 1] * a.z;
      D[3 * r + 1] = R[3 * r] * a.z - R[3 * r + 2] * a.x;
      D[3 * r + 2] = R[3 * r + 1] * a.x - R[3 * r] * a.y;
    }
    const float e0 = -q.p0 * q.dz, e1 = -q.p1 * q.dz;
    float J0[6], J1[6];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      J0[j] = q.inv * D[j] + e0 * D[6 + j];
      J1[j] = q.inv * D[3 + j] + e1 * D[6 + j];
    }
    J0[3] = q.inv; J0[4] = 0.f;   J0[5] = e0;
    J1[3] = 0.f;   J1[4] = q.inv; J1[5] = e1;
    int m = 0;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float a0 = J0[k] * w, a1 = J1[k] * w;
#pragma unroll
      for (int l = k; l < 6; ++l) acc[m++] += a0 * J0[l] + a1 * J1[l];
      acc[21 + k] += a0 * q.r0 + a1 * q.r1;
    }
  }
}

// This thread's share of the weighted DLT Gram sum_n w A_n^T A_n, A_n
// the rows [Xh 0 -u Xh; 0 Xh -v Xh] (pnp._dlt_rows), as its blocks:
// S = sum w Xh Xh^T, U = sum w u Xh Xh^T, V = sum w v Xh Xh^T and
// Q = sum w (u^2 + v^2) Xh Xh^T, each as its 10 upper-triangle entries.
__device__ void gram_pass(const Params& p, int lo, int hi, float (&acc)[kGramSums]) {
#pragma unroll
  for (int k = 0; k < kGramSums; ++k) acc[k] = 0.f;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float4 a = p.rows[2 * i];
    const float4 b = p.rows[2 * i + 1];
    const float w = b.z, u = a.w, v = b.x;
    const float Xh[4] = {a.x, a.y, a.z, 1.f};
    float wX[4], uX[4], vX[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wX[k] = w * Xh[k];
      uX[k] = u * Xh[k];
      vX[k] = v * Xh[k];
    }
    int m = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int l = k; l < 4; ++l) {
        acc[m] += wX[k] * Xh[l];
        acc[10 + m] += wX[k] * uX[l];
        acc[20 + m] += wX[k] * vX[l];
        acc[30 + m] += (w * uX[k]) * uX[l] + (w * vX[k]) * vX[l];
        ++m;
      }
  }
}

// This thread's share of the strict inlier counts at sh.at and sh.at2.
__device__ void count_pass(const Params& p, const Shared& sh, int lo, int hi, float (&acc)[2]) {
  float R1[9], t1[3], R2[9], t2[3];
  load_pose(sh.at, R1, t1);
  load_pose(sh.at2, R2, t2);
  acc[0] = acc[1] = 0.f;
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float4 a = p.rows[2 * i];
    const float4 b = p.rows[2 * i + 1];
    const bool live = b.y != 0.f;
    const Proj q1 = project(R1, t1, a.x, a.y, a.z, a.w, b.x);
    const Proj q2 = project(R2, t2, a.x, a.y, a.z, a.w, b.x);
    acc[0] += ((q1.z > 0.f ? q1.sq : 1e6f) < p.threshold && live) ? 1.f : 0.f;
    acc[1] += ((q2.z > 0.f ? q2.sq : 1e6f) < p.threshold && live) ? 1.f : 0.f;
  }
}

// Thread 0: damp, solve H delta = -g by LU with partial pivoting (the
// first largest pivot, as getrf), and set the trial pose sh.at.
__device__ void gn_trial(Shared& sh) {
  float A[6][7];
  int m = 0;
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int l = k; l < 6; ++l) A[k][l] = A[l][k] = sh.H[m++];
  float tr = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) tr += A[k][k];
  const float damp = sh.lam * fmaxf(tr / 6.f, 1e-10f);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    A[k][k] += damp;
    A[k][6] = sh.g[k];
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    float big = fabsf(A[c][c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r)
      if (fabsf(A[r][c]) > big) {
        big = fabsf(A[r][c]);
        piv = r;
      }
#pragma unroll
    for (int r = c + 1; r < 6; ++r)
      if (r == piv)
#pragma unroll
        for (int j = c; j < 7; ++j) {
          const float tmp = A[r][j];
          A[r][j] = A[c][j];
          A[c][j] = tmp;
        }
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const float f = A[r][c] / A[c][c];
#pragma unroll
      for (int j = c + 1; j < 7; ++j) A[r][j] -= f * A[c][j];
    }
  }
  float delta[6];
#pragma unroll
  for (int r = 5; r >= 0; --r) {
    float s = A[r][6];
#pragma unroll
    for (int j = r + 1; j < 6; ++j) s -= A[r][j] * delta[j];
    delta[r] = s / A[r][r];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) delta[k] = -delta[k];
  float dR[9];
  so3_exp(delta, dR);
  matmul3(sh.cur.R, dR, sh.at.R);
#pragma unroll
  for (int i = 0; i < 3; ++i) sh.at.t[i] = sh.cur.t[i] + delta[3 + i];
}

// Thread 0: take the normal equations and cost of the pose just
// evaluated (sh.at, the last pass's sums) as the chain's.
__device__ void gn_adopt(Shared& sh) {
  copy_pose(sh.at, sh.cur);
#pragma unroll
  for (int k = 0; k < 21; ++k) sh.H[k] = sh.sums[k];
#pragma unroll
  for (int k = 0; k < 6; ++k) sh.g[k] = sh.sums[21 + k];
  sh.cost = sh.sums[27];
}

// refine_pose from sh.at over the round's gate weights: iters damped
// Gauss-Newton steps, each kept iff its cost is strictly lower; the
// result in sh.cur.  With Gate the first pass also sets the round's
// gate weights and counts the start's strict inliers (sh.gate_count).
template <bool Gate>
__device__ void gn_chain(const Params& p, Shared& sh, cg::cluster_group& cluster, int lo, int hi,
                         float gate, int& parity) {
  float acc[kGateSums];
  normal_pass<Gate>(p, sh, lo, hi, gate, acc);
  cluster_sum<Gate ? kGateSums : kNormalSums>(acc, sh, cluster, parity);
  if (threadIdx.x == 0) {
    gn_adopt(sh);
    if (Gate) sh.gate_count = sh.sums[28];
    sh.lam = 1e-4f;
  }
  for (int it = 0; it < p.iters; ++it) {
    if (threadIdx.x == 0) gn_trial(sh);
    __syncthreads();
    normal_pass<false>(p, sh, lo, hi, gate, acc);
    cluster_sum<kNormalSums>(acc, sh, cluster, parity);
    if (threadIdx.x == 0) {
      const bool ok = sh.sums[27] < sh.cost;
      if (ok) gn_adopt(sh);
      sh.lam = fminf(fmaxf(ok ? sh.lam * 0.33f : sh.lam * 8.f, 1e-10f), 1e4f);
    }
  }
  __syncthreads();
}

// The Gram's entry (i, j) from the blocks' sums: [[S, 0, -U], [0, S,
// -V], [-U, -V, Q]].
__device__ __forceinline__ float gram_entry(const float* s, int i, int j) {
  const int bi = i >> 2, bj = j >> 2, a = min(i & 3, j & 3), b = max(i & 3, j & 3);
  const int k = 4 * a - a * (a - 1) / 2 + (b - a);
  if (bi == bj) return bi == 2 ? s[30 + k] : s[k];
  if (bi == 2 || bj == 2) return -s[(bi == 0 || bj == 0 ? 10 : 20) + k];
  return 0.f;
}

// Lane 0: the refit's pose from its null vector sh.p (pnp.pnp_dlt): the
// sign by det, the scale as the mean singular value, the nearest
// rotation; into sh.at.
__device__ void dlt_pose(Shared& sh) {
  float P[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) P[i] = sh.p[i];
  float M[9] = {P[0], P[1], P[2], P[4], P[5], P[6], P[8], P[9], P[10]};
  const float dm = det3(M);
  const float sg = dm < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int i = 0; i < 12; ++i) P[i] *= sg;
  const float Mp[9] = {P[0], P[1], P[2], P[4], P[5], P[6], P[8], P[9], P[10]};
  float U[9], s[3], V[9];
  svd3x3(Mp, U, s, V);
  const float scale = fmaxf((s[0] + s[1] + s[2]) / 3.f, 1e-12f);
#pragma unroll
  for (int i = 0; i < 9; ++i) M[i] = Mp[i] / scale;
  so3_project(M, sh.at.R);
#pragma unroll
  for (int i = 0; i < 3; ++i) sh.at.t[i] = P[4 * i + 3] / scale;
}

// Warp 0: the refit (pnp_dlt with the round's weights) from the Gram's
// sums: the smallest eigenvector of G by 8 ridge inverse iterations
// (linalg.smallest_eigvec_power) on one LU with partial pivoting of
// G + eps I, lane r holding row r; then its pose into sh.at.
__device__ void dlt_refit(Shared& sh) {
  const int lane = threadIdx.x & 31;
  const bool live = lane < 12;
  float tr = 0.f;
#pragma unroll
  for (int i = 0; i < 12; ++i) tr += gram_entry(sh.sums, i, i);
  const float eps = tr / 12.f * 1e-7f + 1e-20f;
  float row[12];
#pragma unroll
  for (int j = 0; j < 12; ++j)
    row[j] = live ? gram_entry(sh.sums, lane, j) + (j == lane ? eps : 0.f) : 0.f;
  int orig = lane;   // the row of G + eps I that this lane holds
#pragma unroll
  for (int c = 0; c < 12; ++c) {
    float big = (live && lane >= c) ? fabsf(row[c]) : -1.f;
    int at = lane;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, big, o);
      const int oa = __shfl_xor_sync(0xffffffffu, at, o);
      if (ob > big || (ob == big && oa < at)) {
        big = ob;
        at = oa;
      }
    }
    const int src = lane == c ? at : (lane == at ? c : lane);
#pragma unroll
    for (int j = 0; j < 12; ++j) row[j] = __shfl_sync(0xffffffffu, row[j], src);
    orig = __shfl_sync(0xffffffffu, orig, src);
    const float piv = __shfl_sync(0xffffffffu, row[c], c);
    const float f = row[c] / piv;
#pragma unroll
    for (int j = c + 1; j < 12; ++j) {
      const float pj = __shfl_sync(0xffffffffu, row[j], c);
      if (lane > c) row[j] -= f * pj;
    }
    if (lane > c) row[c] = f;   // L's multiplier
  }
  float v = live ? 1.f / 3.4641016151377544f : 0.f;   // ones / sqrt(12)
  for (int it = 0; it < 8; ++it) {
    float y = __shfl_sync(0xffffffffu, v, orig);
#pragma unroll
    for (int c = 0; c < 12; ++c) {
      const float yc = __shfl_sync(0xffffffffu, y, c);
      if (lane > c) y -= row[c] * yc;
    }
#pragma unroll
    for (int c = 11; c >= 0; --c) {
      const float xc = __shfl_sync(0xffffffffu, y, c) / __shfl_sync(0xffffffffu, row[c], c);
      if (lane == c) y = xc;
      else if (lane < c) y -= row[c] * xc;
    }
    if (!live) y = 0.f;
    float s = y * y;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    s = __shfl_sync(0xffffffffu, s, 0);
    v = y / fmaxf(sqrtf(s), 1e-30f);
  }
  if (live) sh.p[lane] = v;
  __syncwarp();
  if (lane == 0) dlt_pose(sh);
}

__global__ void __cluster_dims__(kBlocks, 1, 1) __launch_bounds__(kThreads)
    pnp_lo_kernel(const Params p) {
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int chunk = (p.n + kBlocks - 1) / kBlocks;
  const int lo = min(p.n, (int)cluster.block_rank() * chunk), hi = min(p.n, lo + chunk);
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float x0 = p.x[3 * i], x1 = p.x[3 * i + 1], x2 = p.x[3 * i + 2];
    p.rows[2 * i] = make_float4(p.X[3 * i], p.X[3 * i + 1], p.X[3 * i + 2], x0 / x2);
    p.rows[2 * i + 1] = make_float4(x1 / x2, p.mask[i] ? 1.f : 0.f, 0.f, 0.f);
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) sh.best.R[i] = p.R0[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) sh.best.t[i] = p.t0[i];
  }
  int parity = 0;
  for (int round = 0; round < p.rounds; ++round) {
    // Polish the incumbent on the round's gate (set at the incumbent).
    if (threadIdx.x == 0) copy_pose(sh.best, sh.at);
    __syncthreads();
    gn_chain<true>(p, sh, cluster, lo, hi, p.gate[round], parity);
    if (threadIdx.x == 0) {
      copy_pose(sh.cur, sh.one);
      if (round == 0) sh.c_best = sh.gate_count;
    }
    // Refit from scratch on the same support, then polish the refit.
    float acc[kGramSums];
    gram_pass(p, lo, hi, acc);
    cluster_sum<kGramSums>(acc, sh, cluster, parity);
    if (threadIdx.x < 32) dlt_refit(sh);
    __syncthreads();
    gn_chain<false>(p, sh, cluster, lo, hi, 0.f, parity);
    // Keep the chain with more strict inliers (the refit's on a tie),
    // then it over the incumbent only with strictly more.
    if (threadIdx.x == 0) {
      copy_pose(sh.one, sh.at);
      copy_pose(sh.cur, sh.at2);
    }
    __syncthreads();
    float c[2];
    count_pass(p, sh, lo, hi, c);
    cluster_sum<2>(c, sh, cluster, parity);
    if (threadIdx.x == 0) {
      const bool take2 = sh.sums[1] >= sh.sums[0];
      const float c1 = fmaxf(sh.sums[0], sh.sums[1]);
      if (c1 > sh.c_best) {
        copy_pose(take2 ? sh.at2 : sh.at, sh.best);
        sh.c_best = c1;
      }
    }
    __syncthreads();
  }
  float R[9], t[3];
  load_pose(sh.best, R, t);
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float4 a = p.rows[2 * i];
    const float4 b = p.rows[2 * i + 1];
    const Proj q = project(R, t, a.x, a.y, a.z, a.w, b.x);
    p.inliers[i] = ((q.z > 0.f ? q.sq : 1e6f) < p.threshold && b.y != 0.f) ? 1 : 0;
  }
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) p.R[i] = R[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) p.t[i] = t[i];
    p.count[0] = (int)sh.c_best;
  }
  cluster.sync();   // no block leaves while another may still read its shared memory
}

}  // namespace

// The LO stage of ransac_pnp on n rows: observations x and conditioned
// points X ([n, 3] f32 each), mask ([n] bool), the start R0 [3, 3], t0
// [3]; `rounds` (1-4) rounds, round k gating at gates[k] (host floats:
// threshold x the round's multiplier), each two chains of `iters` steps
// with Huber delta huber_delta; strict inliers at `threshold`.  rows is
// scratch of 8 f32 a row.  Writes R [3, 3], t [3], count [1] (int32)
// and inliers [n] (bool); all dense row-major on the card.
extern "C" int sfm_pnp_lo(const void* x, const void* X, const void* mask, const void* R0,
                          const void* t0, int n, int iters, float threshold,
                          const float* gates, int rounds, float huber_delta, void* rows,
                          void* R, void* t, void* count, void* inliers, void* stream) {
  if (n < 0 || iters < 0 || rounds < 1 || rounds > kMaxRounds || gates == nullptr)
    return (int)cudaErrorInvalidValue;
  Params p{(const float*)x, (const float*)X, (const uint8_t*)mask, (const float*)R0,
           (const float*)t0, (float4*)rows, n, iters, rounds, threshold, huber_delta,
           {0.f, 0.f, 0.f, 0.f}, (float*)R, (float*)t, (int*)count, (uint8_t*)inliers};
  for (int k = 0; k < rounds; ++k) p.gate[k] = gates[k];
  pnp_lo_kernel<<<kBlocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
