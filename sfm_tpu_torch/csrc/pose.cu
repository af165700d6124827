// K12: pose recovery from an essential matrix (recover_pose): the Jacobi
// SVD of E, the four (R, t) branches, the Jacobi DLT of every row under
// every branch, the cheirality vote and its first maximum, in one launch.
//
// Replaces no TPU kernel: the JAX package leaves recover_pose
// (sfm_tpu/geometry/pose.py) to XLA.  The port's plain route
// (geometry/pose.py:recover_pose_plain) takes ~4.2k PyTorch launches a
// call, almost all of them in two chains of Jacobi rotations: 8 sweeps
// x 3 rotations of ~25 tiny operations for the SVD of E, 8 x 6 for the
// [4, N] batch of 4 x 4 DLT Gram matrices; and it waits for the card 7
// times (two constants made from Python lists, five picks by a 0-d
// index).  See sfm_tpu_torch/geometry/pose.py for the contract.
//
// What bounds it: nothing of the card's rate or bandwidth.  A row is
// ~48 dependent Jacobi rotations a branch (~6k f32 operations, each
// rotation two IEEE divisions and two square roots deep) and reads 16
// bytes; 4 x 2,560 rows are ~60 MFLOP and 40 KB.  So its time is the
// latency of one rotation chain times the rows a thread takes, plus the
// serial SVD of E at the start.
//
// Design.  One thread block cluster of 8 blocks; block k owns the k-th
// eighth of the rows.  Thread 0 of every block computes the four
// branches from E (the same code on the same E, so the same bits in
// every block).  Pass 1: thread i takes branch i mod 4 of rows i / 4,
// i / 4 + 128, ...: the DLT, its depths, and its vote, summed in row
// order.  The votes are reduced in one fixed order (a warp butterfly
// over the lanes of one branch, the warps in order, the cluster's
// blocks in rank order through DSMEM), so every block holds the same
// four sums and takes the same first maximum; for 0/1 weights the sums
// are exact.  Pass 2: each thread recomputes the winning branch's DLT
// of its rows, bit for bit pass 1's, and writes points, front and
// finite; no scratch, any N.  Every operation rounds as the plain route
// rounds (linalg.cuh); no TF32, no fast-math intrinsics.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "linalg.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocks = 8;   // the cluster
constexpr int kBranches = 4;

struct Params {
  const float* E;        // [3, 3]
  const float* x1;       // [n, 3] normalized homogeneous rows
  const float* x2;       // [n, 3]
  const float* w;        // [n] vote weights, or null: a count
  int n, sweeps;
  float* R;              // [3, 3] the winner
  float* t;              // [3]
  int64_t* index;        // [] its branch
  float* votes;          // [4]
  float* points;         // [n, 3]
  uint8_t* front;        // [n] bool
  uint8_t* finite;       // [n] bool
};

struct Shared {
  float R[kBranches][9], t[kBranches][3];
  float part[kWarps][kBranches];
  float mine[kBranches];   // this block's votes, read across the cluster
  float votes[kBranches];
  int best;
};

// pose_candidates: (R1, t), (R1, -t), (R2, t), (R2, -t) with R1 = U W
// V^T, R2 = U W^T V^T, W = Rz(+90 deg), U and V turned to det +1.
// U W = [u1, -u0, u2] and U W^T = [-u1, u0, u2] are exact; the product
// with V^T is cuBLAS's FMA chain.
__device__ void pose_candidates(const float E[9], int sweeps, Shared& sh) {
  float U[9], s[3], V[9];
  linalg::svd3x3(E, sweeps, U, s, V);
  const float fu = linalg::det3(U) < 0.f ? -1.f : 1.f;
  const float fv = linalg::det3(V) < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    U[3 * i + 2] = linalg::mul(U[3 * i + 2], fu);
    V[3 * i + 2] = linalg::mul(V[3 * i + 2], fv);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float r1 = linalg::dot3(U[3 * i + 1], -U[3 * i], U[3 * i + 2], V[3 * j],
                                    V[3 * j + 1], V[3 * j + 2]);
      const float r2 = linalg::dot3(-U[3 * i + 1], U[3 * i], U[3 * i + 2], V[3 * j],
                                    V[3 * j + 1], V[3 * j + 2]);
      sh.R[0][3 * i + j] = sh.R[1][3 * i + j] = r1;
      sh.R[2][3 * i + j] = sh.R[3][3 * i + j] = r2;
    }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    sh.t[0][i] = sh.t[2][i] = U[3 * i + 2];
    sh.t[1][i] = sh.t[3][i] = -U[3 * i + 2];
  }
}

struct Tri {
  float X[3];
  bool front, finite;
};

// triangulate (solver "jacobi") of one row against P1 = [I | 0], P2 =
// [R | t]: the DLT rows x P[2] - P[0], y P[2] - P[1] of both views, the
// smallest eigenvector of their Gram matrix by `sweeps` Jacobi sweeps
// (the first smallest diagonal entry), X = its first three over its
// fourth (|w| >= 1e-12), finite = 5 |w| > 1e-6 |X_h|; then depths.
__device__ __forceinline__ Tri dlt_row(const float R[9], const float t[3], const float* x1,
                                       const float* x2, int i, int sweeps) {
  using namespace linalg;
  const float a0[4] = {-1.f, 0.f, __ldg(x1 + 3 * i), 0.f};
  const float a1[4] = {0.f, -1.f, __ldg(x1 + 3 * i + 1), 0.f};
  const float u = __ldg(x2 + 3 * i), v = __ldg(x2 + 3 * i + 1);
  const float a2[4] = {sub(mul(u, R[6]), R[0]), sub(mul(u, R[7]), R[1]),
                       sub(mul(u, R[8]), R[2]), sub(mul(u, t[2]), t[0])};
  const float a3[4] = {sub(mul(v, R[6]), R[3]), sub(mul(v, R[7]), R[4]),
                       sub(mul(v, R[8]), R[5]), sub(mul(v, t[2]), t[1])};
  float A[16], V[16];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      A[4 * p + q] = fmaf(a3[p], a3[q], fmaf(a2[p], a2[q], fmaf(a1[p], a1[q], mul(a0[p], a0[q]))));
      V[4 * p + q] = p == q ? 1.f : 0.f;
    }
  // jacobi_eigh symmetrises first: 0.5 (A + A^T) is A, exactly.
  jacobi_sweeps<4>(A, V, sweeps);
  int k = 0;
#pragma unroll
  for (int j = 1; j < 4; ++j)
    if (A[5 * j] < A[5 * k]) k = j;
  float h[4];   // V's column k, picked without indexing V by a run-time value
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (j == k) h[r] = V[4 * r + j];
  const float nh = norm4(h[0], h[1], h[2], h[3]);
#pragma unroll
  for (int r = 0; r < 4; ++r) h[r] = div(h[r], nh);
  const float w = h[3];
  const float den = fabsf(w) < 1e-12f ? (w < 0.f ? -1e-12f : 1e-12f) : w;
  Tri out;
#pragma unroll
  for (int r = 0; r < 3; ++r) out.X[r] = div(h[r], den);
  out.finite = mul(fabsf(w), 5.f) > mul(norm3(h[0], h[1], h[2]), 1e-6f);
  const float z2 = add(dot3(R[6], R[7], R[8], out.X[0], out.X[1], out.X[2]), t[2]);
  out.front = out.X[2] > 0.f && z2 > 0.f;
  return out;
}

__global__ void __cluster_dims__(kBlocks, 1, 1) __launch_bounds__(kThreads)
    recover_pose_kernel(const Params p) {
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int chunk = (p.n + kBlocks - 1) / kBlocks;
  const int lo = min(p.n, rank * chunk), hi = min(p.n, lo + chunk);
  if (threadIdx.x == 0) pose_candidates(p.E, p.sweeps, sh);
  __syncthreads();

  // Pass 1: this thread's branch of its rows, and their vote.
  const int b = threadIdx.x & (kBranches - 1);
  float R[9], t[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = sh.R[b][i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = sh.t[b][i];
  float vote = 0.f;
  for (int i = lo + threadIdx.x / kBranches; i < hi; i += kThreads / kBranches) {
    const Tri q = dlt_row(R, t, p.x1, p.x2, i, p.sweeps);
    if (q.front) vote += p.w ? __ldg(p.w + i) : 1.f;
  }
  // Lanes b, b + 4, ... hold branch b: butterflies over lane bits 2-4.
#pragma unroll
  for (int o = 16; o >= kBranches; o >>= 1) vote += __shfl_xor_sync(0xffffffffu, vote, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < kBranches) sh.part[warp][lane] = vote;
  __syncthreads();
  if (threadIdx.x < kBranches) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += sh.part[w][threadIdx.x];
    sh.mine[threadIdx.x] = s;
  }
  cluster.sync();
  if (threadIdx.x < kBranches) {
    float s = 0.f;
    for (int r = 0; r < kBlocks; ++r) s += cluster.map_shared_rank(sh.mine, r)[threadIdx.x];
    sh.votes[threadIdx.x] = s;
  }
  cluster.sync();   // every block's shared votes read: from here on none is read remotely
  if (threadIdx.x == 0) {
    // torch.argmax: the first maximum, a NaN above every number.
    int best = 0;
    for (int k = 1; k < kBranches; ++k) {
      const float v = sh.votes[k], m = sh.votes[best];
      if (m == m && (v > m || v != v)) best = k;
    }
    sh.best = best;
    if (rank == 0) {
#pragma unroll
      for (int i = 0; i < 9; ++i) p.R[i] = sh.R[best][i];
#pragma unroll
      for (int i = 0; i < 3; ++i) p.t[i] = sh.t[best][i];
#pragma unroll
      for (int k = 0; k < kBranches; ++k) p.votes[k] = sh.votes[k];
      p.index[0] = best;
    }
  }
  __syncthreads();

  // Pass 2: the winner's rows.
  const int best = sh.best;
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = sh.R[best][i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = sh.t[best][i];
  for (int i = lo + threadIdx.x; i < hi; i += kThreads) {
    const Tri q = dlt_row(R, t, p.x1, p.x2, i, p.sweeps);
#pragma unroll
    for (int r = 0; r < 3; ++r) p.points[3 * i + r] = q.X[r];
    p.front[i] = q.front;
    p.finite[i] = q.finite;
  }
}

}  // namespace

// recover_pose on n rows: E [3, 3], x1 and x2 ([n, 3] f32), w ([n] f32,
// or null for a count), `sweeps` Jacobi sweeps for both the SVD and the
// DLT.  Writes R [3, 3], t [3], index (int64), votes [4], points [n, 3],
// front and finite ([n] bool); all dense row-major on the card.
extern "C" int sfm_recover_pose(const void* E, const void* x1, const void* x2, const void* w,
                                int n, int sweeps, void* R, void* t, void* index, void* votes,
                                void* points, void* front, void* finite, void* stream) {
  if (n < 0 || sweeps < 0) return (int)cudaErrorInvalidValue;
  Params p{(const float*)E, (const float*)x1, (const float*)x2, (const float*)w, n, sweeps,
           (float*)R, (float*)t, (int64_t*)index, (float*)votes, (float*)points,
           (uint8_t*)front, (uint8_t*)finite};
  recover_pose_kernel<<<kBlocks, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
