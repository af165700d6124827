// K6: brute-force descriptor matching with a fused running top-2.
//
// Replaces sfm_tpu/ops/pallas_match.py:247 match_top2_pallas.  See
// sfm_tpu_torch/ops/match.py for the contract and the design note.
//
// Block: 256 threads as 16 x 16 (ty, tx); a 32-row tile of desc1
// lives in shared memory for the whole run (f32, padded rows), desc2
// streams through in 64-column tiles of 32-dimension slices.  Thread
// (ty, tx) owns rows {2ty, 2ty+1} and columns {tx + 16j}, j < 4, of
// each tile, so its columns arrive in increasing order and a strict
// `>` keeps the lowest index on ties.  The 16 per-thread partial
// top-2s of each row are merged in shared memory at the end, in
// increasing tx order, inside the block: no cross-block reduction.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kD = 128;      // descriptor length
constexpr int kBM = 32;      // desc1 rows per block
constexpr int kBN = 64;      // desc2 columns per tile
constexpr int kDC = 32;      // dimensions per streamed slice
constexpr float kNeg = -2.0f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Merge partial (b2, s2, i2) into (b, s, i); the columns of the two
// partials are disjoint.
__device__ __forceinline__ void merge(float& b, float& s, int& i, float b2,
                                      float s2, int i2) {
  if (b2 > b || (b2 == b && i2 < i)) {
    s = fmaxf(s2, b);
    b = b2;
    i = i2;
  } else {
    s = fmaxf(s, b2);
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
match_top2_kernel(const T* __restrict__ d1, const T* __restrict__ d2,
                  const float* __restrict__ valid2, int n1, int n2,
                  float* __restrict__ best_out, float* __restrict__ second_out,
                  int* __restrict__ index_out) {
  __shared__ float As[kBM][kD + 1];
  __shared__ float Bs[kBN][kDC + 1];
  __shared__ float pb[kBM][16];
  __shared__ float ps[kBM][16];
  __shared__ int pi[kBM][16];

  const int tx = threadIdx.x;  // 0..15
  const int ty = threadIdx.y;  // 0..15
  const int tid = ty * 16 + tx;
  const int row0 = blockIdx.x * kBM;

  for (int e = tid; e < kBM * kD; e += 256) {
    const int r = e / kD, c = e % kD;
    const int gr = row0 + r;
    As[r][c] = gr < n1 ? to_f32(d1[(size_t)gr * kD + c]) : 0.0f;
  }

  float b[2], s[2];
  int bi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    b[i] = kNeg;
    s[i] = kNeg;
    bi[i] = 0;
  }

  for (int col0 = 0; col0 < n2; col0 += kBN) {
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int dc = 0; dc < kD; dc += kDC) {
      __syncthreads();
      for (int e = tid; e < kBN * kDC; e += 256) {
        const int r = e / kDC, c = e % kDC;
        const int gc = col0 + r;
        Bs[r][c] = gc < n2 ? to_f32(d2[(size_t)gc * kD + dc + c]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kDC; ++k) {
        const float a0 = As[2 * ty][dc + k];
        const float a1 = As[2 * ty + 1][dc + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bv = Bs[tx + 16 * j][k];
          acc[0][j] = fmaf(a0, bv, acc[0][j]);
          acc[1][j] = fmaf(a1, bv, acc[1][j]);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col >= n2) continue;
      const float pen = (valid2[col] - 1.0f) * 1e3f;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float v = acc[i][j] + pen;
        if (v > b[i]) {
          s[i] = b[i];
          b[i] = v;
          bi[i] = col;
        } else {
          s[i] = fmaxf(s[i], v);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    pb[2 * ty + i][tx] = b[i];
    ps[2 * ty + i][tx] = s[i];
    pi[2 * ty + i][tx] = bi[i];
  }
  __syncthreads();
  if (tid < kBM) {
    const int gr = row0 + tid;
    float bb = pb[tid][0], ss = ps[tid][0];
    int ii = pi[tid][0];
    for (int t = 1; t < 16; ++t) merge(bb, ss, ii, pb[tid][t], ps[tid][t], pi[tid][t]);
    if (gr < n1) {
      best_out[gr] = bb;
      second_out[gr] = ss;
      index_out[gr] = ii;
    }
  }
}

template <typename T>
int launch(const void* d1, const void* d2, const void* valid2, int n1, int n2,
           void* best, void* second, void* index, void* stream) {
  dim3 block(16, 16);
  dim3 grid((n1 + kBM - 1) / kBM);
  match_top2_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)d1, (const T*)d2, (const float*)valid2, n1, n2, (float*)best,
      (float*)second, (int*)index);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sfm_match_top2_bf16(const void* d1, const void* d2,
                                   const void* valid2, int n1, int n2,
                                   void* best, void* second, void* index,
                                   void* stream) {
  return launch<__nv_bfloat16>(d1, d2, valid2, n1, n2, best, second, index,
                               stream);
}

extern "C" int sfm_match_top2_f32(const void* d1, const void* d2,
                                  const void* valid2, int n1, int n2,
                                  void* best, void* second, void* index,
                                  void* stream) {
  return launch<float>(d1, d2, valid2, n1, n2, best, second, index, stream);
}
