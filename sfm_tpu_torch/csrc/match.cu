// K6: brute-force descriptor matching with a fused running top-2.
//
// Replaces sfm_tpu/ops/pallas_match.py:247 match_top2_pallas.  See
// sfm_tpu_torch/ops/match.py for the contract and the design note.
//
// What bounds it: N1 x N2 x 128 bf16 products (6.7 GFLOP at the bench's
// 5,120^2, 142 GFLOP at the up-scale's 23,552^2) against a few MB of
// operands, so the tensor cores' rate; and, because K = 128 is only 8
// k-steps of 16 per output tile, the epilogue that folds every score
// into a running (best, second, index) is as long as the products.
//
// bf16 (the default): tensor cores through wgmma.  A block of two
// warpgroups keeps a 128 x 128 desc1 tile resident in shared memory
// (each warpgroup owns 64 rows) and streams its range of desc2 through a
// ring of 4 stages of 64 columns, loaded with cp.async (zero-filled past
// the range).  Both operands sit in the no-swizzle K-major core-matrix
// layout that wgmma's descriptors address: 8 rows x 16 bytes per core
// matrix, core matrices along K 128 bytes apart, 8-row groups 2 KB
// apart.  Per stage a warpgroup issues 8 m64n64k16 wgmmas into 32 f32
// registers per thread, then folds them, column penalty added, into the
// running top-2 of its 2 rows, in increasing column order (a strict `>`
// keeps the lowest index).  The 4 lanes of a quad share a row and are
// merged with shuffles; a row lives in one warp, so no block-level
// merge.  Two blocks share an SM, so one's epilogue overlaps the other's
// products.
//
// Split over columns: the grid is (row tiles, column ranges), sized in
// ops/match.py from N1, N2 and the SM count so it fills the card at the
// bench shape; each block writes a partial (best, second, index) to
// scratch, and merge_kernel folds the partials in range order with
// merge()'s tie rule, so the lowest index wins ties across ranges too.
//
// f32 (bf16=False, off the main path): full-f32 FMAs on the CUDA cores
// (never TF32), a 32-row tile in shared memory, the same column split.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;      // descriptor length
constexpr float kNeg = -2.0f;

// Merge partial (b2, s2, i2) into (b, s, i); the columns of the two
// partials are disjoint.  On equal bests the lower index wins.
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

// Fold score v of column col, columns arriving in increasing order.
__device__ __forceinline__ void fold(float& b, float& s, int& i, float v,
                                     int col) {
  if (v > b) {
    s = b;
    b = v;
    i = col;
  } else {
    s = fmaxf(s, v);
  }
}

__device__ __forceinline__ void merge_lanes(float& b, float& s, int& i,
                                            int mask) {
  const float b2 = __shfl_xor_sync(0xffffffffu, b, mask);
  const float s2 = __shfl_xor_sync(0xffffffffu, s, mask);
  const int i2 = __shfl_xor_sync(0xffffffffu, i, mask);
  merge(b, s, i, b2, s2, i2);
}

// ---- bf16: wgmma ------------------------------------------------------
constexpr int kTM = 128;                      // desc1 rows per block
constexpr int kTN = 64;                       // desc2 columns per stage
constexpr int kStages = 4;
constexpr int kTCThreads = 256;               // two warpgroups
constexpr int kATileBytes = kTM * kD * 2;     // 32 KB
constexpr int kBTileBytes = kTN * kD * 2;     // 16 KB
constexpr int kTCSmem = kATileBytes + kStages * (kBTileBytes + kTN * 4);
constexpr uint32_t kLBO = 128;                // core matrices along K
constexpr uint32_t kSBO = 16 * 128;           // 8-row groups

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of a [*, 128] bf16 matrix into the core-matrix
// layout at smem address base; rows >= limit are zero-filled.  Two
// neighbouring threads read one 32-byte sector.
template <int ROWS>
__device__ __forceinline__ void load_rows(uint32_t base,
                                          const __nv_bfloat16* __restrict__ g,
                                          int row0, int limit, int tid) {
#pragma unroll
  for (int c = tid; c < ROWS * 16; c += kTCThreads) {
    const int kc = ((c >> 4) & 7) * 2 + (c & 1);   // 16-byte chunk along K
    const int r8 = (c >> 1) & 7;
    const int rg = c >> 7;
    const int gr = row0 + rg * 8 + r8;
    const bool ok = gr < limit;
    const __nv_bfloat16* src = g + (size_t)(ok ? gr : 0) * kD + kc * 8;
    cp_async16(base + (rg * 16 + kc) * 128 + r8 * 16, src, ok);
  }
}

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  // start address, leading (K) and stride (8-row) byte offsets, all in
  // 16-byte units; base offset 0, layout 0 (no swizzle).
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kLBO >> 4) << 16) |
         ((uint64_t)(kSBO >> 4) << 32);
}

__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[64 x 16]^T, both K-major in shared memory.
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__global__ void __launch_bounds__(kTCThreads, 2)
match_tc_kernel(const __nv_bfloat16* __restrict__ d1,
                const __nv_bfloat16* __restrict__ d2,
                const float* __restrict__ valid2, int n1, int n2,
                int cols_per_split, float* __restrict__ best_out,
                float* __restrict__ second_out, int* __restrict__ index_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int q = lane & 3;
  const int row0 = blockIdx.x * kTM;
  const int c_begin = blockIdx.y * cols_per_split;
  const int c_end = min(n2, c_begin + cols_per_split);
  const int n_tiles = c_end > c_begin ? (c_end - c_begin + kTN - 1) / kTN : 0;
  const uint32_t sA = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t sB = sA + kATileBytes;
  float* pen = reinterpret_cast<float*>(smem + kATileBytes + kStages * kBTileBytes);

  auto load_tile = [&](int t) {
    const int st = t % kStages;
    const int col0 = c_begin + t * kTN;
    load_rows<kTN>(sB + st * kBTileBytes, d2, col0, c_end, tid);
    if (tid < kTN) {
      const int col = col0 + tid;
      pen[st * kTN + tid] =
          col < c_end ? (valid2[col] - 1.0f) * 1e3f : -__int_as_float(0x7f800000);
    }
  };

  load_rows<kTM>(sA, d1, row0, n1, tid);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();   // group t (group 0 also holds the desc1 tile)
  }

  float b0 = kNeg, s0 = kNeg, b1 = kNeg, s1 = kNeg;
  int i0 = 0, i1 = 0;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  const uint32_t a_base = sA + wg * 8 * kSBO;   // this warpgroup's 64 rows

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();                 // tile t has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();                              // ... for every thread
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    const int st = t % kStages;
    const uint32_t b_base = sB + st * kBTileBytes;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < kD / 16; ++k)
      wgmma_64x64x16(acc, smem_desc(a_base + k * 256), smem_desc(b_base + k * 256),
                     k > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    // acc[4j + e] is (row, column 8j + 2q + e), acc[4j + 2 + e] row + 8.
    const float* pt = pen + st * kTN;
    const int col0 = c_begin + t * kTN;
#pragma unroll
    for (int j = 0; j < kTN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * q + e;
        const float p = pt[c];
        fold(b0, s0, i0, __fadd_rn(acc[4 * j + e], p), col0 + c);
        fold(b1, s1, i1, __fadd_rn(acc[4 * j + 2 + e], p), col0 + c);
      }
    }
  }
  cp_async_wait<0>();

  merge_lanes(b0, s0, i0, 1);
  merge_lanes(b1, s1, i1, 1);
  merge_lanes(b0, s0, i0, 2);
  merge_lanes(b1, s1, i1, 2);
  if (q == 0) {
    const int r = row0 + wg * 64 + warp * 16 + (lane >> 2);
    const size_t o = (size_t)blockIdx.y * n1;
    if (r < n1) {
      best_out[o + r] = b0;
      second_out[o + r] = s0;
      index_out[o + r] = i0;
    }
    if (r + 8 < n1) {
      best_out[o + r + 8] = b1;
      second_out[o + r + 8] = s1;
      index_out[o + r + 8] = i1;
    }
  }
}

// ---- f32: CUDA-core FMAs -----------------------------------------------
// Block: 256 threads as 16 x 16 (ty, tx); a 32-row tile of desc1 lives in
// shared memory, the block's desc2 range streams through in 64-column
// tiles of 32-dimension slices.  Thread (ty, tx) owns rows {2ty, 2ty+1}
// and columns {tx + 16j}, j < 4, of each tile, so its columns arrive in
// increasing order; the 16 per-thread partials of a row are merged in
// shared memory at the end.
constexpr int kFM = 32;
constexpr int kFN = 64;
constexpr int kFC = 32;

__global__ void __launch_bounds__(256)
match_f32_kernel(const float* __restrict__ d1, const float* __restrict__ d2,
                 const float* __restrict__ valid2, int n1, int n2,
                 int cols_per_split, float* __restrict__ best_out,
                 float* __restrict__ second_out, int* __restrict__ index_out) {
  __shared__ float As[kFM][kD + 1];
  __shared__ float Bs[kFN][kFC + 1];
  __shared__ float pb[kFM][16];
  __shared__ float ps[kFM][16];
  __shared__ int pi[kFM][16];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * 16 + tx;
  const int row0 = blockIdx.x * kFM;
  const int c_begin = blockIdx.y * cols_per_split;
  const int c_end = min(n2, c_begin + cols_per_split);

  for (int e = tid; e < kFM * kD; e += 256) {
    const int r = e / kD, c = e % kD;
    const int gr = row0 + r;
    As[r][c] = gr < n1 ? d1[(size_t)gr * kD + c] : 0.0f;
  }

  float b[2], s[2];
  int bi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    b[i] = kNeg;
    s[i] = kNeg;
    bi[i] = 0;
  }

  for (int col0 = c_begin; col0 < c_end; col0 += kFN) {
    float acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int dc = 0; dc < kD; dc += kFC) {
      __syncthreads();
      for (int e = tid; e < kFN * kFC; e += 256) {
        const int r = e / kFC, c = e % kFC;
        const int gc = col0 + r;
        Bs[r][c] = gc < c_end ? d2[(size_t)gc * kD + dc + c] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kFC; ++k) {
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
      if (col >= c_end) continue;
      const float pen = (valid2[col] - 1.0f) * 1e3f;
#pragma unroll
      for (int i = 0; i < 2; ++i) fold(b[i], s[i], bi[i], __fadd_rn(acc[i][j], pen), col);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    pb[2 * ty + i][tx] = b[i];
    ps[2 * ty + i][tx] = s[i];
    pi[2 * ty + i][tx] = bi[i];
  }
  __syncthreads();
  if (tid < kFM) {
    const int gr = row0 + tid;
    float bb = pb[tid][0], ss = ps[tid][0];
    int ii = pi[tid][0];
    for (int t = 1; t < 16; ++t) merge(bb, ss, ii, pb[tid][t], ps[tid][t], pi[tid][t]);
    if (gr < n1) {
      const size_t o = (size_t)blockIdx.y * n1 + gr;
      best_out[o] = bb;
      second_out[o] = ss;
      index_out[o] = ii;
    }
  }
}

// ---- the merge pass ----------------------------------------------------
// One thread per row folds the split partials in column-range order.
__global__ void __launch_bounds__(256)
merge_kernel(const float* __restrict__ pb, const float* __restrict__ ps,
             const int* __restrict__ pi, int split, int n1,
             float* __restrict__ best_out, float* __restrict__ second_out,
             int* __restrict__ index_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n1) return;
  float b = pb[r], s = ps[r];
  int i = pi[r];
  for (int k = 1; k < split; ++k) {
    const size_t o = (size_t)k * n1 + r;
    merge(b, s, i, pb[o], ps[o], pi[o]);
  }
  best_out[r] = b;
  second_out[r] = s;
  index_out[r] = i;
}

}  // namespace

// bf16 != 0: the tensor-core kernel on bf16 descriptors, else the f32
// kernel on f32 ones.  The grid is (row tiles, split); with split > 1 the
// partials go to the scratch pb/ps/pi ([split, n1] each) and the merge
// pass writes best/second/index; with split == 1 the kernel writes them.
extern "C" int sfm_match_top2(const void* d1, const void* d2, const void* valid2,
                              int n1, int n2, int bf16, int split,
                              int cols_per_split, void* pb, void* ps, void* pi,
                              void* best, void* second, void* index,
                              void* stream) {
  if (n1 < 1 || n2 < 0 || split < 1 || cols_per_split < 1 ||
      (split > 1 && (!pb || !ps || !pi)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  float* ob = (float*)(split > 1 ? pb : best);
  float* os = (float*)(split > 1 ? ps : second);
  int* oi = (int*)(split > 1 ? pi : index);
  if (bf16) {
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          match_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTCSmem);
      if (e != cudaSuccess) return (int)e;
      attr_set = true;
    }
    dim3 grid((n1 + kTM - 1) / kTM, split);
    match_tc_kernel<<<grid, kTCThreads, kTCSmem, st>>>(
        (const __nv_bfloat16*)d1, (const __nv_bfloat16*)d2,
        (const float*)valid2, n1, n2, cols_per_split, ob, os, oi);
  } else {
    dim3 grid((n1 + kFM - 1) / kFM, split);
    match_f32_kernel<<<grid, dim3(16, 16), 0, st>>>(
        (const float*)d1, (const float*)d2, (const float*)valid2, n1, n2,
        cols_per_split, ob, os, oi);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return (int)e;
  merge_kernel<<<(n1 + 255) / 256, 256, 0, st>>>(
      (const float*)pb, (const float*)ps, (const int*)pi, split, n1,
      (float*)best, (float*)second, (int*)index);
  return (int)cudaGetLastError();
}
