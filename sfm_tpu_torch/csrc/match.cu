// K6: brute-force descriptor matching with a fused running top-2.
//
// Replaces sfm_tpu/ops/pallas_match.py:247 match_top2_pallas.  See
// sfm_tpu_torch/ops/match.py for the contract and the design note.
//
// What bounds it: N1 x N2 x 128 products (6.7 GFLOP at the bench's
// 5,120^2, 142 GFLOP at the up-scale's 23,552^2) against a few MB of
// operands, so the tensor cores' rate; and, because K = 128 is only 8
// k-steps of 16 per output tile, the epilogue that folds every score
// into a running (best, second, index) is as long as the bf16 products.
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
// f32 (bf16=False): f32-accurate products on the tensor cores as three
// TF32 passes over an error-compensated split (x = hi + lo; see the f32
// section), ~2^-21 relative per product, with the same epilogue and
// merge; desc2 is split once into ready-made tiles that land by bulk
// copy.  Three passes at 495 TFLOP/s beat one exact f32 pass on the
// CUDA cores (67 TFLOP/s) 2.2x.
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

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo = kSBO) {
  // start address, leading (K) and stride (8-row) byte offsets, all in
  // 16-byte units; base offset 0, layout 0 (no swizzle).
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kLBO >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
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

// ---- f32: three-pass TF32 on the tensor cores --------------------------
// Each operand splits as x = hi + lo: hi is x rounded to TF32 (10
// mantissa bits, to nearest with ties away), lo = x - hi (exact in f32),
// itself rounded to TF32.  A score is lo1.hi2 + hi1.lo2 + hi1.hi2, the
// small terms first, summed in the f32 wgmma registers; the dropped
// lo1.lo2 and lo's rounding leave ~2^-21 of each product.
//
// Every row tile streams all of its desc2 range, so desc2 is split once,
// by split_tiles_kernel, into scratch laid out as the kernel's shared
// memory wants it: per 64-column tile, hi and lo in the core-matrix
// layout (8-row groups 4 KB apart) and the 64 column penalties, 65,792
// contiguous bytes.  A tile then lands with one bulk copy (the TMA
// engine; no thread computes an address), completing on an mbarrier:
// 16-byte cp.async copies of the same bytes could not feed the tensor
// cores.  A block of two warpgroups owns 128 desc1 rows (64 each), split
// into registers as wgmma's A fragments (4 per k-step of 8: rows g and
// g + 8 of the warp's 16, columns q and q + 4; 128 registers for K =
// 128).  Per tile a warpgroup issues 48 m64n64k8 wgmmas (3 passes x 16
// k-steps) and folds the 64 x 64 scores as the bf16 kernel does; then
// the block synchronises and the freed stage is refilled 3 tiles ahead.
constexpr int kXM = 128;                       // desc1 rows per block
constexpr int kXN = 64;                        // desc2 columns per tile
constexpr int kXStages = 3;
constexpr int kXThreads = 256;                 // two warpgroups
constexpr int kXHalfBytes = kXN * kD * 4;      // 32 KB: a tile's hi (or lo)
constexpr int kXTileBytes = 2 * kXHalfBytes + kXN * 4;   // hi, lo, penalties
constexpr int kXSmem = kXStages * kXTileBytes + kXStages * 8;   // + mbarriers
constexpr uint32_t kXSBO = 32 * 128;           // 8-row groups of 512-byte rows

// Round f32 bits to TF32: to nearest, ties away from zero, low 13 bits 0.
__device__ __forceinline__ uint32_t tf32_round(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round(__float_as_uint(x));
  lo = tf32_round(__float_as_uint(__fsub_rn(x, __uint_as_float(hi))));
}

// One thread per 16-byte chunk (column col, K chunk kc) of the padded
// desc2: its hi and lo at their places in tile col / 64; the chunk-0
// threads also write the column's penalty (-inf past n2).
__global__ void __launch_bounds__(256)
split_tiles_kernel(const float* __restrict__ d2, const float* __restrict__ valid2,
                   int n2, int n_chunks, unsigned char* __restrict__ tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_chunks) return;
  const int r8 = i & 7, kc = (i >> 3) & 31, cg = i >> 8;   // cg: 8-column group
  const int col = cg * 8 + r8;
  float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (col < n2) x = reinterpret_cast<const float4*>(d2)[(size_t)col * 32 + kc];
  uint4 h, l;
  split_tf32(x.x, h.x, l.x);
  split_tf32(x.y, h.y, l.y);
  split_tf32(x.z, h.z, l.z);
  split_tf32(x.w, h.w, l.w);
  unsigned char* tile = tiles + (size_t)(col / kXN) * kXTileBytes;
  const int off = ((col % kXN) >> 3) * kXSBO + kc * 128 + r8 * 16;
  *reinterpret_cast<uint4*>(tile + off) = h;
  *reinterpret_cast<uint4*>(tile + kXHalfBytes + off) = l;
  if (kc == 0)
    reinterpret_cast<float*>(tile + 2 * kXHalfBytes)[col % kXN] =
        col < n2 ? (valid2[col] - 1.0f) * 1e3f : -__int_as_float(0x7f800000);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}

// D[64 x 64] (+)= A[64 x 8] B[64 x 8]^T in TF32; A from registers, B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_64x64x8(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__global__ void __launch_bounds__(kXThreads, 1)
match_tf32x3_kernel(const float* __restrict__ d1, const unsigned char* __restrict__ tiles,
                    int n1, int n2, int cols_per_split, float* __restrict__ best_out,
                    float* __restrict__ second_out, int* __restrict__ index_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int q = lane & 3;
  const int row0 = blockIdx.x * kXM;
  const int c_begin = blockIdx.y * cols_per_split;
  const int c_end = min(n2, c_begin + cols_per_split);
  const int n_tiles = c_end > c_begin ? (c_end - c_begin + kXN - 1) / kXN : 0;
  const uint32_t sB = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t bars = sB + kXStages * kXTileBytes;

  // Tile t into stage t % 3 with one bulk copy; its mbarrier completes
  // when all the bytes have landed.
  auto load_tile = [&](int t) {
    const int st = t % kXStages;
    const uint32_t bar = bars + st * 8;
    const unsigned char* src = tiles + (size_t)(c_begin / kXN + t) * kXTileBytes;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                 "r"((uint32_t)kXTileBytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(sB + st * kXTileBytes),
        "l"(src), "r"((uint32_t)kXTileBytes), "r"(bar)
        : "memory");
  };

  if (tid == 0) {
    for (int st = 0; st < kXStages; ++st) mbar_init(bars + st * 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();   // the barriers exist before any thread waits on them
  if (tid == 0)
    for (int t = 0; t < kXStages && t < n_tiles; ++t) load_tile(t);

  // This thread's A fragments: rows g, g + 8 of its warp's 16, columns
  // 8 ks + q and 8 ks + q + 4; rows past n1 are zero.
  uint32_t ahi[kD / 8][4], alo[kD / 8][4];
  {
    const int r = row0 + wg * 64 + warp * 16 + (lane >> 2);
#pragma unroll
    for (int ks = 0; ks < kD / 8; ++ks)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int row = r + (v & 1) * 8;
        const float x = row < n1 ? __ldg(d1 + (size_t)row * kD + ks * 8 + q + (v >> 1) * 4)
                                 : 0.0f;
        split_tf32(x, ahi[ks][v], alo[ks][v]);
      }
  }

  float b0 = kNeg, s0 = kNeg, b1 = kNeg, s1 = kNeg;
  int i0 = 0, i1 = 0;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kXStages;
    mbar_wait(bars + st * 8, (t / kXStages) & 1);   // tile t has landed
    const uint32_t hb = sB + st * kXTileBytes;
    const uint32_t lb = hb + kXHalfBytes;
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kD / 8; ++ks)
      wgmma_tf32_64x64x8(acc, alo[ks], smem_desc(hb + ks * 256, kXSBO), ks > 0);
#pragma unroll
    for (int ks = 0; ks < kD / 8; ++ks)
      wgmma_tf32_64x64x8(acc, ahi[ks], smem_desc(lb + ks * 256, kXSBO), 1);
#pragma unroll
    for (int ks = 0; ks < kD / 8; ++ks)
      wgmma_tf32_64x64x8(acc, ahi[ks], smem_desc(hb + ks * 256, kXSBO), 1);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    const float* pt = reinterpret_cast<const float*>(smem + st * kXTileBytes + 2 * kXHalfBytes);
    const int col0 = c_begin + t * kXN;
#pragma unroll
    for (int j = 0; j < kXN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * q + e;
        const float p = pt[c];
        fold(b0, s0, i0, __fadd_rn(acc[4 * j + e], p), col0 + c);
        fold(b1, s1, i1, __fadd_rn(acc[4 * j + 2 + e], p), col0 + c);
      }
    }
    __syncthreads();   // every warpgroup is done with stage t % 3
    if (tid == 0 && t + kXStages < n_tiles) load_tile(t + kXStages);
  }

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

// bf16 != 0: the bf16 kernel on bf16 descriptors; else split_tiles_kernel
// lays the f32 d2's hi, lo and penalties out in the scratch split2
// (kXTileBytes per 64 columns, rounded up) and the three-pass TF32
// kernel runs on them and the f32 d1.  The grid is (row tiles, split); with split > 1 the partials go
// to the scratch pb/ps/pi ([split, n1] each) and the merge pass writes
// best/second/index; with split == 1 the kernel writes them.
extern "C" int sfm_match_top2(const void* d1, const void* d2, const void* valid2,
                              int n1, int n2, int bf16, int split,
                              int cols_per_split, void* split2, void* pb, void* ps,
                              void* pi, void* best, void* second, void* index,
                              void* stream) {
  if (n1 < 1 || n2 < 0 || split < 1 || cols_per_split < 1 ||
      (split > 1 && (!pb || !ps || !pi)) || (!bf16 && n2 > 0 && !split2) ||
      (!bf16 && cols_per_split % kXN))
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
    static bool attr_x_set = false;
    if (!attr_x_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          match_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kXSmem);
      if (e != cudaSuccess) return (int)e;
      attr_x_set = true;
    }
    const int n_chunks = (n2 + kXN - 1) / kXN * kXN * (kD / 4);
    if (n_chunks > 0)
      split_tiles_kernel<<<(n_chunks + 255) / 256, 256, 0, st>>>(
          (const float*)d2, (const float*)valid2, n2, n_chunks, (unsigned char*)split2);
    dim3 grid((n1 + kXM - 1) / kXM, split);
    match_tf32x3_kernel<<<grid, kXThreads, kXSmem, st>>>(
        (const float*)d1, (const unsigned char*)split2, n1, n2, cols_per_split, ob, os,
        oi);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || split == 1) return (int)e;
  merge_kernel<<<(n1 + 255) / 256, 256, 0, st>>>(
      (const float*)pb, (const float*)ps, (const int*)pi, split, n1,
      (float*)best, (float*)second, (int*)index);
  return (int)cudaGetLastError();
}
