// The octave base chain: K1 (separable edge-clamped blur, the init_blur
// prefilter) and K2 (blur + 2x decimation, one octave step) as ONE
// kernel, and K7 (2x bilinear upsample with the reference's interleave).
//
// Replace sfm_tpu/ops/pallas_pyramid.py:147 blur9 and :272 scale_down
// (composed by sfm_tpu/sift/pyramid.py:165 base_chain_pallas) and
// :241 scale_up.  See sfm_tpu_torch/ops/pyramid.py for the contract.
//
// What bounds the chain: one f32 read of the source and one f32 write
// per output pixel of every level.  At the up-scale base (1920 x 2560,
// 19.7 MB each way for level 0) that is device memory; at the bench's
// levels (576 x 720 down to 36 x 45) it is launch latency, and a level
// of a few blocks leaves the card idle.
//
// Design.  One launch per image on a persistent grid (the blocks one
// wave holds).  The work is a list of tiles in level order: the
// prefilter's 32 x 32 tiles (K1's two-pass tile), then each descent's
// 16 x 32 tiles (K2's kept-rows, kept-columns tile), each level read
// back from L2 where the level before was just written.  A block claims
// the next tile from an atomic counter, and a descent tile waits only
// for the rows of the level above that its slab reads: each finished
// tile adds one to its tile row's counter.  So no grid-wide barrier
// stalls the card between levels, and a small level starts while the
// level above is still being written elsewhere.  A tile waits only on
// tiles earlier in the list, which running blocks have already claimed,
// so the scheme cannot deadlock, resident or not.  The last block to
// leave zeroes the counters for the next launch on the stream.  Levels
// start on 128-byte lines of one output buffer, and are read through
// L2 only (__ldcg), so no block sees a stale line of a level another
// block is writing.  The standalone blur9 / scale_down are the
// one-level cases.  Every multiply and add uses the _rn intrinsics (no
// FMA contraction), in the order the plain PyTorch versions evaluate
// them, so the kernel and the plain chain agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxR = 8;                 // largest tap radius taken
constexpr int kMaxTaps = 2 * kMaxR + 1;
constexpr int kMaxPhases = 32;           // prefilter + descents
constexpr int kThreads = 256;
constexpr long long kMaxSpins = 1LL << 26;   // seconds of 32 ns naps: a fault, not a wait

struct Taps {
  float t[kMaxTaps];
  int n;
};

// ---- K1 tile: blur ------------------------------------------------------
// One 32 x 32 output tile: the clamped slab (tile + radius on every
// side) goes to shared memory, the column (H) pass writes a
// [32, 32 + 2r] shared buffer, the row (W) pass the output.  A thread
// takes 4 rows of a column in the column pass, with a 4-row window of
// the slab column sliding down one row per tap: n + 3 shared loads for
// 4 outputs instead of 4n.
constexpr int kBT = 32;                  // output tile side
constexpr int kBSlab = kBT + 2 * kMaxR;  // slab side at the largest radius

struct BlurSmem {
  float slab[kBSlab][kBSlab + 1];
  float colb[kBT][kBSlab + 1];
};

// ---- K2 tile: blur + 2x decimation ---------------------------------------
// One 16-row, 32-column tile of the decimated output.  Output (y', x')
// reads source rows and columns 2y' + k - r, 2x' + k - r (clamped): the
// slab spans 2*16 + 2r - 1 rows and 2*32 + 2r - 1 columns.  The vertical
// pass computes only the even (kept) rows, the horizontal pass only the
// kept columns, so the full-resolution blur never exists.  A thread
// takes 4 kept rows of a column in the vertical pass, with a 7-row
// window of the slab column (kept row j reads its row 2j) sliding down
// one row per tap: n + 6 shared loads for 4 outputs instead of 4n.
constexpr int kDH = 16, kDW = 32;
constexpr int kDSlabH = 2 * kDH + 2 * kMaxR - 1;
constexpr int kDSlabW = 2 * kDW + 2 * kMaxR - 1;

struct DecimSmem {
  float slab[kDSlabH][kDSlabW];
  float vert[kDH][kDSlabW];
};

union TileSmem {
  BlurSmem b;
  DecimSmem d;
};

// One level: `dst` [Ho, Wo] from `src` [H, W], as tiles [first, first +
// tiles) of the work list; done[row] counts the finished tiles of each
// of its tile rows.
struct Phase {
  const float* src;
  float* dst;
  int H, W, Ho, Wo;
  int tiles_x, tiles, first, done;
  int blur;           // 1: K1's tile (Ho = H, Wo = W); 0: K2's tile
};

struct ChainParams {
  Taps pre, sd;
  Phase ph[kMaxPhases];
  int n_phases, n_tiles, n_sync;
};

// sync (ints): [0] the next tile to claim, [1] the blocks that have
// left, then each phase's tile-row counters.

__device__ __forceinline__ void blur_tile(const Phase& ph, int tile,
                                          const float* tp, int n,
                                          BlurSmem& s) {
  const int tid = threadIdx.x;
  const int r = n / 2, H = ph.H, W = ph.W;
  const int x0 = (tile % ph.tiles_x) * kBT, y0 = (tile / ph.tiles_x) * kBT;
  const int sw = kBT + 2 * r, sh = kBT + 2 * r;
  for (int e = tid; e < sh * sw; e += kThreads) {
    const int rr = e / sw, cc = e % sw;
    const int gy = min(max(y0 - r + rr, 0), H - 1);
    const int gx = min(max(x0 - r + cc, 0), W - 1);
    s.slab[rr][cc] = __ldcg(&ph.src[(size_t)gy * W + gx]);
  }
  __syncthreads();
  for (int e = tid; e < (kBT / 4) * sw; e += kThreads) {
    const int r0 = 4 * (e / sw), cc = e % sw;
    float w[4], acc[4];   // w[j]: slab row r0 + j + k at tap k
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = s.slab[r0 + j][cc];
      acc[j] = __fmul_rn(tp[0], w[j]);
    }
    for (int k = 1; k < n; ++k) {
#pragma unroll
      for (int j = 0; j < 3; ++j) w[j] = w[j + 1];
      w[3] = s.slab[r0 + 3 + k][cc];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(tp[k], w[j]));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) s.colb[r0 + j][cc] = acc[j];
  }
  __syncthreads();
  for (int e = tid; e < kBT * kBT; e += kThreads) {
    const int rr = e / kBT, cc = e % kBT;
    const int gy = y0 + rr, gx = x0 + cc;
    if (gy >= H || gx >= W) continue;
    float acc = __fmul_rn(tp[0], s.colb[rr][cc]);
    for (int k = 1; k < n; ++k)
      acc = __fadd_rn(acc, __fmul_rn(tp[k], s.colb[rr][cc + k]));
    ph.dst[(size_t)gy * W + gx] = acc;
  }
}

__device__ __forceinline__ void decim_tile(const Phase& ph, int tile,
                                           const float* tp, int n,
                                           DecimSmem& s) {
  const int tid = threadIdx.x;
  const int r = n / 2, H = ph.H, W = ph.W;
  const int ox = (tile % ph.tiles_x) * kDW, oy = (tile / ph.tiles_x) * kDH;
  const int sh = 2 * kDH + 2 * r - 1, sw = 2 * kDW + 2 * r - 1;
  const int sy0 = 2 * oy - r, sx0 = 2 * ox - r;
  for (int e = tid; e < sh * sw; e += kThreads) {
    const int rr = e / sw, cc = e % sw;
    const int gy = min(max(sy0 + rr, 0), H - 1);
    const int gx = min(max(sx0 + cc, 0), W - 1);
    s.slab[rr][cc] = __ldcg(&ph.src[(size_t)gy * W + gx]);
  }
  __syncthreads();
  for (int e = tid; e < (kDH / 4) * sw; e += kThreads) {
    const int q0 = 4 * (e / sw), cc = e % sw;   // kept rows q0 .. q0 + 3
    float w[7], acc[4];   // w[m]: slab row 2 q0 + m + k at tap k
#pragma unroll
    for (int m = 0; m < 7; ++m) w[m] = s.slab[2 * q0 + m][cc];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = __fmul_rn(tp[0], w[2 * j]);
    for (int k = 1; k < n; ++k) {
#pragma unroll
      for (int m = 0; m < 6; ++m) w[m] = w[m + 1];
      w[6] = s.slab[2 * q0 + 6 + k][cc];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(tp[k], w[2 * j]));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) s.vert[q0 + j][cc] = acc[j];
  }
  __syncthreads();
  for (int e = tid; e < kDH * kDW; e += kThreads) {
    const int rr = e / kDW, cc = e % kDW;
    const int gy = oy + rr, gx = ox + cc;
    if (gy >= ph.Ho || gx >= ph.Wo) continue;
    float acc = __fmul_rn(tp[0], s.vert[rr][2 * cc]);
    for (int k = 1; k < n; ++k)
      acc = __fadd_rn(acc, __fmul_rn(tp[k], s.vert[rr][2 * cc + k]));
    ph.dst[(size_t)gy * ph.Wo + gx] = acc;
  }
}

// Thread 0: wait until the tile rows of the level above that descent
// tile `tile` of phase p reads (source rows 2y' - r .. 2y' + r of its
// output rows, clamped) are finished.
__device__ void wait_rows(const ChainParams& prm, int p, int tile, const int* sync) {
  const Phase& ph = prm.ph[p];
  const Phase& up = prm.ph[p - 1];
  const int r = prm.sd.n / 2;
  const int oy = (tile / ph.tiles_x) * kDH;
  const int oy_end = min(oy + kDH, ph.Ho);
  const int th = up.blur ? kBT : kDH;
  const int ty_lo = max(2 * oy - r, 0) / th;
  const int ty_hi = min(2 * (oy_end - 1) + r, ph.H - 1) / th;
  for (int ty = ty_lo; ty <= ty_hi; ++ty) {
    const volatile int* c = sync + up.done + ty;
    long long spins = 0;
    while (*c < up.tiles_x) {
      if (++spins > kMaxSpins) __trap();
      __nanosleep(32);
    }
  }
  __threadfence();
}

__device__ __forceinline__ int phase_of(const ChainParams& prm, int item) {
  int p = 0;
  while (p + 1 < prm.n_phases && item >= prm.ph[p + 1].first) ++p;
  return p;
}

__global__ void __launch_bounds__(kThreads)
chain_kernel(const __grid_constant__ ChainParams prm, int* sync) {
  __shared__ TileSmem smem;
  __shared__ float tp_pre[kMaxTaps], tp_sd[kMaxTaps];
  __shared__ int claim;
  const int tid = threadIdx.x;
  if (tid < prm.pre.n) tp_pre[tid] = prm.pre.t[tid];
  if (tid < prm.sd.n) tp_sd[tid] = prm.sd.t[tid];
  if (tid == 0) claim = atomicAdd(&sync[0], 1);
  __syncthreads();
  for (int item = claim; item < prm.n_tiles; item = claim) {
    // Thread 0 claims the next tile while this one runs: a block finishes
    // its tiles in claim order, so the claim ahead adds no wait.
    int next = 0;
    if (tid == 0) next = atomicAdd(&sync[0], 1);
    const int p = phase_of(prm, item);
    const Phase& ph = prm.ph[p];
    const int t = item - ph.first;
    if (p > 0 && tid == 0) wait_rows(prm, p, t, sync);
    __syncthreads();
    if (ph.blur)
      blur_tile(ph, t, tp_pre, prm.pre.n, smem.b);
    else
      decim_tile(ph, t, tp_sd, prm.sd.n, smem.d);
    __syncthreads();   // every output of the tile is stored ...
    if (tid == 0) {    // ... and made visible card-wide before its row counts it
      __threadfence();
      atomicAdd(&sync[ph.done + t / ph.tiles_x], 1);
      claim = next;
    }
    __syncthreads();
  }
  // The last block to leave zeroes the counters for the next launch.
  __shared__ int last;
  if (tid == 0) last = atomicAdd(&sync[1], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    for (int i = tid; i < prm.n_sync; i += kThreads) sync[i] = 0;
  }
}

// ---- K7: 2x upsample ----------------------------------------------------
// One thread per source pixel: it reads v and its right, lower and
// lower-right neighbours (clamped) and writes the 2 x 2 output quad as
// two 8-byte stores (2x is even and the output row is 2W wide, so both
// are aligned).
__global__ void __launch_bounds__(256)
upscale_kernel(const float* __restrict__ src, int H, int W,
               float* __restrict__ dst) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const int xr = min(x + 1, W - 1), yd = min(y + 1, H - 1);
  const float v = __ldg(&src[(size_t)y * W + x]);
  const float vr = __ldg(&src[(size_t)y * W + xr]);
  const float vd = __ldg(&src[(size_t)yd * W + x]);
  const float vdr = __ldg(&src[(size_t)yd * W + xr]);
  const float s_r = __fadd_rn(v, vr);
  const float s_d = __fadd_rn(v, vd);
  const float s_4 = __fadd_rn(__fadd_rn(s_r, vd), vdr);
  const size_t W2 = 2 * (size_t)W;
  float2* top = reinterpret_cast<float2*>(&dst[(2 * (size_t)y) * W2 + 2 * x]);
  float2* bot = reinterpret_cast<float2*>(&dst[(2 * (size_t)y + 1) * W2 + 2 * x]);
  *top = make_float2(v, __fmul_rn(0.5f, s_r));
  *bot = make_float2(__fmul_rn(0.5f, s_d), __fmul_rn(0.25f, s_4));
}

// The phases of the chain of src [H, W] (see sfm_base_chain) into prm;
// returns the ints of counters they need, or 0 if there is no such
// chain.  dst may be null where only the count is wanted.
int plan_chain(ChainParams& prm, const void* src, void* dst, const int64_t* offsets,
               int H, int W, int levels, bool pre) {
  const int n_phases = pre ? levels : levels - 1;
  if (H < 1 || W < 1 || levels < 1 || n_phases < 1 || n_phases > kMaxPhases ||
      (H >> (levels - 1)) < 1 || (W >> (levels - 1)) < 1)
    return 0;
  float* out = (float*)dst;
  const float* prev = (const float*)src;
  int h = H, w = W, first = 0, done = 2;
  for (int p = 0; p < n_phases; ++p) {
    Phase& ph = prm.ph[p];
    const bool blur = pre && p == 0;
    ph.src = prev;
    ph.dst = out == nullptr ? nullptr : out + offsets[p];
    ph.H = h;
    ph.W = w;
    ph.Ho = blur ? h : h / 2;
    ph.Wo = blur ? w : w / 2;
    ph.blur = blur;
    const int rows = blur ? (h + kBT - 1) / kBT : (ph.Ho + kDH - 1) / kDH;
    ph.tiles_x = blur ? (w + kBT - 1) / kBT : (ph.Wo + kDW - 1) / kDW;
    ph.tiles = ph.tiles_x * rows;
    ph.first = first;
    ph.done = done;
    first += ph.tiles;
    done += rows;
    prev = ph.dst;
    h = ph.Ho;
    w = ph.Wo;
  }
  prm.n_phases = n_phases;
  prm.n_tiles = first;
  prm.n_sync = done;
  return done;
}

bool load_taps(const float* host_taps, int n, Taps* taps) {
  if (n < 1 || n > kMaxTaps || n % 2 == 0) return false;
  for (int k = 0; k < n; ++k) taps->t[k] = host_taps[k];
  for (int k = n; k < kMaxTaps; ++k) taps->t[k] = 0.0f;
  taps->n = n;
  return true;
}

}  // namespace

// Blocks of the chain kernel that one SM holds at once (times the SM
// count: one wave, the persistent grid).
extern "C" int sfm_base_chain_blocks_per_sm(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, chain_kernel,
                                                            kThreads, 0);
}

// Counters (ints) the chain of an [H, W] source needs in `sync` (0: no
// such chain).
extern "C" int sfm_base_chain_sync_ints(int H, int W, int levels, int prefilter) {
  ChainParams prm;
  return plan_chain(prm, nullptr, nullptr, nullptr, H, W, levels, prefilter != 0);
}

// The base chain of src [H, W] in one launch of at most `blocks` blocks.
// n_pre > 0: level 0 is the prefilter of src (pre_taps, n_pre odd <=
// 17) and levels 0 .. levels - 1 are written; n_pre = 0: level 0 is src
// itself and levels 1 .. levels - 1 are written.  Level o is [H >> o,
// W >> o] (the floor at every step), a descent by sd_taps (n_sd odd <=
// 17), written at dst + offsets[i] (floats; i counts the written
// levels).  Taps and offsets are HOST arrays, copied into the launch
// arguments.  sync: sfm_base_chain_sync_ints ints on the card, zero
// before the launch and zero again after it; launches that share it
// must be ordered (one stream).
extern "C" int sfm_base_chain(const void* src, int H, int W, const float* pre_taps,
                              int n_pre, const float* sd_taps, int n_sd, int levels,
                              const int64_t* offsets, void* dst, void* sync,
                              int blocks, void* stream) {
  ChainParams prm;
  prm.pre.n = prm.sd.n = 0;
  if (blocks < 1 || sync == nullptr || dst == nullptr ||
      plan_chain(prm, src, dst, offsets, H, W, levels, n_pre > 0) == 0 ||
      (n_pre > 0 && !load_taps(pre_taps, n_pre, &prm.pre)) ||
      (levels > 1 && !load_taps(sd_taps, n_sd, &prm.sd)))
    return (int)cudaErrorInvalidValue;
  chain_kernel<<<min(blocks, prm.n_tiles), kThreads, 0, (cudaStream_t)stream>>>(
      prm, (int*)sync);
  return (int)cudaGetLastError();
}

extern "C" int sfm_scale_up(const void* src, int H, int W, void* dst,
                            void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  dim3 block(32, 8);
  dim3 grid((W + 31) / 32, (H + 7) / 8);
  upscale_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)src, H, W, (float*)dst);
  return (int)cudaGetLastError();
}
