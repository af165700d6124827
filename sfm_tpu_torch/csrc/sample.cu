// K4 (fused orientation + descriptor), K5 (descriptor only), K8
// (orientation histograms) and K9 (K4 with staged patches): per-keypoint
// sampling from the octave atlas.
//
// Replaces sfm_tpu/ops/pallas_sample.py:788 fused_orient_descriptor (as
// run under the duplicate split, phases=4), :414 descriptor_sample, :578
// orientation_histogram_sample and :998 fused_orient_descriptor_win.
// See sfm_tpu_torch/ops/sample.py for the contracts.
//
// Bounds and design.  A keypoint touches < 8 KB of the atlas and does
// ~30k operations, so no kernel here is near the card's byte or operation
// rate: what bounds them is the latency of their scattered bilinear
// gathers and how many instructions a keypoint issues.  K4 and K5 run
// one warp per keypoint, 4 keypoints per block, with __syncwarp only and
// no block barrier: a dead slot's warp zeroes its row and leaves.  Lanes
// take the 121 gradient samples and the 256 rotated descriptor samples
// in turn; lane b sums orientation bin b in sample order; the smoothing
// and the two-peak search run on shuffles and ballots.  The descriptor's
// trilinear binning walks, per output, only the nonzero spatial weights
// of its cell (a compact [17]-offset, [784]-entry (sample, weight) table
// built from describe.WSP, in increasing sample order), where the first
// kernels scanned all 256 samples for each of the 128 outputs: skipping
// exact zeros in the same order leaves every sum's sequence of roundings
// as it was, so the outputs are bit for bit those of one 128-thread
// block per keypoint.  Their samples are gathered straight from the
// atlas through the read-only cache, which on the card beat each warp
// staging its 48 x 40 patch in shared memory (PERF.md).  K9 is the TPU
// kernel's windowed-DMA idea in its GPU form: a block of 128 threads
// owns 4 keypoints, issues cp.async copies of all 4 of their 48 x 40
// patches into shared memory (clamped source addresses: the TPU
// kernels' edge padding) before it consumes the first, and then runs
// the block-level form of K4's device code on samples read from shared
// memory, so its outputs equal K4's bit for bit.  K8 needs only the 121
// gradient samples of a 24 x 16 patch: one warp per keypoint (4 per
// block) stages that patch in shared memory (1.5 KB) and each lane sums
// one bin.
// Histograms are built without atomics (each of 32 threads sums its own
// bin in sample order, so results are deterministic) and every rounding
// step uses the _rn intrinsics in the order the plain PyTorch versions
// evaluate it; only the bin sums differ from theirs, which take them
// with einsum in a library's order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDescP = 40;     // descriptor patch columns (K4, K5, K9)
constexpr int kOriP = 16;      // orientation patch columns (K8)
constexpr int kThreads = 128;  // K9's block: 4 warps on one keypoint at a time
constexpr int kBins = 32;      // histogram bins: one per lane in K4 and K8
constexpr int kWinK = 4;       // keypoints per K9 block
constexpr int kOriK = 4;       // keypoints (warps) per K8 block
constexpr int kSampleK = 4;    // keypoints (warps) per K4 and K5 block
constexpr unsigned kFull = 0xffffffffu;
static_assert(kBins == 32, "K4 and K8 hold histogram bin b in lane b");
constexpr double kPi = 3.141592653589793;
constexpr float kRad = (float)(2.0 * kPi / 360.0);
constexpr float k16Pi = (float)(16.0 / kPi);
constexpr float k4Pi = (float)(4.0 / kPi);

struct Origin {
  int x0, y0a;
  float fx, fy;
};

// Patch origin of the TPU kernels for a P-column, (P + 8)-row patch:
// x0 = clip(floor(x) - (P/2 - 1), 0, Wp - P), rows from the 8-aligned
// y0a; (fx, fy) are patch-relative.
template <int P>
__device__ Origin make_origin(float x, float y, int Hp, int Wp) {
  Origin o;
  int x0 = (int)floorf(x) - P / 2 + 1;
  x0 = min(max(x0, 0), max(Wp - P, 0));
  int y0 = (int)floorf(y) - P / 2 + 1;
  y0 = min(max(y0, 0), max(Hp - P, 0));
  o.x0 = x0;
  o.fx = __fsub_rn(x, (float)x0);
  o.y0a = max(min((y0 / 8) * 8, Hp - P - 8), 0);
  o.fy = __fadd_rn(__fsub_rn(y, (float)y0), (float)(y0 - o.y0a));
  return o;
}

// A patch read straight from the atlas, clamped to it (K4, K5).
template <int P>
struct GlobalPatch {
  const float* atlas;
  int H, W, x0, y0a;
  __device__ __forceinline__ float at(int r, int c) const {
    const int gy = min(max(y0a + r, 0), H - 1);
    const int gx = min(max(x0 + c, 0), W - 1);
    return __ldg(&atlas[(size_t)gy * W + gx]);
  }
};

// A patch staged in shared memory, row-major [P + 8][P] (K8, K9).
template <int P>
struct SharedPatch {
  const float* p;
  __device__ __forceinline__ float at(int r, int c) const { return p[r * P + c]; }
};

// Bilinear sample at patch-relative (px, py), clamped to the patch.
template <int P, class Patch>
__device__ __forceinline__ float sample(const Patch& pt, float px, float py) {
  constexpr int kRows = P + 8;
  px = fminf(fmaxf(px, 0.0f), (float)(P - 1));
  py = fminf(fmaxf(py, 0.0f), (float)(kRows - 1));
  const float ixf = floorf(px), iyf = floorf(py);
  const float fxw = __fsub_rn(px, ixf), fyw = __fsub_rn(py, iyf);
  const int ix = (int)ixf, iy = (int)iyf;
  const int ix1 = min(ix + 1, P - 1), iy1 = min(iy + 1, kRows - 1);
  const float a00 = pt.at(iy, ix);
  const float a01 = pt.at(iy, ix1);
  const float a10 = pt.at(iy1, ix);
  const float a11 = pt.at(iy1, ix1);
  const float ux = __fsub_rn(1.0f, fxw), uy = __fsub_rn(1.0f, fyw);
  const float lft = __fadd_rn(__fmul_rn(uy, a00), __fmul_rn(fyw, a10));
  const float rgt = __fadd_rn(__fmul_rn(uy, a01), __fmul_rn(fyw, a11));
  return __fadd_rn(__fmul_rn(ux, lft), __fmul_rn(fxw, rgt));
}

// Gradient sample s (0..120) of the 11 x 11 orientation window: its
// Gaussian-weighted magnitude and its bin.
template <int P, class Patch>
__device__ __forceinline__ void orient_sample(const Patch& pt, float fx, float fy,
                                              float scale, int s, float& gw,
                                              int& bin) {
  const float xd = (float)(s % 11) - 5.0f;
  const float yd = (float)(s / 11) - 5.0f;
  const float bxo = __fadd_rn(fx, xd), byo = __fadd_rn(fy, yd);
  const float v0 = sample<P>(pt, __fadd_rn(bxo, 1.0f), byo);
  const float v1 = sample<P>(pt, __fadd_rn(bxo, -1.0f), byo);
  const float v2 = sample<P>(pt, bxo, __fadd_rn(byo, 1.0f));
  const float v3 = sample<P>(pt, bxo, __fadd_rn(byo, -1.0f));
  const float dx = __fsub_rn(v0, v1), dy = __fsub_rn(v2, v3);
  const float grad = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  const float s15 = __fmul_rn(1.5f, scale);
  const float inv2s2 = __fdiv_rn(-1.0f, __fmul_rn(2.0f, __fmul_rn(s15, s15)));
  const float w = expf(__fmul_rn(inv2s2, xd * xd + yd * yd));
  float b = floorf(__fadd_rn(__fmul_rn(k16Pi, atan2f(dy, dx)), 16.5f));
  if (b > 31.0f) b = 0.0f;
  gw = __fmul_rn(grad, w);
  bin = (int)b;
}

// Descriptor sample s (0..255) of the rotated 16 x 16 grid: its
// windowed gradient magnitude, its angle bin and the bin's fraction.
template <class Patch>
__device__ __forceinline__ void desc_sample(const Patch& pt, float fx, float fy,
                                            float sc, float ca, float sa, float w2,
                                            int s, float& grad, float& angf, int& angi) {
  const float i_f = (float)(s % 16) - 7.5f;
  const float j_f = (float)(s / 16) - 7.5f;
  const float bx = __fadd_rn(fx, __fmul_rn(sc, __fsub_rn(__fmul_rn(i_f, ca),
                                                         __fmul_rn(j_f, sa))));
  const float by = __fadd_rn(fy, __fmul_rn(sc, __fadd_rn(__fmul_rn(i_f, sa),
                                                         __fmul_rn(j_f, ca))));
  const float v0 = sample<kDescP>(pt, __fadd_rn(bx, ca), __fadd_rn(by, sa));
  const float v1 = sample<kDescP>(pt, __fadd_rn(bx, -ca), __fadd_rn(by, -sa));
  const float v2 = sample<kDescP>(pt, __fadd_rn(bx, -sa), __fadd_rn(by, ca));
  const float v3 = sample<kDescP>(pt, __fadd_rn(bx, sa), __fadd_rn(by, -ca));
  const float dx = __fsub_rn(v0, v1), dy = __fsub_rn(v2, v3);
  grad = __fmul_rn(w2, __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy))));
  const float ang = __fadd_rn(__fmul_rn(k4Pi, atan2f(dy, dx)), 4.0f);
  const float ai = fminf(fmaxf(floorf(ang), 0.0f), 7.0f);
  angf = __fsub_rn(ang, ai);
  angi = (int)ai;
}

struct DescShared {
  float grad[256];
  float angf[256];
  int angi[256];
};

// Raw 128-D descriptor (16 x 16 rotated samples, 4 x 4 cells x 8 bins,
// trilinear) of one keypoint, written to out[0..127].  Called by all
// 128 threads of a K9 block.
template <class Patch>
__device__ void descriptor(const Patch& pt, float fx, float fy, float scale,
                           float ori, const float* __restrict__ w2d,
                           const float* __restrict__ wsp, DescShared& sh,
                           float* __restrict__ out) {
  const int tid = threadIdx.x;
  const float theta = __fmul_rn(ori, kRad);
  const float ca = cosf(theta), sa = sinf(theta);
  const float sc = __fmul_rn(0.75f, scale);
  for (int s = tid; s < 256; s += kThreads)
    desc_sample(pt, fx, fy, sc, ca, sa, w2d[s], s, sh.grad[s], sh.angf[s], sh.angi[s]);
  __syncthreads();
  const int sp = tid >> 3, a = tid & 7;
  float acc = 0.0f;
  for (int s = 0; s < 256; ++s) {
    const float w = __ldg(&wsp[s * 16 + sp]);
    if (w == 0.0f) continue;
    const int ai = sh.angi[s];
    const int ai2 = ai + 1 > 7 ? 0 : ai + 1;
    float wa;
    if (ai == a)
      wa = __fsub_rn(1.0f, sh.angf[s]);
    else if (ai2 == a)
      wa = sh.angf[s];
    else
      continue;
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(sh.grad[s], wa), w));
  }
  out[tid] = acc;
}

// Parabolic peak at bin i of the smoothed histogram, from hs[i] and its
// two circular neighbours; in degrees.
__device__ float peak_angle(float v0, float vp, float vm, int i) {
  float denom = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, v0), vp), vm);
  if (fabsf(denom) < 1e-12f) denom = 1e-12f;
  float peak = __fadd_rn((float)i, __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(vp, vm)), denom));
  if (peak < 0.0f) peak = __fadd_rn(peak, 32.0f);
  return __fmul_rn(11.25f, peak);
}

__device__ float peak_angle(const float* hs, int i) {
  return peak_angle(hs[i], hs[(i + 1) % kBins], hs[(i + kBins - 1) % kBins], i);
}

struct FusedShared {
  float gw[121];
  int bin[121];
  float h[kBins];
  float hs[kBins];
  float ori;
  DescShared desc;
};

// K9's function for one live keypoint: histogram, smoothing, two peaks,
// dup flag, and the descriptor at peak 1.  Called by all 128 threads.
template <class Patch>
__device__ void fused_one(const Patch& pt, float fx, float fy, float scale,
                          const float* __restrict__ w2d,
                          const float* __restrict__ wsp, FusedShared& sh,
                          float* __restrict__ d1, float* __restrict__ ori1,
                          float* __restrict__ ori2, uint8_t* __restrict__ dup) {
  const int tid = threadIdx.x;
  if (tid < 121) orient_sample<kDescP>(pt, fx, fy, scale, tid, sh.gw[tid], sh.bin[tid]);
  __syncthreads();
  if (tid < kBins) {  // each thread sums its own bin, in sample order
    float acc = 0.0f;
    for (int s = 0; s < 121; ++s)
      if (sh.bin[s] == tid) acc = __fadd_rn(acc, sh.gw[s]);
    sh.h[tid] = acc;
  }
  __syncthreads();
  if (tid < kBins) {  // circular [1, 4, 6, 4, 1] smoothing
    const int i = tid;
    const float c = __fmul_rn(6.0f, sh.h[i]);
    const float n1 = __fmul_rn(4.0f, __fadd_rn(sh.h[(i + kBins - 1) % kBins],
                                               sh.h[(i + 1) % kBins]));
    sh.hs[i] = __fadd_rn(__fadd_rn(__fadd_rn(c, n1), sh.h[(i + kBins - 2) % kBins]),
                         sh.h[(i + 2) % kBins]);
  }
  __syncthreads();
  if (tid == 0) {
    float pv[kBins];
    float m1 = -1.0f;
    for (int i = 0; i < kBins; ++i) {
      const float h = sh.hs[i];
      const bool peak = h > sh.hs[(i + kBins - 1) % kBins] && h >= sh.hs[(i + 1) % kBins];
      pv[i] = peak ? h : 0.0f;
      m1 = fmaxf(m1, pv[i]);
    }
    int i1 = 0;  // lowest bin of the maximum
    while (i1 < kBins - 1 && pv[i1] != m1) ++i1;
    pv[i1] = 0.0f;
    float m2 = -1.0f;
    for (int i = 0; i < kBins; ++i) m2 = fmaxf(m2, pv[i]);
    int i2 = 0;
    while (i2 < kBins - 1 && pv[i2] != m2) ++i2;
    const float o1 = m1 > 0.0f ? peak_angle(sh.hs, i1) : 0.0f;
    const float o2 = m2 > 0.0f ? peak_angle(sh.hs, i2) : 0.0f;
    *ori1 = o1;
    *ori2 = o2;
    *dup = (m2 > __fmul_rn(0.8f, m1) && m2 > 0.0f) ? 1 : 0;
    sh.ori = o1;
  }
  __syncthreads();
  descriptor(pt, fx, fy, scale, sh.ori, w2d, wsp, sh.desc, d1);
}

__device__ __forceinline__ void zero_fused_row(int k, float* d1, float* ori1,
                                               float* ori2, uint8_t* dup) {
  d1[(size_t)k * 128 + threadIdx.x] = 0.0f;
  if (threadIdx.x == 0) {
    ori1[k] = 0.0f;
    ori2[k] = 0.0f;
    dup[k] = 0;
  }
}

// ---- K4 and K5: one warp per keypoint ------------------------------------

// One warp's scratch: the orientation samples, then (reusing the bytes)
// the descriptor samples as the two products each can add to a bin.
union WarpShared {
  struct {
    float gw[121];
    int bin[121];
  } ori;
  struct {
    float t0[256];  // grad * (1 - angf): what sample s adds to bin angi
    float t1[256];  // grad * angf: what it adds to bin angi + 1 (mod 8)
    int angi[256];
  } desc;
};

// The warp's 4 floats of a 128-float row (lane l: row[4l .. 4l + 3]).
__device__ __forceinline__ float4* row_part(float* row, int lane) {
  return reinterpret_cast<float4*>(row) + lane;
}

// Raw 128-D descriptor of one keypoint, written to out[0..127] (16-byte
// aligned).  Called by the 32 lanes of a warp.  Lane l owns outputs
// 4l .. 4l + 3: cell l / 2, angle bins 4 (l % 2) .. + 3, each summed
// over the cell's support entries sup[sup_off[cell] .. sup_off[cell + 1])
// = (sample, weight bits) in increasing sample order, with the roundings
// of ``descriptor`` above.
template <class Patch>
__device__ void warp_descriptor(const Patch& pt, float fx, float fy, float scale,
                                float ori, const float* __restrict__ w2d,
                                const int* __restrict__ sup_off,
                                const int2* __restrict__ sup, WarpShared& sh,
                                float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const float theta = __fmul_rn(ori, kRad);
  const float ca = cosf(theta), sa = sinf(theta);
  const float sc = __fmul_rn(0.75f, scale);
  for (int s = lane; s < 256; s += 32) {
    float grad, angf;
    int angi;
    desc_sample(pt, fx, fy, sc, ca, sa, __ldg(&w2d[s]), s, grad, angf, angi);
    sh.desc.t0[s] = __fmul_rn(grad, __fsub_rn(1.0f, angf));
    sh.desc.t1[s] = __fmul_rn(grad, angf);
    sh.desc.angi[s] = angi;
  }
  __syncwarp();
  const int cell = lane >> 1, a0 = (lane & 1) * 4;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int end = __ldg(&sup_off[cell + 1]);
  for (int e = __ldg(&sup_off[cell]); e < end; ++e) {
    const int2 sw = __ldg(&sup[e]);
    const float w = __int_as_float(sw.y);
    const int ai = sh.desc.angi[sw.x];
    const int ai2 = ai + 1 > 7 ? 0 : ai + 1;
    const float c0 = __fmul_rn(sh.desc.t0[sw.x], w);
    const float c1 = __fmul_rn(sh.desc.t1[sw.x], w);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (ai == a0 + j)
        acc[j] = __fadd_rn(acc[j], c0);
      else if (ai2 == a0 + j)
        acc[j] = __fadd_rn(acc[j], c1);
    }
  }
  *row_part(out, lane) = make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// The warp's maximum of v (every lane gets it).
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Lowest bin of 0..30 whose lane holds pv == m, else 31 (``fused_one``'s
// serial search).
__device__ __forceinline__ int lowest_bin_of(float pv, float m) {
  const unsigned eq = __ballot_sync(kFull, pv == m) & (kFull >> 1);
  return eq ? __ffs(eq) - 1 : kBins - 1;
}

// Peak angle at bin i, evaluated by every lane on shuffled values.
__device__ __forceinline__ float warp_peak_angle(float hs, int i) {
  const float v0 = __shfl_sync(kFull, hs, i);
  const float vp = __shfl_sync(kFull, hs, (i + 1) & (kBins - 1));
  const float vm = __shfl_sync(kFull, hs, (i + kBins - 1) & (kBins - 1));
  return peak_angle(v0, vp, vm, i);
}

// K4's function for one live keypoint, by one warp: ``fused_one``'s
// outputs bit for bit, lane b holding bin b of the histogram.
template <class Patch>
__device__ void warp_fused(const Patch& pt, float fx, float fy, float scale,
                           const float* __restrict__ w2d,
                           const int* __restrict__ sup_off,
                           const int2* __restrict__ sup, WarpShared& sh,
                           float* __restrict__ d1, float* __restrict__ ori1,
                           float* __restrict__ ori2, uint8_t* __restrict__ dup) {
  const int lane = threadIdx.x & 31;
  for (int s = lane; s < 121; s += 32)
    orient_sample<kDescP>(pt, fx, fy, scale, s, sh.ori.gw[s], sh.ori.bin[s]);
  __syncwarp();
  float h = 0.0f;  // lane = bin, summed in sample order
  for (int s = 0; s < 121; ++s)
    if (sh.ori.bin[s] == lane) h = __fadd_rn(h, sh.ori.gw[s]);
  __syncwarp();  // the scratch holds descriptor samples from here on
  // Circular [1, 4, 6, 4, 1] smoothing.
  const float hm1 = __shfl_sync(kFull, h, (lane + kBins - 1) & (kBins - 1));
  const float hp1 = __shfl_sync(kFull, h, (lane + 1) & (kBins - 1));
  const float hm2 = __shfl_sync(kFull, h, (lane + kBins - 2) & (kBins - 1));
  const float hp2 = __shfl_sync(kFull, h, (lane + 2) & (kBins - 1));
  const float n1 = __fmul_rn(4.0f, __fadd_rn(hm1, hp1));
  const float hs = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(6.0f, h), n1), hm2), hp2);
  // Two peaks: local maxima, the largest (ties to the lowest bin), then
  // the largest of the rest.
  const float sm1 = __shfl_sync(kFull, hs, (lane + kBins - 1) & (kBins - 1));
  const float sp1 = __shfl_sync(kFull, hs, (lane + 1) & (kBins - 1));
  float pv = (hs > sm1 && hs >= sp1) ? hs : 0.0f;
  const float m1 = fmaxf(-1.0f, warp_max(pv));
  const int i1 = lowest_bin_of(pv, m1);
  if (lane == i1) pv = 0.0f;
  const float m2 = fmaxf(-1.0f, warp_max(pv));
  const int i2 = lowest_bin_of(pv, m2);
  const float a1 = warp_peak_angle(hs, i1);
  const float a2 = warp_peak_angle(hs, i2);
  const float o1 = m1 > 0.0f ? a1 : 0.0f;
  if (lane == 0) {
    *ori1 = o1;
    *ori2 = m2 > 0.0f ? a2 : 0.0f;
    *dup = (m2 > __fmul_rn(0.8f, m1) && m2 > 0.0f) ? 1 : 0;
  }
  warp_descriptor(pt, fx, fy, scale, o1, w2d, sup_off, sup, sh, d1);
}

__global__ void __launch_bounds__(kSampleK * 32)
fused_kernel(const float* __restrict__ atlas, int H, int W, int Hp, int Wp,
             const float* __restrict__ xs, const float* __restrict__ ys,
             const float* __restrict__ scales, const int* __restrict__ count_ptr,
             int K, const float* __restrict__ w2d, const int* __restrict__ sup_off,
             const int2* __restrict__ sup, float* __restrict__ d1,
             float* __restrict__ ori1, float* __restrict__ ori2,
             uint8_t* __restrict__ dup) {
  __shared__ WarpShared sh[kSampleK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * kSampleK + warp;
  if (k >= K) return;  // warp-uniform; the warps never wait on each other
  if (k >= *count_ptr) {
    *row_part(d1 + (size_t)k * 128, lane) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (lane == 0) {
      ori1[k] = 0.0f;
      ori2[k] = 0.0f;
      dup[k] = 0;
    }
    return;
  }
  const Origin o = make_origin<kDescP>(xs[k], ys[k], Hp, Wp);
  const GlobalPatch<kDescP> pt{atlas, H, W, o.x0, o.y0a};
  warp_fused(pt, o.fx, o.fy, scales[k], w2d, sup_off, sup, sh[warp],
             d1 + (size_t)k * 128, ori1 + k, ori2 + k, dup + k);
}

__global__ void __launch_bounds__(kSampleK * 32)
descriptor_kernel(const float* __restrict__ atlas, int H, int W, int Hp, int Wp,
                  const float* __restrict__ xs, const float* __restrict__ ys,
                  const float* __restrict__ scales, const float* __restrict__ oris,
                  const int* __restrict__ count_ptr, int K,
                  const float* __restrict__ w2d, const int* __restrict__ sup_off,
                  const int2* __restrict__ sup, float* __restrict__ out) {
  __shared__ WarpShared sh[kSampleK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * kSampleK + warp;
  if (k >= K) return;  // warp-uniform
  float* row = out + (size_t)k * 128;
  if (k >= *count_ptr) {
    *row_part(row, lane) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const Origin o = make_origin<kDescP>(xs[k], ys[k], Hp, Wp);
  const GlobalPatch<kDescP> pt{atlas, H, W, o.x0, o.y0a};
  warp_descriptor(pt, o.fx, o.fy, scales[k], oris[k], w2d, sup_off, sup, sh[warp], row);
}

// ---- K9 ------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most `pending` of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  static_assert(kWinK == 4, "one case per possible count");
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::); break;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_win_kernel(const float* __restrict__ atlas, int H, int W, int Hp, int Wp,
                 const float* __restrict__ xs, const float* __restrict__ ys,
                 const float* __restrict__ scales, const int* __restrict__ count_ptr,
                 int K, const float* __restrict__ w2d,
                 const float* __restrict__ wsp, float* __restrict__ d1,
                 float* __restrict__ ori1, float* __restrict__ ori2,
                 uint8_t* __restrict__ dup) {
  constexpr int kPatch = kDescP * (kDescP + 8);  // 1,920 floats
  __shared__ __align__(16) float s_patch[kWinK][kPatch];
  __shared__ FusedShared sh;
  const int k0 = blockIdx.x * kWinK;
  const int count = *count_ptr;
  // Issue the copies of all this block's patches (one group each, empty
  // for a dead slot) before the first one is consumed.
  for (int j = 0; j < kWinK; ++j) {
    const int k = k0 + j;
    if (k < K && k < count) {
      const Origin o = make_origin<kDescP>(xs[k], ys[k], Hp, Wp);
      for (int e = threadIdx.x; e < kPatch; e += kThreads) {
        const int gy = min(max(o.y0a + e / kDescP, 0), H - 1);
        const int gx = min(max(o.x0 + e % kDescP, 0), W - 1);
        cp_async4(&s_patch[j][e], atlas + (size_t)gy * W + gx);
      }
    }
    cp_async_commit();
  }
  for (int j = 0; j < kWinK; ++j) {
    const int k = k0 + j;
    if (k >= K) break;  // block-uniform
    cp_async_wait(kWinK - 1 - j);
    __syncthreads();
    if (k >= count) {
      zero_fused_row(k, d1, ori1, ori2, dup);
      continue;
    }
    const Origin o = make_origin<kDescP>(xs[k], ys[k], Hp, Wp);
    const SharedPatch<kDescP> pt{s_patch[j]};
    fused_one(pt, o.fx, o.fy, scales[k], w2d, wsp, sh, d1 + (size_t)k * 128,
              ori1 + k, ori2 + k, dup + k);
  }
}

// ---- K8 ------------------------------------------------------------------

__global__ void __launch_bounds__(kOriK * 32)
orientation_kernel(const float* __restrict__ img, int H, int W, int Hp, int Wp,
                   const float* __restrict__ xs, const float* __restrict__ ys,
                   const float* __restrict__ scales,
                   const int* __restrict__ count_ptr, int K,
                   float* __restrict__ out) {
  constexpr int kPatch = kOriP * (kOriP + 8);  // 384 floats
  __shared__ float s_patch[kOriK][kPatch];
  __shared__ float s_gw[kOriK][121];
  __shared__ int s_bin[kOriK][121];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * kOriK + warp;
  if (k >= K) return;  // warp-uniform; the warps never wait on each other
  if (k >= *count_ptr) {
    out[(size_t)k * kBins + lane] = 0.0f;
    return;
  }
  const Origin o = make_origin<kOriP>(xs[k], ys[k], Hp, Wp);
  float* p = s_patch[warp];
  for (int e = lane; e < kPatch; e += 32) {
    const int gy = min(max(o.y0a + e / kOriP, 0), H - 1);
    const int gx = min(max(o.x0 + e % kOriP, 0), W - 1);
    p[e] = __ldg(&img[(size_t)gy * W + gx]);
  }
  __syncwarp();
  const SharedPatch<kOriP> pt{p};
  const float scale = scales[k];
  for (int s = lane; s < 121; s += 32)
    orient_sample<kOriP>(pt, o.fx, o.fy, scale, s, s_gw[warp][s], s_bin[warp][s]);
  __syncwarp();
  float acc = 0.0f;  // lane = bin, summed in sample order
  for (int s = 0; s < 121; ++s)
    if (s_bin[warp][s] == lane) acc = __fadd_rn(acc, s_gw[warp][s]);
  out[(size_t)k * kBins + lane] = acc;
}

}  // namespace

extern "C" int sfm_fused_orient_descriptor(
    const void* atlas, int H, int W, int Hp, int Wp, const void* x,
    const void* y, const void* scale, const void* count, int K,
    const void* w2d, const void* sup_off, const void* sup, void* d1, void* ori1,
    void* ori2, void* dup, void* stream) {
  if (K <= 0 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (K + kSampleK - 1) / kSampleK;
  fused_kernel<<<blocks, kSampleK * 32, 0, (cudaStream_t)stream>>>(
      (const float*)atlas, H, W, Hp, Wp, (const float*)x, (const float*)y,
      (const float*)scale, (const int*)count, K, (const float*)w2d,
      (const int*)sup_off, (const int2*)sup, (float*)d1, (float*)ori1,
      (float*)ori2, (uint8_t*)dup);
  return (int)cudaGetLastError();
}

extern "C" int sfm_fused_orient_descriptor_win(
    const void* atlas, int H, int W, int Hp, int Wp, const void* x,
    const void* y, const void* scale, const void* count, int K,
    const void* w2d, const void* wsp, void* d1, void* ori1, void* ori2,
    void* dup, void* stream) {
  if (K <= 0 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (K + kWinK - 1) / kWinK;
  fused_win_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)atlas, H, W, Hp, Wp, (const float*)x, (const float*)y,
      (const float*)scale, (const int*)count, K, (const float*)w2d,
      (const float*)wsp, (float*)d1, (float*)ori1, (float*)ori2,
      (uint8_t*)dup);
  return (int)cudaGetLastError();
}

extern "C" int sfm_descriptor_sample(const void* atlas, int H, int W, int Hp,
                                     int Wp, const void* x, const void* y,
                                     const void* scale, const void* ori,
                                     const void* count, int K, const void* w2d,
                                     const void* sup_off, const void* sup,
                                     void* out, void* stream) {
  if (K <= 0 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (K + kSampleK - 1) / kSampleK;
  descriptor_kernel<<<blocks, kSampleK * 32, 0, (cudaStream_t)stream>>>(
      (const float*)atlas, H, W, Hp, Wp, (const float*)x, (const float*)y,
      (const float*)scale, (const float*)ori, (const int*)count, K,
      (const float*)w2d, (const int*)sup_off, (const int2*)sup, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int sfm_orientation_histogram_sample(
    const void* img, int H, int W, int Hp, int Wp, const void* x,
    const void* y, const void* scale, const void* count, int K, void* out,
    void* stream) {
  if (K <= 0 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (K + kOriK - 1) / kOriK;
  orientation_kernel<<<blocks, kOriK * 32, 0, (cudaStream_t)stream>>>(
      (const float*)img, H, W, Hp, Wp, (const float*)x, (const float*)y,
      (const float*)scale, (const int*)count, K, (float*)out);
  return (int)cudaGetLastError();
}
