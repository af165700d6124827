// K4 (fused orientation + descriptor), K5 (descriptor only), K8
// (orientation histograms) and K9 (K4 with staged windows): per-keypoint
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
// gathers and how many instructions a keypoint issues.  All four run one
// warp per keypoint with __syncwarp only and no block barrier: a dead
// slot's warp zeroes its row and moves on.  Lanes take the 121 gradient
// samples and the 256 rotated descriptor samples in turn; lane b sums
// orientation bin b in sample order; the smoothing and the two-peak
// search run on shuffles and ballots.  The descriptor's trilinear binning
// walks, per output, only the nonzero spatial weights of its cell (a
// compact [17]-offset, [784]-entry (sample, weight) table built from
// describe.WSP, in increasing sample order): skipping exact zeros in the
// same order leaves every sum's sequence of roundings as it was, so the
// outputs are bit for bit those of the first kernels, which scanned all
// 256 samples for each of the 128 outputs.
//
// K4 and K5 gather their samples straight from the atlas through the
// read-only cache.  K9 is the TPU kernel's windowed-DMA idea in its GPU
// form: each warp copies the support box of its keypoint's 48 x 40 patch
// (the rows and columns its taps can reach, from (fx, fy, scale): ~26 x
// 26 cells at the frontend's median scale) into its own 5 KB buffer in
// shared memory with cp.async (16-byte copies from the aligned column at
// or below the box; 4-byte copies with clamped addresses where the patch
// crosses the atlas edge, the TPU kernels' edge padding) and runs K4's
// warp device code on it, so its outputs equal K4's bit for bit.  A box
// larger than the buffer (0.4% of the frontend's keypoints) is gathered
// as K4 does.  What bounds K9 is shared memory per warp: it sets how many
// warps an SM holds to hide the copies' and the samples' latency (28,
// against 40 for K4; a buffer for the whole patch allowed 16, two
// buffers to overlap a warp's next copy with its sampling 8).
// K8 needs only the 121 gradient samples of a 24 x 16 patch: one warp per
// keypoint stages that patch in shared memory (1.5 KB).  Its time is a few dependent memory round
// trips plus the samples' arithmetic: the grid is about one wave.
//
// Histograms are built without atomics, so results are deterministic:
// lane b adds the samples of bin b in sample order.  K8 and K9 hold four
// samples per lane in registers; five ballots on their bins' bits give
// lane b the mask of a round's samples in bin b, fetched by shuffles.  K4
// walks all 121 samples from shared memory in every lane, which leaves
// it 8 fewer registers (the ballot form cost it 2%).  Every rounding step
// uses the _rn intrinsics in the order the plain PyTorch versions
// evaluate it; only the bin sums differ from theirs, which take them with
// einsum in a library's order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDescP = 40;     // descriptor patch columns (K4, K5, K9)
constexpr int kOriP = 16;      // orientation patch columns (K8)
constexpr int kBins = 32;      // histogram bins: one per lane
constexpr int kOriK = 4;       // keypoints (warps) per K8 block
constexpr int kSampleK = 4;    // keypoints (warps) per K4 and K5 block
constexpr unsigned kFull = 0xffffffffu;
static_assert(kBins == 32, "lane b holds histogram bin b");
constexpr double kPi = 3.141592653589793;
constexpr float kRad = (float)(2.0 * kPi / 360.0);
constexpr float k16Pi = (float)(16.0 / kPi);
constexpr float k4Pi = (float)(4.0 / kPi);

constexpr int kWinWarps = 4;   // warps (keypoints in flight) per K9 block
// Floats in a K9 warp's buffer: a box at scale ~1.75 (the frontend's
// keypoints reach 1.87; 0.4% of them have a larger box and gather it as
// K4 does).  5 KB a warp, with its 2.3 KB of scratch, keeps 7 blocks (28
// warps) on an SM, where a buffer for the whole patch kept 4 or 5.
constexpr int kWinCap = 1280;

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

// A patch, or the part of it that its samples read, staged in shared
// memory (K8, K9): patch cell (r, c) at p[r * pitch + c + off].
struct WindowPatch {
  const float* p;
  int pitch, off;
  __device__ __forceinline__ float at(int r, int c) const { return p[r * pitch + c + off]; }
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

// Parabolic peak at bin i of the smoothed histogram, from hs[i] and its
// two circular neighbours; in degrees.
__device__ float peak_angle(float v0, float vp, float vm, int i) {
  float denom = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, v0), vp), vm);
  if (fabsf(denom) < 1e-12f) denom = 1e-12f;
  float peak = __fadd_rn((float)i, __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(vp, vm)), denom));
  if (peak < 0.0f) peak = __fadd_rn(peak, 32.0f);
  return __fmul_rn(11.25f, peak);
}

// ---- Orientation histograms (K4, K8, K9) ----------------------------------

// Lane b's running sum of bin b over one round of 32 samples (lane L
// holds a sample's weighted magnitude g and its bin, or bin -1 for no
// sample): the round's samples of bin b are added in lane order.  Five
// ballots on the bins' bits give lane b the mask of its samples; they
// are fetched two at a time by shuffles.
__device__ __forceinline__ float add_round(float acc, float g, int bin) {
  const int lane = threadIdx.x & 31;
  unsigned m = __ballot_sync(kFull, (unsigned)bin < (unsigned)kBins);
#pragma unroll
  for (int bit = 0; bit < 5; ++bit) {
    const unsigned set = __ballot_sync(kFull, (bin >> bit) & 1);
    m &= ((lane >> bit) & 1) ? set : ~set;
  }
  for (int n = (int)__reduce_max_sync(kFull, (unsigned)__popc(m)); n > 0; n -= 2) {
    const bool h0 = m != 0;
    const int l0 = h0 ? __ffs((int)m) - 1 : lane;
    m &= m - 1;
    const bool h1 = m != 0;
    const int l1 = h1 ? __ffs((int)m) - 1 : lane;
    m &= m - 1;
    const float v0 = __shfl_sync(kFull, g, l0);
    const float v1 = __shfl_sync(kFull, g, l1);
    if (h0) acc = __fadd_rn(acc, v0);
    if (h1) acc = __fadd_rn(acc, v1);
  }
  return acc;
}

// The raw 32-bin histogram of one keypoint, by one warp: lane b returns
// bin b, the weighted magnitudes of the samples in bin b summed in sample
// order, either by ballots on samples held in registers (kBallot) or by
// every lane walking all 121 samples in the warp's [121] scratch ``gw``
// and ``bin``.
template <int P, bool kBallot, class Patch>
__device__ __forceinline__ float lane_histogram(const Patch& pt, float fx, float fy,
                                                float scale, float* gw, int* bin) {
  const int lane = threadIdx.x & 31;
  float h = 0.0f;
  if constexpr (kBallot) {
    float g[4];
    int b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // sample 32 r + lane; 121 in all
      g[r] = 0.0f;
      b[r] = -1;
      if (r < 3 || lane < 121 - 96)
        orient_sample<P>(pt, fx, fy, scale, 32 * r + lane, g[r], b[r]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) h = add_round(h, g[r], b[r]);
  } else {
    for (int s = lane; s < 121; s += 32) orient_sample<P>(pt, fx, fy, scale, s, gw[s], bin[s]);
    __syncwarp();
    for (int s = 0; s < 121; ++s)
      if (bin[s] == lane) h = __fadd_rn(h, gw[s]);
    __syncwarp();
  }
  return h;
}

// ---- K4, K5 and K9: one warp per keypoint ---------------------------------

// One warp's scratch: the orientation samples (K4's walk), then (reusing
// the bytes) the descriptor samples as the two products each can add to
// a bin.
union WarpShared {
  struct {
    float gw[121];
    int bin[121];
  } ori;
  struct {
    float t0[256];  // grad * (1 - angf): what sample s adds to bin angi
    float t1[256];  // grad * angf: what it adds to bin angi + 1 (mod 8)
    uint8_t angi[256];
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
// = (sample, weight bits) in increasing sample order; an entry adds
// (grad * (1 - angf)) * w to bin angi and (grad * angf) * w to bin
// angi + 1 (mod 8), in the plain version's order of products.
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
    sh.desc.angi[s] = (uint8_t)angi;
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

// Lowest bin of 0..30 whose lane holds pv == m, else 31 (the plain
// version's serial search).
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

// K4's function for one live keypoint, by one warp, lane b holding bin b
// of the histogram: the histogram, its smoothing, two peaks, the dup
// flag and the descriptor at peak 1.  K4 walks the histogram's samples
// in the scratch, K9 sums them by ballots (kBallot).
template <bool kBallot, class Patch>
__device__ void warp_fused(const Patch& pt, float fx, float fy, float scale,
                           const float* __restrict__ w2d,
                           const int* __restrict__ sup_off,
                           const int2* __restrict__ sup, WarpShared& sh,
                           float* __restrict__ d1, float* __restrict__ ori1,
                           float* __restrict__ ori2, uint8_t* __restrict__ dup) {
  const int lane = threadIdx.x & 31;
  const float h = lane_histogram<kDescP, kBallot>(pt, fx, fy, scale, sh.ori.gw, sh.ori.bin);
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

// A dead K4 / K9 slot's outputs, written by its warp.
__device__ __forceinline__ void zero_slot(int k, int lane, float* d1, float* ori1,
                                          float* ori2, uint8_t* dup) {
  *row_part(d1 + (size_t)k * 128, lane) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (lane == 0) {
    ori1[k] = 0.0f;
    ori2[k] = 0.0f;
    dup[k] = 0;
  }
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
    zero_slot(k, lane, d1, ori1, ori2, dup);
    return;
  }
  const Origin o = make_origin<kDescP>(xs[k], ys[k], Hp, Wp);
  const GlobalPatch<kDescP> pt{atlas, H, W, o.x0, o.y0a};
  warp_fused<false>(pt, o.fx, o.fy, scales[k], w2d, sup_off, sup, sh[warp],
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

// ---- K9: K4's warp on a staged support box ---------------------------------

constexpr int kWinRows = kDescP + 8;
// The whole patch at a 16-byte pitch: 48 rows of up to 11 aligned
// 4-float chunks (40 columns from an unaligned start).
constexpr int kWinPatch = kWinRows * (kDescP + 4);
static_assert(kWinCap % 4 == 0 && kWinCap <= kWinPatch, "16-byte aligned buffers");
// How far from (fx, fy) a keypoint's bilinear taps can reach, before the
// one-column (row) step to the second tap: the orientation samples' 5 + 1;
// the descriptor's 0.75 * scale * 7.5 * sqrt(2) (the rotated grid's
// corner, 7.95495 per unit scale, rounded up) + 1 (its +-cos / +-sin
// step).  The extra 0.01 covers the f32 roundings of the positions.
constexpr float kOriReach = 6.01f;
constexpr float kDescReach = 7.955f;
constexpr float kReachPad = 1.01f;

struct Box {
  int r0, r1, c0, c1;  // patch rows and columns, inclusive
};

// [lo, hi]: the taps that ``sample`` reads for positions within r of f
// on an n-wide axis (it clamps positions to [0, n - 1], then reads floor
// and floor + 1, clamped).
__device__ __forceinline__ void box_axis(float f, float r, int n, int& lo, int& hi) {
  const float top = (float)(n - 1);
  lo = (int)floorf(fminf(fmaxf(__fsub_rn(f, r), 0.0f), top));
  hi = min((int)floorf(fminf(fmaxf(__fadd_rn(f, r), 0.0f), top)) + 1, n - 1);
}

// The rows and columns of the 48 x 40 patch that K4's samples of a
// keypoint at patch-relative (fx, fy) can read (the whole patch for a
// scale that is not finite or reaches past 64).  ops/sample.py
// support_box is its twin.
__device__ __forceinline__ Box support_box(float fx, float fy, float scale) {
  const float rd = __fadd_rn(__fmul_rn(fabsf(scale), kDescReach), kReachPad);
  const float r = rd < 64.0f ? fmaxf(rd, kOriReach) : 64.0f;
  Box b;
  box_axis(fx, r, kDescP, b.c0, b.c1);
  box_axis(fy, r, kWinRows, b.r0, b.r1);
  return b;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A keypoint's box as staged: where its cells land, or nowhere (a box
// larger than the buffer, which the warp gathers from the atlas).
struct Staged {
  WindowPatch pt;
  bool staged;
};

// Issue the copies of a keypoint's support box into buf (one warp; each
// lane's share of the copies) and return where its cells land.  Rows
// are clamped to the atlas.  Where the atlas is 16-byte aligned with a
// row length of a multiple of 4 floats and the box lies inside it,
// 16-byte copies start from the aligned column at or below the box;
// otherwise 4-byte copies read clamped columns (the TPU kernels' edge
// padding).  Nothing is copied for a box larger than the buffer.
__device__ __forceinline__ Staged stage_box(const float* __restrict__ atlas, int H, int W,
                                            bool vec, const Origin& o, const Box& b,
                                            float* buf, int lane) {
  const int nr = b.r1 - b.r0 + 1;
  const int gx0 = o.x0 + b.c0, gx1 = o.x0 + b.c1;
  Staged st;
  st.pt.p = buf;
  if (vec && gx1 < W) {
    const int xa = gx0 & ~3;
    const int nq = ((gx1 - xa) >> 2) + 1;  // 4-float chunks per row, <= 11
    st.pt.pitch = 4 * nq;
    st.pt.off = o.x0 - xa - b.r0 * st.pt.pitch;
    st.staged = nr * st.pt.pitch <= kWinCap;
    if (st.staged)
      for (int e = lane; e < nr * 16; e += 32) {  // 16 chunk slots per row
        const int q = e & 15;
        if (q < nq) {
          const int r = e >> 4;
          const int gy = min(o.y0a + b.r0 + r, H - 1);
          cp_async16(buf + r * st.pt.pitch + 4 * q, atlas + (size_t)gy * W + xa + 4 * q);
        }
      }
  } else {
    const int nc = b.c1 - b.c0 + 1;
    st.pt.pitch = nc;
    st.pt.off = -b.c0 - b.r0 * nc;
    st.staged = nr * nc <= kWinCap;
    if (st.staged)
      for (int r = 0; r < nr; ++r) {
        const float* src = atlas + (size_t)min(o.y0a + b.r0 + r, H - 1) * W;
        for (int c = lane; c < nc; c += 32) cp_async4(buf + r * nc + c, src + min(gx0 + c, W - 1));
      }
  }
  return st;
}

constexpr int kWinSmem = kWinWarps * (kWinCap * 4 + (int)sizeof(WarpShared));

// Warp w of the grid owns slots w, w + T, w + 2T, ... (T warps in all;
// at most ``slots`` of them), so live slots, which come first, spread
// over every warp.  Each warp copies a slot's box, waits for its own
// copies, samples, and only then copies its next slot's box: the warps
// beside it on the SM hide the copy's latency.
__global__ void __launch_bounds__(kWinWarps * 32)
fused_win_kernel(const float* __restrict__ atlas, int H, int W, int Hp, int Wp,
                 const float* __restrict__ xs, const float* __restrict__ ys,
                 const float* __restrict__ scales, const int* __restrict__ count_ptr,
                 int K, int slots, const float* __restrict__ w2d,
                 const int* __restrict__ sup_off, const int2* __restrict__ sup,
                 float* __restrict__ d1, float* __restrict__ ori1,
                 float* __restrict__ ori2, uint8_t* __restrict__ dup) {
  extern __shared__ float4 win_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* buf = reinterpret_cast<float*>(win_smem) + warp * kWinCap;
  WarpShared& sh = reinterpret_cast<WarpShared*>(
      reinterpret_cast<float*>(win_smem) + kWinWarps * kWinCap)[warp];
  const int T = gridDim.x * kWinWarps;
  const int w = blockIdx.x * kWinWarps + warp;
  const int live_end = min(K, *count_ptr);
  const bool vec = (reinterpret_cast<uintptr_t>(atlas) & 15) == 0 && (W & 3) == 0;
  for (int i = 0, k = w; i < slots && k < K; ++i, k += T) {
    if (k >= live_end) {
      zero_slot(k, lane, d1, ori1, ori2, dup);
      continue;
    }
    const Origin o = make_origin<kDescP>(xs[k], ys[k], Hp, Wp);
    const float scale = scales[k];
    const Staged st = stage_box(atlas, H, W, vec, o, support_box(o.fx, o.fy, scale), buf,
                                lane);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();  // every lane's copies of this box have landed
    float* row = d1 + (size_t)k * 128;
    if (st.staged) {
      warp_fused<true>(st.pt, o.fx, o.fy, scale, w2d, sup_off, sup, sh, row, ori1 + k,
                       ori2 + k, dup + k);
    } else {
      const GlobalPatch<kDescP> pt{atlas, H, W, o.x0, o.y0a};
      warp_fused<true>(pt, o.fx, o.fy, scale, w2d, sup_off, sup, sh, row, ori1 + k,
                       ori2 + k, dup + k);
    }
    __syncwarp();  // the buffer and the scratch are free again
  }
}

// ---- K8 --------------------------------------------------------------------

__global__ void __launch_bounds__(kOriK * 32)
orientation_kernel(const float* __restrict__ img, int H, int W, int Hp, int Wp,
                   const float* __restrict__ xs, const float* __restrict__ ys,
                   const float* __restrict__ scales,
                   const int* __restrict__ count_ptr, int K,
                   float* __restrict__ out) {
  constexpr int kPatch = kOriP * (kOriP + 8);  // 384 floats
  __shared__ float s_patch[kOriK][kPatch];
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
  out[(size_t)k * kBins + lane] = lane_histogram<kOriP, true>(
      WindowPatch{p, kOriP, 0}, o.fx, o.fy, scales[k], nullptr, nullptr);
}

// K9's warps resident on the whole card (device ``dev``).
int win_resident(int dev, int* out) {
  int sms = 0, blocks = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fused_win_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kWinSmem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_win_kernel,
                                                      kWinWarps * 32, kWinSmem);
  if (e != cudaSuccess) return (int)e;
  if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
  *out = blocks * sms * kWinWarps;
  return 0;
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

// K9: as many warps as the card holds at once (or one per slot, where
// that is fewer), each walking ceil(K / warps) slots.
extern "C" int sfm_fused_orient_descriptor_win(
    const void* atlas, int H, int W, int Hp, int Wp, const void* x,
    const void* y, const void* scale, const void* count, int K,
    const void* w2d, const void* sup_off, const void* sup, void* d1, void* ori1,
    void* ori2, void* dup, void* stream) {
  if (K <= 0 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  static int resident[64];  // by device, 0 until first asked
  int dev = 0;
  const cudaError_t de = cudaGetDevice(&dev);
  if (de != cudaSuccess) return (int)de;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    const int e = win_resident(dev, &resident[dev]);
    if (e != 0) return e;
  }
  const int slots = (K + resident[dev] - 1) / resident[dev];
  const int blocks = ((K + slots - 1) / slots + kWinWarps - 1) / kWinWarps;
  fused_win_kernel<<<blocks, kWinWarps * 32, kWinSmem, (cudaStream_t)stream>>>(
      (const float*)atlas, H, W, Hp, Wp, (const float*)x, (const float*)y,
      (const float*)scale, (const int*)count, K, slots, (const float*)w2d,
      (const int*)sup_off, (const int2*)sup, (float*)d1, (float*)ori1, (float*)ori2,
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

// Resident blocks per SM of the sampling kernels on the current card:
// out[0..3] = K4, K5, K8, K9.
extern "C" int sfm_sample_blocks_per_sm(int* out) {
  int dev = 0, sms = 1, warps = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], fused_kernel,
                                                                kSampleK * 32, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], descriptor_kernel,
                                                      kSampleK * 32, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], orientation_kernel,
                                                      kOriK * 32, 0);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int code = win_resident(dev, &warps);
  out[3] = warps / (sms * kWinWarps);
  return code;
}
