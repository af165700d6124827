// K4 (fused orientation + descriptor), K5 (descriptor only), K8
// (orientation histograms) and K9 (K4 with staged patches): per-keypoint
// sampling from the octave atlas.
//
// Replaces sfm_tpu/ops/pallas_sample.py:788 fused_orient_descriptor (as
// run under the duplicate split, phases=4), :414 descriptor_sample, :578
// orientation_histogram_sample and :998 fused_orient_descriptor_win.
// See sfm_tpu_torch/ops/sample.py for the contracts.
//
// Bounds and design.  K4 and K5 run one 128-thread block per keypoint and
// gather their bilinear samples from the atlas in device memory through
// the read-only cache: ~1,500 scattered 4-byte loads per keypoint, bound
// by gather latency rather than by bytes (each keypoint touches < 8 KB).
// K9 is the TPU kernel's windowed-DMA idea in its GPU form: a block of
// 128 threads owns 4 keypoints, issues cp.async copies of all 4 of their
// 48 x 40 patches into shared memory (clamped source addresses: the TPU
// kernels' edge padding) before it consumes the first, and then runs
// K4's device code on samples read from shared memory, so its outputs
// equal K4's bit for bit.  K8 needs only the 121 gradient samples of a
// 24 x 16 patch: one warp per keypoint (4 per block) stages that patch in
// shared memory (1.5 KB) and each lane sums one bin, with no block-wide
// barrier.  Histograms are built without atomics (each of 32 threads
// sums its own bin in sample order, so results are deterministic) and
// every rounding step uses the _rn intrinsics in the order the plain
// PyTorch versions evaluate it; only the bin sums differ from theirs,
// which take them with einsum in a library's order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDescP = 40;     // descriptor patch columns (K4, K5, K9)
constexpr int kOriP = 16;      // orientation patch columns (K8)
constexpr int kThreads = 128;
constexpr int kBins = 32;
constexpr int kWinK = 4;       // keypoints per K9 block
constexpr int kOriK = 4;       // keypoints (warps) per K8 block
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

struct DescShared {
  float grad[256];
  float angf[256];
  int angi[256];
};

// Raw 128-D descriptor (16 x 16 rotated samples, 4 x 4 cells x 8 bins,
// trilinear) of one keypoint, written to out[0..127].  Called by all
// 128 threads of the block.
template <class Patch>
__device__ void descriptor(const Patch& pt, float fx, float fy, float scale,
                           float ori, const float* __restrict__ w2d,
                           const float* __restrict__ wsp, DescShared& sh,
                           float* __restrict__ out) {
  const int tid = threadIdx.x;
  const float theta = __fmul_rn(ori, kRad);
  const float ca = cosf(theta), sa = sinf(theta);
  const float sc = __fmul_rn(0.75f, scale);
  for (int s = tid; s < 256; s += kThreads) {
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
    sh.grad[s] = __fmul_rn(w2d[s], __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx),
                                                        __fmul_rn(dy, dy))));
    const float ang = __fadd_rn(__fmul_rn(k4Pi, atan2f(dy, dx)), 4.0f);
    const float ai = fminf(fmaxf(floorf(ang), 0.0f), 7.0f);
    sh.angf[s] = __fsub_rn(ang, ai);
    sh.angi[s] = (int)ai;
  }
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

__device__ float peak_angle(const float* hs, int i) {
  const float v0 = hs[i];
  const float vp = hs[(i + 1) % kBins];
  const float vm = hs[(i + kBins - 1) % kBins];
  float denom = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, v0), vp), vm);
  if (fabsf(denom) < 1e-12f) denom = 1e-12f;
  float peak = __fadd_rn((float)i, __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(vp, vm)), denom));
  if (peak < 0.0f) peak = __fadd_rn(peak, 32.0f);
  return __fmul_rn(11.25f, peak);
}

struct FusedShared {
  float gw[121];
  int bin[121];
  float h[kBins];
  float hs[kBins];
  float ori;
  DescShared desc;
};

// K4's function for one live keypoint: histogram, smoothing, two peaks,
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

__global__ void __launch_bounds__(kThreads)
fused_kernel(const float* __restrict__ atlas, int H, int W, int Hp, int Wp,
             const float* __restrict__ xs, const float* __restrict__ ys,
             const float* __restrict__ scales, const int* __restrict__ count_ptr,
             const float* __restrict__ w2d, const float* __restrict__ wsp,
             float* __restrict__ d1, float* __restrict__ ori1,
             float* __restrict__ ori2, uint8_t* __restrict__ dup) {
  __shared__ FusedShared sh;
  const int k = blockIdx.x;
  if (k >= *count_ptr) {  // block-uniform: the whole block leaves together
    zero_fused_row(k, d1, ori1, ori2, dup);
    return;
  }
  const Origin o = make_origin<kDescP>(xs[k], ys[k], Hp, Wp);
  const GlobalPatch<kDescP> pt{atlas, H, W, o.x0, o.y0a};
  fused_one(pt, o.fx, o.fy, scales[k], w2d, wsp, sh, d1 + (size_t)k * 128,
            ori1 + k, ori2 + k, dup + k);
}

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

__global__ void __launch_bounds__(kThreads)
descriptor_kernel(const float* __restrict__ atlas, int H, int W, int Hp, int Wp,
                  const float* __restrict__ xs, const float* __restrict__ ys,
                  const float* __restrict__ scales, const float* __restrict__ oris,
                  const int* __restrict__ count_ptr,
                  const float* __restrict__ w2d, const float* __restrict__ wsp,
                  float* __restrict__ out) {
  __shared__ DescShared sh;
  const int k = blockIdx.x;
  if (k >= *count_ptr) {
    out[(size_t)k * 128 + threadIdx.x] = 0.0f;
    return;
  }
  const Origin o = make_origin<kDescP>(xs[k], ys[k], Hp, Wp);
  const GlobalPatch<kDescP> pt{atlas, H, W, o.x0, o.y0a};
  descriptor(pt, o.fx, o.fy, scales[k], oris[k], w2d, wsp, sh,
             out + (size_t)k * 128);
}

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
    const void* w2d, const void* wsp, void* d1, void* ori1, void* ori2,
    void* dup, void* stream) {
  if (K <= 0 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  fused_kernel<<<K, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)atlas, H, W, Hp, Wp, (const float*)x, (const float*)y,
      (const float*)scale, (const int*)count, (const float*)w2d,
      (const float*)wsp, (float*)d1, (float*)ori1, (float*)ori2,
      (uint8_t*)dup);
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
                                     const void* wsp, void* out, void* stream) {
  if (K <= 0 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  descriptor_kernel<<<K, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)atlas, H, W, Hp, Wp, (const float*)x, (const float*)y,
      (const float*)scale, (const float*)ori, (const int*)count,
      (const float*)w2d, (const float*)wsp, (float*)out);
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
