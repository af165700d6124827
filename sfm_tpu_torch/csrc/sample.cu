// K4 (fused orientation + descriptor) and K5 (descriptor only):
// per-keypoint sampling from the octave atlas.
//
// Replaces sfm_tpu/ops/pallas_sample.py:788 fused_orient_descriptor
// (as run under the duplicate split, phases=4) and :414
// descriptor_sample.  See sfm_tpu_torch/ops/sample.py for the contract
// and the design note.
//
// One 128-thread block per keypoint.  Bilinear samples are gathered
// from the atlas in device memory through the read-only cache; the
// histogram, peaks and descriptor bins are reduced in shared memory in
// a fixed order (no atomics).  Every rounding step uses the _rn
// intrinsics in the order the plain PyTorch version evaluates it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 40;        // patch columns
constexpr int kRows = 48;     // patch rows
constexpr int kThreads = 128;
constexpr int kBins = 32;
constexpr double kPi = 3.141592653589793;
constexpr float kRad = (float)(2.0 * kPi / 360.0);
constexpr float k16Pi = (float)(16.0 / kPi);
constexpr float k4Pi = (float)(4.0 / kPi);

struct Origin {
  int x0, y0a;
  float fx, fy;
};

// Patch origin of the TPU kernels: x0 = clip(floor(x) - 19, 0, Wp - 40),
// rows from the 8-aligned y0a; (fx, fy) are patch-relative.
__device__ Origin make_origin(float x, float y, int Hp, int Wp) {
  Origin o;
  int x0 = (int)floorf(x) - kP / 2 + 1;
  x0 = min(max(x0, 0), max(Wp - kP, 0));
  int y0 = (int)floorf(y) - kP / 2 + 1;
  y0 = min(max(y0, 0), max(Hp - kP, 0));
  o.x0 = x0;
  o.fx = __fsub_rn(x, (float)x0);
  o.y0a = max(min((y0 / 8) * 8, Hp - kRows), 0);
  o.fy = __fadd_rn(__fsub_rn(y, (float)y0), (float)(y0 - o.y0a));
  return o;
}

// Bilinear sample at patch-relative (px, py), clamped to the patch and
// to the atlas (whose edge the TPU kernels' padding replicates).
__device__ __forceinline__ float sample(const float* __restrict__ atlas, int H,
                                        int W, const Origin& o, float px,
                                        float py) {
  px = fminf(fmaxf(px, 0.0f), (float)(kP - 1));
  py = fminf(fmaxf(py, 0.0f), (float)(kRows - 1));
  const float ixf = floorf(px), iyf = floorf(py);
  const float fxw = __fsub_rn(px, ixf), fyw = __fsub_rn(py, iyf);
  const int ix = (int)ixf, iy = (int)iyf;
  const int gx0 = min(max(o.x0 + ix, 0), W - 1);
  const int gx1 = min(max(o.x0 + min(ix + 1, kP - 1), 0), W - 1);
  const int gy0 = min(max(o.y0a + iy, 0), H - 1);
  const int gy1 = min(max(o.y0a + min(iy + 1, kRows - 1), 0), H - 1);
  const float a00 = __ldg(&atlas[(size_t)gy0 * W + gx0]);
  const float a01 = __ldg(&atlas[(size_t)gy0 * W + gx1]);
  const float a10 = __ldg(&atlas[(size_t)gy1 * W + gx0]);
  const float a11 = __ldg(&atlas[(size_t)gy1 * W + gx1]);
  const float ux = __fsub_rn(1.0f, fxw), uy = __fsub_rn(1.0f, fyw);
  const float lft = __fadd_rn(__fmul_rn(uy, a00), __fmul_rn(fyw, a10));
  const float rgt = __fadd_rn(__fmul_rn(uy, a01), __fmul_rn(fyw, a11));
  return __fadd_rn(__fmul_rn(ux, lft), __fmul_rn(fxw, rgt));
}

struct DescShared {
  float grad[256];
  float angf[256];
  int angi[256];
};

// Raw 128-D descriptor (16 x 16 rotated samples, 4 x 4 cells x 8 bins,
// trilinear) of one keypoint, written to out[0..127].  Called by all
// 128 threads of the block.
__device__ void descriptor(const float* __restrict__ atlas, int H, int W,
                           const Origin& o, float scale, float ori,
                           const float* __restrict__ w2d,
                           const float* __restrict__ wsp, DescShared& sh,
                           float* __restrict__ out) {
  const int tid = threadIdx.x;
  const float theta = __fmul_rn(ori, kRad);
  const float ca = cosf(theta), sa = sinf(theta);
  const float sc = __fmul_rn(0.75f, scale);
  for (int s = tid; s < 256; s += kThreads) {
    const float i_f = (float)(s % 16) - 7.5f;
    const float j_f = (float)(s / 16) - 7.5f;
    const float bx = __fadd_rn(o.fx, __fmul_rn(sc, __fsub_rn(__fmul_rn(i_f, ca),
                                                             __fmul_rn(j_f, sa))));
    const float by = __fadd_rn(o.fy, __fmul_rn(sc, __fadd_rn(__fmul_rn(i_f, sa),
                                                             __fmul_rn(j_f, ca))));
    const float v0 = sample(atlas, H, W, o, __fadd_rn(bx, ca), __fadd_rn(by, sa));
    const float v1 = sample(atlas, H, W, o, __fadd_rn(bx, -ca), __fadd_rn(by, -sa));
    const float v2 = sample(atlas, H, W, o, __fadd_rn(bx, -sa), __fadd_rn(by, ca));
    const float v3 = sample(atlas, H, W, o, __fadd_rn(bx, sa), __fadd_rn(by, -ca));
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

__global__ void __launch_bounds__(kThreads)
fused_kernel(const float* __restrict__ atlas, int H, int W, int Hp, int Wp,
             const float* __restrict__ xs, const float* __restrict__ ys,
             const float* __restrict__ scales, const int* __restrict__ count_ptr,
             const float* __restrict__ w2d, const float* __restrict__ wsp,
             float* __restrict__ d1, float* __restrict__ ori1,
             float* __restrict__ ori2, uint8_t* __restrict__ dup) {
  __shared__ float s_gw[121];
  __shared__ int s_bin[121];
  __shared__ float s_h[kBins];
  __shared__ float s_hs[kBins];
  __shared__ float s_ori;
  __shared__ DescShared sh;
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  if (k >= *count_ptr) {  // block-uniform: the whole block leaves together
    d1[(size_t)k * 128 + tid] = 0.0f;
    if (tid == 0) {
      ori1[k] = 0.0f;
      ori2[k] = 0.0f;
      dup[k] = 0;
    }
    return;
  }
  const float scale = scales[k];
  const Origin o = make_origin(xs[k], ys[k], Hp, Wp);

  // 11 x 11 gradient samples around the keypoint.
  if (tid < 121) {
    const float xd = (float)(tid % 11) - 5.0f;
    const float yd = (float)(tid / 11) - 5.0f;
    const float bxo = __fadd_rn(o.fx, xd), byo = __fadd_rn(o.fy, yd);
    const float v0 = sample(atlas, H, W, o, __fadd_rn(bxo, 1.0f), byo);
    const float v1 = sample(atlas, H, W, o, __fadd_rn(bxo, -1.0f), byo);
    const float v2 = sample(atlas, H, W, o, bxo, __fadd_rn(byo, 1.0f));
    const float v3 = sample(atlas, H, W, o, bxo, __fadd_rn(byo, -1.0f));
    const float dx = __fsub_rn(v0, v1), dy = __fsub_rn(v2, v3);
    const float grad = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    const float s15 = __fmul_rn(1.5f, scale);
    const float inv2s2 = __fdiv_rn(-1.0f, __fmul_rn(2.0f, __fmul_rn(s15, s15)));
    const float w = expf(__fmul_rn(inv2s2, xd * xd + yd * yd));
    float b = floorf(__fadd_rn(__fmul_rn(k16Pi, atan2f(dy, dx)), 16.5f));
    if (b > 31.0f) b = 0.0f;
    s_gw[tid] = __fmul_rn(grad, w);
    s_bin[tid] = (int)b;
  }
  __syncthreads();
  if (tid < kBins) {  // each thread sums its own bin, in sample order
    float acc = 0.0f;
    for (int s = 0; s < 121; ++s)
      if (s_bin[s] == tid) acc = __fadd_rn(acc, s_gw[s]);
    s_h[tid] = acc;
  }
  __syncthreads();
  if (tid < kBins) {  // circular [1, 4, 6, 4, 1] smoothing
    const int i = tid;
    const float c = __fmul_rn(6.0f, s_h[i]);
    const float n1 = __fmul_rn(4.0f, __fadd_rn(s_h[(i + kBins - 1) % kBins],
                                               s_h[(i + 1) % kBins]));
    s_hs[i] = __fadd_rn(__fadd_rn(__fadd_rn(c, n1), s_h[(i + kBins - 2) % kBins]),
                        s_h[(i + 2) % kBins]);
  }
  __syncthreads();
  if (tid == 0) {
    float pv[kBins];
    float m1 = -1.0f;
    for (int i = 0; i < kBins; ++i) {
      const float h = s_hs[i];
      const bool peak = h > s_hs[(i + kBins - 1) % kBins] && h >= s_hs[(i + 1) % kBins];
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
    const float o1 = m1 > 0.0f ? peak_angle(s_hs, i1) : 0.0f;
    const float o2 = m2 > 0.0f ? peak_angle(s_hs, i2) : 0.0f;
    ori1[k] = o1;
    ori2[k] = o2;
    dup[k] = (m2 > __fmul_rn(0.8f, m1) && m2 > 0.0f) ? 1 : 0;
    s_ori = o1;
  }
  __syncthreads();
  descriptor(atlas, H, W, o, scale, s_ori, w2d, wsp, sh, d1 + (size_t)k * 128);
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
  const Origin o = make_origin(xs[k], ys[k], Hp, Wp);
  descriptor(atlas, H, W, o, scales[k], oris[k], w2d, wsp, sh,
             out + (size_t)k * 128);
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
