// K1 (separable edge-clamped blur, the init_blur prefilter), K2 (blur +
// 2x decimation, one octave step) and K7 (2x bilinear upsample with the
// reference's interleave): the octave base chain.
//
// Replace sfm_tpu/ops/pallas_pyramid.py:147 blur9, :272 scale_down and
// :241 scale_up.  See sfm_tpu_torch/ops/pyramid.py for the contract and
// the design note.
//
// Each kernel reads every source pixel about once and writes every
// output pixel once (f32), so all three are bound by device memory at
// the up-scale base (1920 x 2560) and by launch latency at the small
// octaves.  Edge clamping comes from clamped slab loads.  Every
// multiply and add uses the _rn intrinsics (no FMA contraction), in the
// order the plain PyTorch versions evaluate them.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxR = 8;                 // largest tap radius taken
constexpr int kMaxTaps = 2 * kMaxR + 1;

struct Taps {
  float t[kMaxTaps];
  int n;
};

// ---- K1: blur ---------------------------------------------------------
// One 256-thread block per 32 x 32 output tile: the clamped slab (tile
// + radius on every side) goes to shared memory, the column (H) pass
// writes a [32, 32 + 2r] shared buffer, the row (W) pass the output.
constexpr int kBT = 32;                  // output tile side
constexpr int kBThreads = 256;
constexpr int kBSlab = kBT + 2 * kMaxR;  // slab side at the largest radius

__global__ void __launch_bounds__(kBThreads)
blur_kernel(const float* __restrict__ src, int H, int W, Taps taps,
            float* __restrict__ dst) {
  __shared__ float slab[kBSlab][kBSlab + 1];
  __shared__ float colb[kBT][kBSlab + 1];
  __shared__ float tp[kMaxTaps];
  const int tid = threadIdx.x;
  const int n = taps.n, r = n / 2;
  const int x0 = blockIdx.x * kBT, y0 = blockIdx.y * kBT;
  const int sw = kBT + 2 * r, sh = kBT + 2 * r;
  if (tid < n) tp[tid] = taps.t[tid];
  for (int e = tid; e < sh * sw; e += kBThreads) {
    const int rr = e / sw, cc = e % sw;
    const int gy = min(max(y0 - r + rr, 0), H - 1);
    const int gx = min(max(x0 - r + cc, 0), W - 1);
    slab[rr][cc] = src[(size_t)gy * W + gx];
  }
  __syncthreads();
  for (int e = tid; e < kBT * sw; e += kBThreads) {
    const int rr = e / sw, cc = e % sw;
    float acc = __fmul_rn(tp[0], slab[rr][cc]);
    for (int k = 1; k < n; ++k)
      acc = __fadd_rn(acc, __fmul_rn(tp[k], slab[rr + k][cc]));
    colb[rr][cc] = acc;
  }
  __syncthreads();
  for (int e = tid; e < kBT * kBT; e += kBThreads) {
    const int rr = e / kBT, cc = e % kBT;
    const int gy = y0 + rr, gx = x0 + cc;
    if (gy >= H || gx >= W) continue;
    float acc = __fmul_rn(tp[0], colb[rr][cc]);
    for (int k = 1; k < n; ++k)
      acc = __fadd_rn(acc, __fmul_rn(tp[k], colb[rr][cc + k]));
    dst[(size_t)gy * W + gx] = acc;
  }
}

// ---- K2: blur + 2x decimation ----------------------------------------
// One 256-thread block per 16-row, 32-column tile of the decimated
// output.  Output (y', x') reads source rows and columns
// 2y' + k - r, 2x' + k - r (clamped): the slab spans 2*16 + 2r - 1 rows
// and 2*32 + 2r - 1 columns.  The vertical pass computes only the even
// (kept) rows, the horizontal pass only the kept columns, so the
// full-resolution blur never exists.
constexpr int kDH = 16, kDW = 32;
constexpr int kDThreads = 256;
constexpr int kDSlabH = 2 * kDH + 2 * kMaxR - 1;
constexpr int kDSlabW = 2 * kDW + 2 * kMaxR - 1;

__global__ void __launch_bounds__(kDThreads)
decim_kernel(const float* __restrict__ src, int H, int W, Taps taps,
             float* __restrict__ dst, int Ho, int Wo) {
  __shared__ float slab[kDSlabH][kDSlabW];
  __shared__ float vert[kDH][kDSlabW];
  __shared__ float tp[kMaxTaps];
  const int tid = threadIdx.x;
  const int n = taps.n, r = n / 2;
  const int ox = blockIdx.x * kDW, oy = blockIdx.y * kDH;
  const int sh = 2 * kDH + 2 * r - 1, sw = 2 * kDW + 2 * r - 1;
  const int sy0 = 2 * oy - r, sx0 = 2 * ox - r;
  if (tid < n) tp[tid] = taps.t[tid];
  for (int e = tid; e < sh * sw; e += kDThreads) {
    const int rr = e / sw, cc = e % sw;
    const int gy = min(max(sy0 + rr, 0), H - 1);
    const int gx = min(max(sx0 + cc, 0), W - 1);
    slab[rr][cc] = src[(size_t)gy * W + gx];
  }
  __syncthreads();
  for (int e = tid; e < kDH * sw; e += kDThreads) {
    const int rr = e / sw, cc = e % sw;
    float acc = __fmul_rn(tp[0], slab[2 * rr][cc]);
    for (int k = 1; k < n; ++k)
      acc = __fadd_rn(acc, __fmul_rn(tp[k], slab[2 * rr + k][cc]));
    vert[rr][cc] = acc;
  }
  __syncthreads();
  for (int e = tid; e < kDH * kDW; e += kDThreads) {
    const int rr = e / kDW, cc = e % kDW;
    const int gy = oy + rr, gx = ox + cc;
    if (gy >= Ho || gx >= Wo) continue;
    float acc = __fmul_rn(tp[0], vert[rr][2 * cc]);
    for (int k = 1; k < n; ++k)
      acc = __fadd_rn(acc, __fmul_rn(tp[k], vert[rr][2 * cc + k]));
    dst[(size_t)gy * Wo + gx] = acc;
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

bool load_taps(const float* host_taps, int n, Taps* taps) {
  if (n < 1 || n > kMaxTaps || n % 2 == 0) return false;
  for (int k = 0; k < n; ++k) taps->t[k] = host_taps[k];
  for (int k = n; k < kMaxTaps; ++k) taps->t[k] = 0.0f;
  taps->n = n;
  return true;
}

}  // namespace

// taps: a HOST array of n floats, copied into the launch arguments.
extern "C" int sfm_blur(const void* src, int H, int W, const void* taps,
                        int n, void* dst, void* stream) {
  Taps t;
  if (H < 1 || W < 1 || !load_taps((const float*)taps, n, &t))
    return (int)cudaErrorInvalidValue;
  dim3 grid((W + kBT - 1) / kBT, (H + kBT - 1) / kBT);
  blur_kernel<<<grid, kBThreads, 0, (cudaStream_t)stream>>>(
      (const float*)src, H, W, t, (float*)dst);
  return (int)cudaGetLastError();
}

extern "C" int sfm_scale_down(const void* src, int H, int W, const void* taps,
                              int n, void* dst, void* stream) {
  Taps t;
  const int Ho = H / 2, Wo = W / 2;
  if (Ho < 1 || Wo < 1 || !load_taps((const float*)taps, n, &t))
    return (int)cudaErrorInvalidValue;
  dim3 grid((Wo + kDW - 1) / kDW, (Ho + kDH - 1) / kDH);
  decim_kernel<<<grid, kDThreads, 0, (cudaStream_t)stream>>>(
      (const float*)src, H, W, t, (float*)dst, Ho, Wo);
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
