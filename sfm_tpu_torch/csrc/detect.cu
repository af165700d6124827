// K3: fused blur bank + DoG + 26-neighbour NMS + lean refinement
// coefficients for one octave base.
//
// Replaces sfm_tpu/ops/pallas_detect.py:259 detect_maps (lean kernel).
// See sfm_tpu_torch/ops/detect.py for the contract and the design note.
//
// One 32 x 16 thread block per 32-wide, 16-high output tile.  Shared
// memory holds the edge-clamped slab (tile + 1-pixel halo + radius 4),
// one column-blurred plane, two blurred planes (previous, current) and
// a ring of 3 DoG planes over the tile + halo.  Scale s is tested as
// soon as DoG plane s+1 exists.  Every arithmetic step uses the _rn
// intrinsics so nothing is contracted into an FMA: the plain PyTorch
// version evaluates the same roundings in the same order.
#include <cuda_runtime.h>

namespace {

constexpr int kR = 4;                  // blur radius
constexpr int kTaps = 2 * kR + 1;
constexpr int kTW = 32;                // tile width
constexpr int kTH = 16;                // tile height
constexpr int kHX = kTW + 2;           // tile + NMS halo
constexpr int kHY = kTH + 2;
constexpr int kSW = kHX + 2 * kR;      // slab
constexpr int kSH = kHY + 2 * kR;
constexpr int kMaxPlanes = 16;
constexpr int kThreads = kTW * kTH;

__global__ void __launch_bounds__(kThreads)
detect_kernel(const float* __restrict__ base, const float* __restrict__ taps,
              int n_planes, int H, int W, float thresh, float edge_limit,
              float* __restrict__ resp, float* __restrict__ aux) {
  __shared__ float slab[kSH][kSW];
  __shared__ float colb[kHY][kSW];
  __shared__ float blur[2][kHY][kHX];
  __shared__ float dog[3][kHY][kHX];
  __shared__ float tp[kMaxPlanes * kTaps];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTW + tx;
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kTH;

  for (int e = tid; e < n_planes * kTaps; e += kThreads) tp[e] = taps[e];
  for (int e = tid; e < kSH * kSW; e += kThreads) {
    const int r = e / kSW, c = e % kSW;
    const int gy = min(max(y0 - 1 - kR + r, 0), H - 1);
    const int gx = min(max(x0 - 1 - kR + c, 0), W - 1);
    slab[r][c] = base[(size_t)gy * W + gx];
  }
  __syncthreads();

  const int gx = x0 + tx;
  const int gy = y0 + ty;
  const bool inb = gy >= 1 && gy <= H - 2 && gx >= 1 && gx <= W - 2;
  const int cy = ty + 1, cx = tx + 1;
  float best = -1.0f;
  float sel[11];
#pragma unroll
  for (int q = 0; q < 11; ++q) sel[q] = 0.0f;

  for (int p = 0; p < n_planes; ++p) {
    const float* t = &tp[p * kTaps];
    for (int e = tid; e < kHY * kSW; e += kThreads) {
      const int r = e / kSW, c = e % kSW;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k)
        acc = __fadd_rn(acc, __fmul_rn(t[k], slab[r + k][c]));
      colb[r][c] = acc;
    }
    __syncthreads();
    const int cur = p & 1;
    for (int e = tid; e < kHY * kHX; e += kThreads) {
      const int r = e / kHX, c = e % kHX;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k)
        acc = __fadd_rn(acc, __fmul_rn(t[k], colb[r][c + k]));
      blur[cur][r][c] = acc;
      if (p >= 1) dog[(p - 1) % 3][r][c] = __fsub_rn(acc, blur[cur ^ 1][r][c]);
    }
    __syncthreads();
    if (p < 3) continue;

    const int s = p - 2;  // centre DoG plane, 1..n_planes-3
    const float(*L)[kHX] = dog[(s - 1) % 3];
    const float(*C)[kHX] = dog[s % 3];
    const float(*U)[kHX] = dog[(s + 1) % 3];
    const float val = C[cy][cx];
    float mx = -3.4e38f, mn = 3.4e38f;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const float a = L[cy + dy][cx + dx];
        const float b = U[cy + dy][cx + dx];
        mx = fmaxf(mx, fmaxf(a, b));
        mn = fminf(mn, fminf(a, b));
        if (dy != 0 || dx != 0) {
          const float c = C[cy + dy][cx + dx];
          mx = fmaxf(mx, c);
          mn = fminf(mn, c);
        }
      }
    }
    bool cand = (val > fmaxf(thresh, mx)) || (val < fminf(-thresh, mn));
    cand = cand && inb;

    const float xm = C[cy][cx - 1], xp = C[cy][cx + 1];
    const float ym = C[cy - 1][cx], yp = C[cy + 1][cx];
    const float sm = L[cy][cx], sp = U[cy][cx];
    const float v2 = __fmul_rn(2.0f, val);
    const float dxx = __fsub_rn(__fsub_rn(v2, xm), xp);
    const float dyy = __fsub_rn(__fsub_rn(v2, ym), yp);
    const float dss = __fsub_rn(__fsub_rn(v2, sm), sp);
    const float dxy = __fmul_rn(0.25f, __fsub_rn(__fsub_rn(
        __fadd_rn(C[cy + 1][cx + 1], C[cy - 1][cx - 1]), C[cy - 1][cx + 1]),
        C[cy + 1][cx - 1]));
    const float dxs = __fmul_rn(0.25f, __fsub_rn(__fsub_rn(
        __fadd_rn(U[cy][cx + 1], L[cy][cx - 1]), L[cy][cx + 1]), U[cy][cx - 1]));
    const float dys = __fmul_rn(0.25f, __fsub_rn(__fsub_rn(
        __fadd_rn(U[cy + 1][cx], L[cy - 1][cx]), U[cy - 1][cx]), L[cy + 1][cx]));
    const float ddx = __fmul_rn(0.5f, __fsub_rn(xp, xm));
    const float ddy = __fmul_rn(0.5f, __fsub_rn(yp, ym));
    const float dds = __fmul_rn(0.5f, __fsub_rn(sm, sp));
    const float tra = __fadd_rn(dxx, dyy);
    const float det = __fsub_rn(__fmul_rn(dxx, dyy), __fmul_rn(dxy, dxy));
    const float t2 = __fmul_rn(tra, tra);
    cand = cand && det > 0.0f && t2 > 0.0f && t2 < __fmul_rn(edge_limit, det);
    const float r = cand ? fabsf(val) : -1.0f;
    if (r > best) {  // strict: the first maximum over scales wins
      best = r;
      sel[0] = (float)(s - 1);
      sel[1] = val;
      sel[2] = ddx;
      sel[3] = ddy;
      sel[4] = dds;
      sel[5] = dxx;
      sel[6] = dyy;
      sel[7] = dss;
      sel[8] = dxy;
      sel[9] = dxs;
      sel[10] = dys;
    }
  }

  if (gy < H && gx < W) {
    const size_t o = (size_t)gy * W + gx;
    const size_t plane = (size_t)H * W;
    resp[o] = best;
#pragma unroll
    for (int q = 0; q < 11; ++q) aux[q * plane + o] = sel[q];
  }
}

}  // namespace

extern "C" int sfm_detect_maps(const void* base, const void* taps,
                               int n_planes, int H, int W, float thresh,
                               float edge_limit, void* resp, void* aux,
                               void* stream) {
  if (n_planes < 3 || n_planes > kMaxPlanes || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  dim3 block(kTW, kTH);
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH);
  detect_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)base, (const float*)taps, n_planes, H, W, thresh,
      edge_limit, (float*)resp, (float*)aux);
  return (int)cudaGetLastError();
}
