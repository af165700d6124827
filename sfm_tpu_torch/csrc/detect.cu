// K3: fused blur bank + DoG + 26-neighbour NMS + refinement, for up to
// 8 octave bases of an image in one launch.
//
// Replaces sfm_tpu/ops/pallas_detect.py:259 detect_maps, both modes:
// lean (11 raw refinement coefficients; the solve runs after top-k) and
// gated (_make_kernel's non-lean body: the quadratic solve at every
// candidate, the edge-ratio and scale gates, 6 maps).  See
// sfm_tpu_torch/ops/detect.py for the contract and the design note.
//
// What bounds it: device memory at the large octaves (one f32 read of
// the base and 12 f32 maps written per pixel in the lean mode, 7 in the
// gated one: 52 / 32 B/px), launch latency and a thin grid at the small
// ones, and on the way the ~300 blur multiply-adds per pixel with their
// operand traffic.
//
// Design.  One launch covers up to 8 octaves: the grid is flat, and a
// block finds its octave (base, outputs, H, W, first block, scale gate)
// and that octave's taps in a by-value parameter table.  A 128-thread
// block owns a strip of 118 output columns and `rows` output rows;
// thread t owns slab column x0 - 5 + t and walks down the strip one row
// per step:
//   - the 9-row vertical window of its base column lives in registers
//     (one new load per row, prefetched a row ahead) and serves all
//     planes, since only the taps differ;
//   - it writes its column sum of each plane to one shared row per
//     plane; after one barrier, threads 4..123 take their row pass from
//     the 9 neighbouring column sums and form the DoG row of each plane;
//   - the 3 latest DoG rows of each plane stay in registers for the
//     thread's own column, and a 3-row shared ring gives the x +- 1
//     neighbours; after a second barrier, threads 5..122 run the
//     26-neighbour test and, where it passes, the mode's gates and maps
//     for the row above.
// Two barriers per row, not two per plane; nothing but the maps reaches
// device memory.  Every arithmetic step uses the _rn intrinsics, in the
// plain PyTorch version's order (column pass, then row pass, taps in
// order; refine_from_coeffs for the gated mode), and exp2f as
// torch.exp2, so the two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kR = 4;                      // blur radius
constexpr int kTaps = 2 * kR + 1;
constexpr int kThreads = 128;
constexpr int kHalo = kR + 1;              // blur radius + NMS ring
constexpr int kOut = kThreads - 2 * kHalo; // output columns per strip
constexpr int kMaxOctaves = 8;
constexpr int kMinPlanes = 4;
constexpr int kMaxPlanes = 13;             // num_scales <= 10

struct Octave {
  const float* base;
  float* out;             // resp [H, W], then aux [NQ, H, W]
  int H, W, strips_x, block0;
  float gate;             // gated mode: exp2((s - 1 + pds) / S) >= gate
};

struct Params {
  Octave oct[kMaxOctaves];
  float taps[kMaxOctaves][kMaxPlanes * kTaps];
  int n_oct;
  int rows;               // output rows per strip
  float thresh, edge_limit;
  float inv_s;            // float32(1 / S), S = planes - 3
};
static_assert(sizeof(Params) <= 4096, "kernel parameters exceed 4 KB");

__device__ __forceinline__ float guard(float v) {
  return fabsf(v) < 1e-20f ? 1e-20f : v;
}

// torch.clamp(v, -1, 1), NaN passing through.
__device__ __forceinline__ float clamp1(float v) {
  return v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
}

template <int P, bool Lean>
__global__ void __launch_bounds__(kThreads)
detect_kernel(const __grid_constant__ Params prm) {
  constexpr int D = P - 1;                 // DoG planes
  constexpr int NQ = Lean ? 11 : 6;        // aux maps
  __shared__ __align__(16) float tp[P][12];
  __shared__ float cs[P][kThreads];
  __shared__ float ring[3][D][kThreads];

  int o = 0;
  while (o + 1 < prm.n_oct && (int)blockIdx.x >= prm.oct[o + 1].block0) ++o;
  const Octave& oc = prm.oct[o];
  const int H = oc.H, W = oc.W;
  const int blk = blockIdx.x - oc.block0;
  const int x0 = (blk % oc.strips_x) * kOut;
  const int y0 = (blk / oc.strips_x) * prm.rows;
  const int y_end = min(y0 + prm.rows, H);   // output rows [y0, y_end)
  const int tid = threadIdx.x;
  for (int i = tid; i < P * 12; i += kThreads) {
    const int p = i / 12, k = i % 12;
    tp[p][k] = k < kTaps ? prm.taps[o][p * kTaps + k] : 0.0f;
  }

  const int gx = x0 - kHalo + tid;
  const float* col = oc.base + min(max(gx, 0), W - 1);
  auto load = [&](int y) {
    return __ldg(col + (size_t)min(max(y, 0), H - 1) * W);
  };
  // DoG rows y0 - 1 .. y_end feed output rows y0 .. y_end - 1.
  float w[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) w[k] = load(y0 - 1 - kR + k);
  float next = load(y0 + kR);
  float d0[D], d1[D], d2[D];   // own column's DoG, rows r - 2, r - 1, r
#pragma unroll
  for (int d = 0; d < D; ++d) d0[d] = d1[d] = d2[d] = 0.0f;
  const bool row_pass = tid >= kR && tid < kThreads - kR;
  const bool nms = tid >= kHalo && tid < kHalo + kOut && gx < W;
  const float thresh = prm.thresh, edge_limit = prm.edge_limit;
  __syncthreads();

  int slot = 0;   // ring slot of DoG row r
  for (int r = y0 - 1; r <= y_end; ++r) {
    // Column sums of row r, one shared row per plane.
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float4 ta = *reinterpret_cast<const float4*>(&tp[p][0]);
      const float4 tb = *reinterpret_cast<const float4*>(&tp[p][4]);
      const float t8 = tp[p][8];
      const float t[kTaps] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w, t8};
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) acc = __fadd_rn(acc, __fmul_rn(t[k], w[k]));
      cs[p][tid] = acc;
    }
#pragma unroll
    for (int k = 0; k < kTaps - 1; ++k) w[k] = w[k + 1];
    w[kTaps - 1] = next;
    next = load(r + kR + 2);
    __syncthreads();

    // Row pass and DoG of row r.
    float dn[D];
#pragma unroll
    for (int d = 0; d < D; ++d) dn[d] = 0.0f;
    if (row_pass) {
      float prev = 0.0f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float4 ta = *reinterpret_cast<const float4*>(&tp[p][0]);
        const float4 tb = *reinterpret_cast<const float4*>(&tp[p][4]);
        const float t8 = tp[p][8];
        const float t[kTaps] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y, tb.z, tb.w, t8};
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < kTaps; ++k)
          acc = __fadd_rn(acc, __fmul_rn(t[k], cs[p][tid - kR + k]));
        if (p > 0) {
          dn[p - 1] = __fsub_rn(acc, prev);
          ring[slot][p - 1][tid] = dn[p - 1];
        }
        prev = acc;
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      d0[d] = d1[d];
      d1[d] = d2[d];
      d2[d] = dn[d];
    }
    __syncthreads();

    // NMS, gates and maps at row c = r - 1.
    const int c = r - 1;
    if (nms && c >= y0) {
      const int s_up = slot, s_mid = slot == 0 ? 2 : slot - 1,
                s_lo = slot == 2 ? 0 : slot + 1;   // rows c + 1, c, c - 1
      float lv[3][D], rv[3][D];   // x - 1 and x + 1, rows c - 1, c, c + 1
#pragma unroll
      for (int d = 0; d < D; ++d) {
        lv[0][d] = ring[s_lo][d][tid - 1];
        lv[1][d] = ring[s_mid][d][tid - 1];
        lv[2][d] = ring[s_up][d][tid - 1];
        rv[0][d] = ring[s_lo][d][tid + 1];
        rv[1][d] = ring[s_mid][d][tid + 1];
        rv[2][d] = ring[s_up][d][tid + 1];
      }
      // Per plane: the max / min of the 3 x 3 ring around the centre,
      // without (e) and with (f) the centre itself.
      float emx[D], emn[D], fmx[D], fmn[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float a = fmaxf(fmaxf(fmaxf(lv[0][d], lv[1][d]), fmaxf(lv[2][d], rv[0][d])),
                              fmaxf(fmaxf(rv[1][d], rv[2][d]), fmaxf(d0[d], d2[d])));
        const float b = fminf(fminf(fminf(lv[0][d], lv[1][d]), fminf(lv[2][d], rv[0][d])),
                              fminf(fminf(rv[1][d], rv[2][d]), fminf(d0[d], d2[d])));
        emx[d] = a;
        emn[d] = b;
        fmx[d] = fmaxf(a, d1[d]);
        fmn[d] = fminf(b, d1[d]);
      }
      const bool inb = c >= 1 && c <= H - 2 && gx >= 1 && gx <= W - 2;
      float best = -1.0f;
      float sel[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) sel[q] = 0.0f;
#pragma unroll
      for (int s = 1; s <= P - 3; ++s) {
        const float val = d1[s];
        const float mx = fmaxf(fmaxf(fmx[s - 1], fmx[s + 1]), emx[s]);
        const float mn = fminf(fminf(fmn[s - 1], fmn[s + 1]), emn[s]);
        if (!(inb && ((val > fmaxf(thresh, mx)) || (val < fminf(-thresh, mn)))))
          continue;
        const float xm = lv[1][s], xp = rv[1][s];
        const float ym = d0[s], yp = d2[s];
        const float sm = d1[s - 1], sp = d1[s + 1];
        const float v2 = __fmul_rn(2.0f, val);
        const float dxx = __fsub_rn(__fsub_rn(v2, xm), xp);
        const float dyy = __fsub_rn(__fsub_rn(v2, ym), yp);
        const float dss = __fsub_rn(__fsub_rn(v2, sm), sp);
        const float dxy = __fmul_rn(0.25f, __fsub_rn(__fsub_rn(
            __fadd_rn(rv[2][s], lv[0][s]), rv[0][s]), lv[2][s]));
        const float dxs = __fmul_rn(0.25f, __fsub_rn(__fsub_rn(
            __fadd_rn(rv[1][s + 1], lv[1][s - 1]), rv[1][s - 1]), lv[1][s + 1]));
        const float dys = __fmul_rn(0.25f, __fsub_rn(__fsub_rn(
            __fadd_rn(d2[s + 1], d0[s - 1]), d0[s + 1]), d2[s - 1]));
        const float ddx = __fmul_rn(0.5f, __fsub_rn(xp, xm));
        const float ddy = __fmul_rn(0.5f, __fsub_rn(yp, ym));
        const float dds = __fmul_rn(0.5f, __fsub_rn(sm, sp));
        const float tra = __fadd_rn(dxx, dyy);
        const float det = __fsub_rn(__fmul_rn(dxx, dyy), __fmul_rn(dxy, dxy));
        const float t2 = __fmul_rn(tra, tra);
        if constexpr (Lean) {
          if (!(det > 0.0f && t2 > 0.0f && t2 < __fmul_rn(edge_limit, det))) continue;
          const float resp = fabsf(val);
          if (resp > best) {   // strict: the first maximum over scales wins
            best = resp;
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
        } else {
          // refine_from_coeffs, operation for operation.
          const float edge = __fdiv_rn(t2, guard(det));
          const float idxx = __fsub_rn(__fmul_rn(dyy, dss), __fmul_rn(dys, dys));
          const float idxy = __fsub_rn(__fmul_rn(dys, dxs), __fmul_rn(dxy, dss));
          const float idxs = __fsub_rn(__fmul_rn(dxy, dys), __fmul_rn(dyy, dxs));
          const float idyy = __fsub_rn(__fmul_rn(dxx, dss), __fmul_rn(dxs, dxs));
          const float idys = __fsub_rn(__fmul_rn(dxy, dxs), __fmul_rn(dxx, dys));
          const float idss = det;
          const float hdet = __fadd_rn(__fadd_rn(__fmul_rn(idxx, dxx),
                                                 __fmul_rn(idxy, dxy)),
                                       __fmul_rn(idxs, dxs));
          const float idet = __fdiv_rn(1.0f, guard(hdet));
          float pdx = __fmul_rn(idet, __fadd_rn(__fadd_rn(
              __fmul_rn(idxx, ddx), __fmul_rn(idxy, ddy)), __fmul_rn(idxs, dds)));
          float pdy = __fmul_rn(idet, __fadd_rn(__fadd_rn(
              __fmul_rn(idxy, ddx), __fmul_rn(idyy, ddy)), __fmul_rn(idys, dds)));
          float pds = __fmul_rn(idet, __fadd_rn(__fadd_rn(
              __fmul_rn(idxs, ddx), __fmul_rn(idys, ddy)), __fmul_rn(idss, dds)));
          if (fmaxf(fmaxf(fabsf(pdx), fabsf(pdy)), fabsf(pds)) > 0.5f) {
            pdx = __fdiv_rn(ddx, guard(dxx));
            pdy = __fdiv_rn(ddy, guard(dyy));
            pds = __fdiv_rn(dds, guard(dss));
          }
          pdx = clamp1(pdx);
          pdy = clamp1(pdy);
          pds = clamp1(pds);
          if (!(edge > 0.0f && edge < edge_limit &&
                exp2f(__fmul_rn(__fadd_rn((float)(s - 1), pds), prm.inv_s)) >= oc.gate))
            continue;
          const float resp = fabsf(val);
          if (resp > best) {   // strict: the first maximum over scales wins
            best = resp;
            sel[0] = (float)(s - 1);
            sel[1] = pdx;
            sel[2] = pdy;
            sel[3] = pds;
            sel[4] = __fadd_rn(val, __fmul_rn(0.5f, __fadd_rn(__fadd_rn(
                __fmul_rn(ddx, pdx), __fmul_rn(ddy, pdy)), __fmul_rn(dds, pds))));
            sel[5] = edge;
          }
        }
      }
      const size_t off = (size_t)c * W + gx;
      const size_t plane = (size_t)H * W;
      oc.out[off] = best;
#pragma unroll
      for (int q = 0; q < NQ; ++q) oc.out[(q + 1) * plane + off] = sel[q];
    }
    slot = slot == 2 ? 0 : slot + 1;
  }
}

template <int P, bool Lean>
cudaError_t launch(const Params& prm, int blocks, cudaStream_t st) {
  detect_kernel<P, Lean><<<blocks, kThreads, 0, st>>>(prm);
  return cudaGetLastError();
}

template <bool Lean>
cudaError_t launch_planes(int n_planes, const Params& prm, int blocks,
                          cudaStream_t st) {
  switch (n_planes) {
    case 4: return launch<4, Lean>(prm, blocks, st);
    case 5: return launch<5, Lean>(prm, blocks, st);
    case 6: return launch<6, Lean>(prm, blocks, st);
    case 7: return launch<7, Lean>(prm, blocks, st);
    case 8: return launch<8, Lean>(prm, blocks, st);
    case 9: return launch<9, Lean>(prm, blocks, st);
    case 10: return launch<10, Lean>(prm, blocks, st);
    case 11: return launch<11, Lean>(prm, blocks, st);
    case 12: return launch<12, Lean>(prm, blocks, st);
    default: return launch<13, Lean>(prm, blocks, st);
  }
}

}  // namespace

// n_oct octaves in one launch.  bases/outs: host arrays of device
// pointers (base [H, W] and out [1 + C, H, W] f32: resp, then the C =
// 11 (lean) or 6 (gated) aux maps); hs, ws: host int arrays; taps: a
// HOST array [n_oct, n_planes, 9] and gates a HOST array [n_oct], both
// copied into the launch arguments.
extern "C" int sfm_detect_maps(int n_oct, const uint64_t* bases,
                               const uint64_t* outs, const int* hs,
                               const int* ws, const float* taps,
                               const float* gates, int n_planes, int lean,
                               int sm_count, float thresh, float edge_limit,
                               void* stream) {
  if (n_oct < 1 || n_oct > kMaxOctaves || n_planes < kMinPlanes ||
      n_planes > kMaxPlanes || sm_count < 1)
    return (int)cudaErrorInvalidValue;
  for (int o = 0; o < n_oct; ++o)
    if (hs[o] < 1 || ws[o] < 1) return (int)cudaErrorInvalidValue;
  Params prm;
  memset(&prm, 0, sizeof(prm));
  // Halve the strip height from 32 rows while the grid holds fewer than
  // 4 blocks per SM (the bench's 576 x 720 octaves: 8 rows).
  int rows = 32, blocks = 0;
  for (;;) {
    blocks = 0;
    for (int o = 0; o < n_oct; ++o)
      blocks += ((ws[o] + kOut - 1) / kOut) * ((hs[o] + rows - 1) / rows);
    if (blocks >= 4 * sm_count || rows == 8) break;
    rows /= 2;
  }
  int block0 = 0;
  for (int o = 0; o < n_oct; ++o) {
    Octave& oc = prm.oct[o];
    oc.base = (const float*)bases[o];
    oc.out = (float*)outs[o];
    oc.H = hs[o];
    oc.W = ws[o];
    oc.strips_x = (ws[o] + kOut - 1) / kOut;
    oc.block0 = block0;
    oc.gate = gates[o];
    block0 += oc.strips_x * ((hs[o] + rows - 1) / rows);
    for (int e = 0; e < n_planes * kTaps; ++e)
      prm.taps[o][e] = taps[o * n_planes * kTaps + e];
  }
  prm.n_oct = n_oct;
  prm.rows = rows;
  prm.thresh = thresh;
  prm.edge_limit = edge_limit;
  prm.inv_s = (float)(1.0 / (n_planes - 3));
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(lean ? launch_planes<true>(n_planes, prm, blocks, st)
                    : launch_planes<false>(n_planes, prm, blocks, st));
}
