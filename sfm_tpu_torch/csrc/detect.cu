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
//
// Up to 13 planes (num_scales <= 10) the plane count is a template
// parameter and the taps ride in the by-value table.  Past that one
// route takes any plane count the card's shared memory holds
// (detect_kernel_dyn: 111 planes at the H100's 227 KB): the same walk
// and arithmetic with the plane count a run-time value, the column sums
// and the 3-row DoG ring of every plane in dynamic shared memory (the
// thread's own column read back from the ring), the taps read from a
// buffer on the card.
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
constexpr int kMaxPlanes = 13;             // templated route: num_scales <= 10

struct Octave {
  const float* base;
  float* out;             // resp [H, W], then aux [NQ, H, W]
  int H, W, strips_x, block0;
  float gate;             // gated mode: exp2((s - 1 + pds) / S) >= gate
};

// The table both routes share.
struct Octaves {
  Octave oct[kMaxOctaves];
  int n_oct;
  int rows;               // output rows per strip
  float thresh, edge_limit;
  float inv_s;            // float32(1 / S), S = planes - 3
};

struct Params : Octaves {
  float taps[kMaxOctaves][kMaxPlanes * kTaps];
};
static_assert(sizeof(Params) <= 4096, "kernel parameters exceed 4 KB");

struct DynParams : Octaves {
  const float* taps;      // [n_oct, planes, 9] on the card
  int planes;
};

// Dynamic shared memory of detect_kernel_dyn: taps [P][12], column sums
// [P][kThreads], DoG ring [3][P - 1][kThreads].
constexpr size_t dyn_smem_bytes(int P) {
  return sizeof(float) * ((size_t)P * 12 + (size_t)P * kThreads +
                          3 * (size_t)(P - 1) * kThreads);
}

__device__ __forceinline__ int octave_of(const Octaves& prm) {
  int o = 0;
  while (o + 1 < prm.n_oct && (int)blockIdx.x >= prm.oct[o + 1].block0) ++o;
  return o;
}

__device__ __forceinline__ float guard(float v) {
  return fabsf(v) < 1e-20f ? 1e-20f : v;
}

// torch.clamp(v, -1, 1), NaN passing through.
__device__ __forceinline__ float clamp1(float v) {
  return v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
}

// The DoG values around a candidate at scale s, row c, column x.  The
// cross terms are each taken as 0.25 (((a[0] + a[1]) - a[2]) - a[3]):
// xy = (c+1, x+1), (c-1, x-1), (c-1, x+1), (c+1, x-1) on plane s;
// xs = (s+1, x+1), (s-1, x-1), (s-1, x+1), (s+1, x-1) on row c;
// ys = (s+1, c+1), (s-1, c-1), (s+1, c-1), (s-1, c+1) at column x.
struct Nbhd {
  float val, xm, xp, ym, yp, sm, sp;
  float xy[4], xs[4], ys[4];
};

__device__ __forceinline__ float cross(const float (&a)[4]) {
  return __fmul_rn(0.25f, __fsub_rn(__fsub_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]));
}

// A scale s that passed the 26-neighbour test: the mode's gates and, if
// it is the strongest so far (strictly: the first maximum over scales
// wins), its maps into sel.
template <bool Lean, int NQ>
__device__ __forceinline__ void take_scale(const Nbhd& q, int s, float edge_limit,
                                           float inv_s, float gate, float& best,
                                           float (&sel)[NQ]) {
  const float val = q.val;
  const float v2 = __fmul_rn(2.0f, val);
  const float dxx = __fsub_rn(__fsub_rn(v2, q.xm), q.xp);
  const float dyy = __fsub_rn(__fsub_rn(v2, q.ym), q.yp);
  const float dss = __fsub_rn(__fsub_rn(v2, q.sm), q.sp);
  const float dxy = cross(q.xy);
  const float dxs = cross(q.xs);
  const float dys = cross(q.ys);
  const float ddx = __fmul_rn(0.5f, __fsub_rn(q.xp, q.xm));
  const float ddy = __fmul_rn(0.5f, __fsub_rn(q.yp, q.ym));
  const float dds = __fmul_rn(0.5f, __fsub_rn(q.sm, q.sp));
  const float tra = __fadd_rn(dxx, dyy);
  const float det = __fsub_rn(__fmul_rn(dxx, dyy), __fmul_rn(dxy, dxy));
  const float t2 = __fmul_rn(tra, tra);
  if constexpr (Lean) {
    if (!(det > 0.0f && t2 > 0.0f && t2 < __fmul_rn(edge_limit, det))) return;
    const float resp = fabsf(val);
    if (resp > best) {
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
          exp2f(__fmul_rn(__fadd_rn((float)(s - 1), pds), inv_s)) >= gate))
      return;
    const float resp = fabsf(val);
    if (resp > best) {
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

template <int P, bool Lean>
__global__ void __launch_bounds__(kThreads)
detect_kernel(const __grid_constant__ Params prm) {
  constexpr int D = P - 1;                 // DoG planes
  constexpr int NQ = Lean ? 11 : 6;        // aux maps
  __shared__ __align__(16) float tp[P][12];
  __shared__ float cs[P][kThreads];
  __shared__ float ring[3][D][kThreads];

  const int o = octave_of(prm);
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
        const Nbhd q = {val, lv[1][s], rv[1][s], d0[s], d2[s], d1[s - 1], d1[s + 1],
                        {rv[2][s], lv[0][s], rv[0][s], lv[2][s]},
                        {rv[1][s + 1], lv[1][s - 1], rv[1][s - 1], lv[1][s + 1]},
                        {d2[s + 1], d0[s - 1], d0[s + 1], d2[s - 1]}};
        take_scale<Lean, NQ>(q, s, edge_limit, prm.inv_s, oc.gate, best, sel);
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

// detect_kernel with the plane count P a run-time value: the same walk,
// tests and arithmetic, the per-plane state in dynamic shared memory.
template <bool Lean>
__global__ void __launch_bounds__(kThreads)
detect_kernel_dyn(const __grid_constant__ DynParams prm) {
  constexpr int NQ = Lean ? 11 : 6;        // aux maps
  const int P = prm.planes, D = P - 1;
  extern __shared__ __align__(16) float dyn[];
  float* tp = dyn;                         // [P][12]
  float* cs = tp + P * 12;                 // [P][kThreads]
  float* ring = cs + P * kThreads;         // [3][D][kThreads]

  const int o = octave_of(prm);
  const Octave& oc = prm.oct[o];
  const int H = oc.H, W = oc.W;
  const int blk = blockIdx.x - oc.block0;
  const int x0 = (blk % oc.strips_x) * kOut;
  const int y0 = (blk / oc.strips_x) * prm.rows;
  const int y_end = min(y0 + prm.rows, H);   // output rows [y0, y_end)
  const int tid = threadIdx.x;
  for (int i = tid; i < P * 12; i += kThreads) {
    const int p = i / 12, k = i % 12;
    tp[i] = k < kTaps ? prm.taps[((size_t)o * P + p) * kTaps + k] : 0.0f;
  }

  const int gx = x0 - kHalo + tid;
  const float* col = oc.base + min(max(gx, 0), W - 1);
  auto load = [&](int y) {
    return __ldg(col + (size_t)min(max(y, 0), H - 1) * W);
  };
  float w[kTaps];
#pragma unroll
  for (int k = 0; k < kTaps; ++k) w[k] = load(y0 - 1 - kR + k);
  float next = load(y0 + kR);
  const bool row_pass = tid >= kR && tid < kThreads - kR;
  const bool nms = tid >= kHalo && tid < kHalo + kOut && gx < W;
  const float thresh = prm.thresh, edge_limit = prm.edge_limit;
  __syncthreads();

  auto taps_of = [&](int p, float (&t)[kTaps]) {
    const float4 ta = *reinterpret_cast<const float4*>(&tp[p * 12]);
    const float4 tb = *reinterpret_cast<const float4*>(&tp[p * 12 + 4]);
    t[0] = ta.x; t[1] = ta.y; t[2] = ta.z; t[3] = ta.w;
    t[4] = tb.x; t[5] = tb.y; t[6] = tb.z; t[7] = tb.w;
    t[8] = tp[p * 12 + 8];
  };
  int slot = 0;   // ring slot of DoG row r
  for (int r = y0 - 1; r <= y_end; ++r) {
    for (int p = 0; p < P; ++p) {
      float t[kTaps];
      taps_of(p, t);
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) acc = __fadd_rn(acc, __fmul_rn(t[k], w[k]));
      cs[p * kThreads + tid] = acc;
    }
#pragma unroll
    for (int k = 0; k < kTaps - 1; ++k) w[k] = w[k + 1];
    w[kTaps - 1] = next;
    next = load(r + kR + 2);
    __syncthreads();

    if (row_pass) {
      float prev = 0.0f;
      for (int p = 0; p < P; ++p) {
        float t[kTaps];
        taps_of(p, t);
        const float* row = cs + p * kThreads + tid - kR;
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < kTaps; ++k) acc = __fadd_rn(acc, __fmul_rn(t[k], row[k]));
        if (p > 0) ring[(slot * D + p - 1) * kThreads + tid] = __fsub_rn(acc, prev);
        prev = acc;
      }
    }
    __syncthreads();

    const int c = r - 1;
    if (nms && c >= y0) {
      const int s_up = slot, s_mid = slot == 0 ? 2 : slot - 1,
                s_lo = slot == 2 ? 0 : slot + 1;   // rows c + 1, c, c - 1
      // Plane d of rows c - 1, c, c + 1 at column x: lo[d * kThreads].
      const float* lo = ring + s_lo * D * kThreads + tid;
      const float* mid = ring + s_mid * D * kThreads + tid;
      const float* up = ring + s_up * D * kThreads + tid;
      // The max / min of plane d's 3 x 3 ring around the centre, without
      // (e) and with (f) the centre itself, in detect_kernel's order.
      struct Ext { float emx, emn, fmx, fmn; };
      auto ext = [&](int d) {
        const int i = d * kThreads;
        const float l0 = lo[i - 1], l1 = mid[i - 1], l2 = up[i - 1];
        const float r0 = lo[i + 1], r1 = mid[i + 1], r2 = up[i + 1];
        const float a = fmaxf(fmaxf(fmaxf(l0, l1), fmaxf(l2, r0)),
                              fmaxf(fmaxf(r1, r2), fmaxf(lo[i], up[i])));
        const float b = fminf(fminf(fminf(l0, l1), fminf(l2, r0)),
                              fminf(fminf(r1, r2), fminf(lo[i], up[i])));
        return Ext{a, b, fmaxf(a, mid[i]), fminf(b, mid[i])};
      };
      const bool inb = c >= 1 && c <= H - 2 && gx >= 1 && gx <= W - 2;
      float best = -1.0f;
      float sel[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) sel[q] = 0.0f;
      Ext e_lo = ext(0), e_mid = ext(1);   // planes s - 1 and s
      for (int s = 1; s <= P - 3; ++s) {
        const Ext e_up = ext(s + 1);
        const int i = s * kThreads, im = i - kThreads, ip = i + kThreads;
        const float val = mid[i];
        const float mx = fmaxf(fmaxf(e_lo.fmx, e_up.fmx), e_mid.emx);
        const float mn = fminf(fminf(e_lo.fmn, e_up.fmn), e_mid.emn);
        if (inb && ((val > fmaxf(thresh, mx)) || (val < fminf(-thresh, mn)))) {
          const Nbhd q = {val, mid[i - 1], mid[i + 1], lo[i], up[i], mid[im], mid[ip],
                          {up[i + 1], lo[i - 1], lo[i + 1], up[i - 1]},
                          {mid[ip + 1], mid[im - 1], mid[im + 1], mid[ip - 1]},
                          {up[ip], lo[im], lo[ip], up[im]}};
          take_scale<Lean, NQ>(q, s, edge_limit, prm.inv_s, oc.gate, best, sel);
        }
        e_lo = e_mid;
        e_mid = e_up;
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
cudaError_t launch_dyn(const DynParams& prm, int blocks, cudaStream_t st) {
  const size_t smem = dyn_smem_bytes(prm.planes);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        detect_kernel_dyn<Lean>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  detect_kernel_dyn<Lean><<<blocks, kThreads, smem, st>>>(prm);
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

// The octave table both routes share; returns the grid's block count.
int fill_octaves(Octaves& prm, int n_oct, const uint64_t* bases,
                 const uint64_t* outs, const int* hs, const int* ws,
                 const float* gates, int n_planes, int sm_count, float thresh,
                 float edge_limit) {
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
  }
  prm.n_oct = n_oct;
  prm.rows = rows;
  prm.thresh = thresh;
  prm.edge_limit = edge_limit;
  prm.inv_s = (float)(1.0 / (n_planes - 3));
  return blocks;
}

}  // namespace

// The most planes detect_kernel_dyn takes on the current card: its
// dynamic shared memory within the card's per-block limit (opt-in).
extern "C" int sfm_detect_max_planes(int* planes) {
  int dev = 0, smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  int p = kMinPlanes - 1;
  while (dyn_smem_bytes(p + 1) <= (size_t)smem) ++p;
  *planes = p;
  return 0;
}

// n_oct octaves in one launch.  bases/outs: host arrays of device
// pointers (base [H, W] and out [1 + C, H, W] f32: resp, then the C =
// 11 (lean) or 6 (gated) aux maps); hs, ws: host int arrays; gates a
// HOST array [n_oct].  Up to 13 planes, taps is a HOST array [n_oct,
// n_planes, 9] copied into the launch arguments; past that, dev_taps
// is the same array on the card.
extern "C" int sfm_detect_maps(int n_oct, const uint64_t* bases,
                               const uint64_t* outs, const int* hs,
                               const int* ws, const float* taps,
                               const float* dev_taps, const float* gates,
                               int n_planes, int lean, int sm_count,
                               float thresh, float edge_limit, void* stream) {
  const bool by_value = n_planes <= kMaxPlanes;
  if (n_oct < 1 || n_oct > kMaxOctaves || n_planes < kMinPlanes ||
      sm_count < 1 || (by_value ? taps == nullptr : dev_taps == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int o = 0; o < n_oct; ++o)
    if (hs[o] < 1 || ws[o] < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!by_value) {
    DynParams prm;
    memset(&prm, 0, sizeof(prm));
    const int blocks = fill_octaves(prm, n_oct, bases, outs, hs, ws, gates,
                                    n_planes, sm_count, thresh, edge_limit);
    prm.taps = dev_taps;
    prm.planes = n_planes;
    return (int)(lean ? launch_dyn<true>(prm, blocks, st)
                      : launch_dyn<false>(prm, blocks, st));
  }
  Params prm;
  memset(&prm, 0, sizeof(prm));
  const int blocks = fill_octaves(prm, n_oct, bases, outs, hs, ws, gates,
                                  n_planes, sm_count, thresh, edge_limit);
  for (int o = 0; o < n_oct; ++o)
    for (int e = 0; e < n_planes * kTaps; ++e)
      prm.taps[o][e] = taps[o * n_planes * kTaps + e];
  return (int)(lean ? launch_planes<true>(n_planes, prm, blocks, st)
                    : launch_planes<false>(n_planes, prm, blocks, st));
}
