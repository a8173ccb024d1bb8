// mg_level_q.cuh: the quarter-plane finest multigrid level on a shared-memory
// tile, shared by mg_down_q.cu, mg_up_q.cu and mg_ud_q.cu (one kernel
// template, four instantiations: the descent in its fused-restrict and its
// split form, the ascent, the fused boundary; as mg_level.cuh serves mg_down
// and mg_up).
//
// Layout. The dense (C, 2 hq, 2 wq2) level is stored as four quarter planes,
// (C, 4, hq, wq2): plane p = 2 rp + cp holds dense (2 i + rp, 2 j + cp) at
// (i, j), so EE = 0, EO = 1, OE = 2, OO = 3. Red cells are EE and OO, black
// ones EO and OE. A half-sweep updates one colour's two planes from the
// other colour's two, each point by its four neighbours:
//   EE[i,j]: ((OE[i-1,j] + OE[i,j]) + EO[i,j-1]) + EO[i,j]
//   OO[i,j]: ((EO[i,j] + EO[i+1,j]) + OE[i,j]) + OE[i,j+1]
//   EO[i,j]: ((OO[i-1,j] + OO[i,j]) + EE[i,j]) + EE[i,j+1]
//   OE[i,j]: ((EE[i,j] + EE[i+1,j]) + OO[i,j-1]) + OO[i,j]
// then u <- (ns - g) * 0.25 inside the true (h, w) domain (the finest level
// has beta = 1 on both axes: the plain 5-point operator). Outside the domain
// every plane holds exact zeros, which is the Dirichlet frame.
//
// The TPU kernels (pallas_mg_quarter.py: _sweep_q, _down_q_body, _rct_strip,
// _up_q_body) sweep full-width strips of 128 quarter rows with 8 ghost rows.
// Here a block owns a kTH x kTW tile of quarter cells of one channel and
// stages all four planes of u and of g with a kR-deep ring on every side
// (dynamic shared memory, 72 KB). A point is updated only when its four
// neighbours are staged, i.e. everywhere but the outermost DENSE layer of
// the staged region. After k half-sweeps, only the k outermost dense layers
// can differ from the global sweep (a point reads neighbours one dense layer
// further out, which were exact one half-sweep earlier). The ring is 2 kR =
// 16 dense layers deep; the deepest point the descent reads is the residual
// at OO of quarter row kTH (one past the tile, for the restriction's jc + 1),
// 2 kR - 2 = 14 layers in, so the fused ascent + descent stays exact for
// 2 (nu2 + nu1) + 1 <= 14, i.e. nu1 + nu2 <= 6: the whole fused-level gate
// (nu1 <= 2, nu2 <= 4). The correction of the ascent is pointwise (the
// split coarse corrections are read from device memory), so it adds none.
//
// Arithmetic in the plain twin's order (ops/kernels.py: _q_sweeps,
// _q_residual, _q_rct, _q_correct); the build's -fmad=false keeps each
// operation rounded on its own, so the kernels are bit-equal to the twins.

#pragma once

#include <cuda_runtime.h>

namespace mgq {

constexpr int kTH = 32;                 // owned quarter rows per block
constexpr int kTW = 32;                 // owned quarter columns per block
constexpr int kR = 8;                   // staged ring, quarter cells
constexpr int kRows = kTH + 2 * kR;     // 48
constexpr int kCols = kTW + 2 * kR;     // 48
constexpr int kPlane = kRows * kCols;
constexpr int kThreads = 256;
constexpr size_t kSmemBytes = 8 * kPlane * sizeof(float);  // u and g, 4 planes each

enum { EE = 0, EO = 1, OE = 2, OO = 3 };

using Plane = float[kRows][kCols];

struct Geo {
  int h, w;      // true dense domain
  int hq, wq2;   // quarter plane extents (multiples of kTH, kTW)
};

struct Weights {
  float up_a, up_b;  // even h, ascent: rows h-2 / h-1 take mids * 2(1+1)/3, 2/3
  float dn_e, dn_o;  // even h, descent: coarse row hc-1 takes (1+1)/3 * 0.5, 1/3 * 0.5
  float rc_a, rc_b;  // even w, lane restriction: column wc-1 takes 2(1+1)/3, 2/3
};

__device__ __forceinline__ bool in_dom(const Geo& G, int p, int gr, int gc) {
  const int r = 2 * gr + (p >> 1), c = 2 * gc + (p & 1);
  return r >= 0 && r < G.h && c >= 0 && c < G.w;
}

// Stage the four planes of one channel (x: its base, nullptr stages zeros)
// around the tile whose (0, 0) ring point is quarter (gr0, gc0).
__device__ __forceinline__ void stage(Plane* s, const float* __restrict__ x,
                                      const Geo& G, int gr0, int gc0) {
  for (int i = threadIdx.x; i < 4 * kPlane; i += kThreads) {
    const int p = i / kPlane, k = i % kPlane;
    const int lr = k / kCols, lc = k % kCols;
    const int gr = gr0 + lr, gc = gc0 + lc;
    float v = 0.0f;
    if (x != nullptr && gr >= 0 && gr < G.hq && gc >= 0 && gc < G.wq2)
      v = x[((size_t)p * G.hq + gr) * G.wq2 + gc];
    s[p][lr][lc] = v;
  }
}

// One half-sweep: colour 0 updates EE and OO, colour 1 EO and OE. A known-zero
// guess (first red half-sweep only) gives (0 - g) * 0.25. Ends with a barrier.
__device__ __forceinline__ void half_sweep(Plane* u, Plane* g, const Geo& G,
                                           int gr0, int gc0, int color,
                                           bool zero_guess) {
  for (int i = threadIdx.x; i < kPlane; i += kThreads) {
    const int lr = i / kCols, lc = i % kCols;
    const int gr = gr0 + lr, gc = gc0 + lc;
    const bool top = lr >= 1, bot = lr <= kRows - 2;
    const bool lft = lc >= 1, rgt = lc <= kCols - 2;
    if (color == 0) {
      if (top && lft && in_dom(G, EE, gr, gc)) {
        const float n = zero_guess ? 0.0f
            : ((u[OE][lr - 1][lc] + u[OE][lr][lc]) + u[EO][lr][lc - 1]) + u[EO][lr][lc];
        u[EE][lr][lc] = (n - g[EE][lr][lc]) * 0.25f;
      }
      if (bot && rgt && in_dom(G, OO, gr, gc)) {
        const float n = zero_guess ? 0.0f
            : ((u[EO][lr][lc] + u[EO][lr + 1][lc]) + u[OE][lr][lc]) + u[OE][lr][lc + 1];
        u[OO][lr][lc] = (n - g[OO][lr][lc]) * 0.25f;
      }
    } else {
      if (top && rgt && in_dom(G, EO, gr, gc)) {
        const float n =
            ((u[OO][lr - 1][lc] + u[OO][lr][lc]) + u[EE][lr][lc]) + u[EE][lr][lc + 1];
        u[EO][lr][lc] = (n - g[EO][lr][lc]) * 0.25f;
      }
      if (bot && lft && in_dom(G, OE, gr, gc)) {
        const float n =
            ((u[EE][lr][lc] + u[EE][lr + 1][lc]) + u[OO][lr][lc - 1]) + u[OO][lr][lc];
        u[OE][lr][lc] = (n - g[OE][lr][lc]) * 0.25f;
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void sweeps(Plane* u, Plane* g, const Geo& G,
                                       int gr0, int gc0, int n, bool zero_guess) {
  for (int k = 0; k < n; ++k) {
    half_sweep(u, g, G, gr0, gc0, 0, zero_guess && k == 0);
    half_sweep(u, g, G, gr0, gc0, 1, false);
  }
}

// The ascent's correction, added to every staged point inside the domain.
// e_even / e_odd (channel bases, (rows, wq2)): the even / odd dense-column
// planes of the lane-prolonged coarse correction, E(q) their row q for
// 0 <= q < hc and 0 elsewhere. Dense row 2q takes mids(q) = 0.5 (E(q-1) +
// E(q)), dense row 2q+1 takes E(q); for even h, quarter row hc (dense rows
// h-2, h-1) takes mids(hc) * up_a and mids(hc) * up_b. Ends with a barrier.
__device__ __forceinline__ void correct(Plane* u, const float* __restrict__ ee,
                                        const float* __restrict__ eo, const Geo& G,
                                        const Weights& W, int gr0, int gc0) {
  const int hc = (G.h - 1) / 2;
  const bool h_even = G.h % 2 == 0;
  for (int i = threadIdx.x; i < kPlane; i += kThreads) {
    const int lr = i / kCols, lc = i % kCols;
    const int gr = gr0 + lr, gc = gc0 + lc;
    if (gr < 0 || gc < 0 || gc >= G.wq2 || !in_dom(G, EE, gr, gc)) continue;
    const bool has0 = gr < hc, hasm = gr >= 1 && gr - 1 < hc;
    const size_t k0 = (size_t)gr * G.wq2 + gc, km = k0 - G.wq2;
    const float e0 = has0 ? ee[k0] : 0.0f, em = hasm ? ee[km] : 0.0f;
    const float o0 = has0 ? eo[k0] : 0.0f, om = hasm ? eo[km] : 0.0f;
    const float mid_e = 0.5f * (em + e0), mid_o = 0.5f * (om + o0);
    float c_ee = mid_e, c_eo = mid_o, c_oe = e0, c_oo = o0;
    if (h_even && gr == hc) {
      c_ee = mid_e * W.up_a;
      c_eo = mid_o * W.up_a;
      c_oe = mid_e * W.up_b;
      c_oo = mid_o * W.up_b;
    }
    u[EE][lr][lc] = u[EE][lr][lc] + c_ee;
    if (in_dom(G, EO, gr, gc)) u[EO][lr][lc] = u[EO][lr][lc] + c_eo;
    if (in_dom(G, OE, gr, gc)) u[OE][lr][lc] = u[OE][lr][lc] + c_oe;
    if (in_dom(G, OO, gr, gc)) u[OO][lr][lc] = u[OO][lr][lc] + c_oo;
  }
  __syncthreads();
}

// Residual of the red cells (black ones are exactly 0 after a black
// half-sweep) over quarter rows [r0, r0 + kTH] and columns [c0, c0 + kTW]:
//   re = g - (ns - 4 u) at EE, ro the same at OO, 0 outside the domain,
// written into g's EO and OE planes (the red residual does not read them).
// Ends with a barrier.
using Res = float[kTW + 1];

__device__ __forceinline__ void residual(Plane* u, Plane* g, const Geo& G, int gr0,
                                         int gc0, Res* re, Res* ro) {
  for (int i = threadIdx.x; i < (kTH + 1) * (kTW + 1); i += kThreads) {
    const int rr = i / (kTW + 1), cc = i % (kTW + 1);
    const int lr = kR + rr, lc = kR + cc;
    const int gr = gr0 + lr, gc = gc0 + lc;
    float a = 0.0f, b = 0.0f;
    if (in_dom(G, EE, gr, gc)) {
      const float n =
          ((u[OE][lr - 1][lc] + u[OE][lr][lc]) + u[EO][lr][lc - 1]) + u[EO][lr][lc];
      a = g[EE][lr][lc] - (n - 4.0f * u[EE][lr][lc]);
    }
    if (in_dom(G, OO, gr, gc)) {
      const float n =
          ((u[EO][lr][lc] + u[EO][lr + 1][lc]) + u[OE][lr][lc]) + u[OE][lr][lc + 1];
      b = g[OO][lr][lc] - (n - 4.0f * u[OO][lr][lc]);
    }
    re[rr][cc] = a;
    ro[rr][cc] = b;
  }
  __syncthreads();
}

// max |re|, |ro| over the owned tile, stored by thread 0 at *out.
__device__ __forceinline__ void store_max(Res* re, Res* ro, float* out) {
  __shared__ float warp_max[kThreads / 32];
  float m = 0.0f;
  for (int i = threadIdx.x; i < kTH * kTW; i += kThreads) {
    const int rr = i / kTW, cc = i % kTW;
    m = fmaxf(m, fmaxf(fabsf(re[rr][cc]), fabsf(ro[rr][cc])));
  }
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kThreads / 32; ++k) m = fmaxf(m, warp_max[k]);
    *out = m;
  }
}

// Row restriction of the residual and the transposed x4 lane restriction, in
// one step: rc_t[jw, jc] for the tile's jw = c0 + cc < chp, jc = r0 + rr:
//   rh_e(jc, j) = 0.25 re(jc, j) + wd re(jc+1, j)   (wd = 0.25; dn_e at jc =
//     hc-1 for even h), the even dense columns of the row-restricted residual
//   rh_o(jc, j) = 0.5 ro(jc, j) [+ wo ro(jc+1, j) for even h; wo = 0, or
//     dn_o at jc = hc-1], its odd columns
//   out = (rh_e(j) + 2 rh_o(j)) + rh_e(j+1) for jw < wc, jc < hc; for even w
//     at jw = wc-1: ((rh_e(j) + 2 rh_o(j)) + rc_a rh_e(j+1)) + rc_b rh_o(j+1)
//   0 for jw >= wc or jc >= hc.
__device__ __forceinline__ void store_rct(Res* re, Res* ro, const Geo& G,
                                          const Weights& W, float* __restrict__ rc,
                                          int chp, int r0, int c0) {
  const int hc = (G.h - 1) / 2, wc = (G.w - 1) / 2;
  const bool h_even = G.h % 2 == 0, w_even = G.w % 2 == 0;
  for (int i = threadIdx.x; i < kTW * kTH; i += kThreads) {
    const int cc = i / kTH, rr = i % kTH;
    const int jw = c0 + cc, jc = r0 + rr;
    if (jw >= chp) continue;
    float v = 0.0f;
    if (jw < wc && jc < hc) {
      const bool last = h_even && jc == hc - 1;
      const float wd = last ? W.dn_e : 0.25f;
      const float wo = last ? W.dn_o : 0.0f;
      const float he0 = 0.25f * re[rr][cc] + wd * re[rr + 1][cc];
      const float he1 = 0.25f * re[rr][cc + 1] + wd * re[rr + 1][cc + 1];
      const float ho0 = h_even ? 0.5f * ro[rr][cc] + wo * ro[rr + 1][cc]
                               : 0.5f * ro[rr][cc];
      if (w_even && jw == wc - 1) {
        const float ho1 = h_even ? 0.5f * ro[rr][cc + 1] + wo * ro[rr + 1][cc + 1]
                                 : 0.5f * ro[rr][cc + 1];
        v = ((he0 + 2.0f * ho0) + W.rc_a * he1) + W.rc_b * ho1;
      } else {
        v = (he0 + 2.0f * ho0) + he1;
      }
    }
    rc[(size_t)jw * G.hq + jc] = v;
  }
}

// The split form of the row restriction (no lane restriction): the tile's
// rh_e(jc, j) and rh_o(jc, j) of store_rct for jc = r0 + rr < hc, exact zeros
// for jc >= hc, written along the planes' rows into rh_e / rh_o (channel
// bases, (hq, wq2)).
__device__ __forceinline__ void store_rh(Res* re, Res* ro, const Geo& G,
                                         const Weights& W, float* __restrict__ rh_e,
                                         float* __restrict__ rh_o, int r0, int c0) {
  const int hc = (G.h - 1) / 2;
  const bool h_even = G.h % 2 == 0;
  for (int i = threadIdx.x; i < kTH * kTW; i += kThreads) {
    const int rr = i / kTW, cc = i % kTW;
    const int jc = r0 + rr;
    float he = 0.0f, ho = 0.0f;
    if (jc < hc) {
      const bool last = h_even && jc == hc - 1;
      const float wd = last ? W.dn_e : 0.25f;
      const float wo = last ? W.dn_o : 0.0f;
      he = 0.25f * re[rr][cc] + wd * re[rr + 1][cc];
      ho = h_even ? 0.5f * ro[rr][cc] + wo * ro[rr + 1][cc] : 0.5f * ro[rr][cc];
    }
    const size_t k = (size_t)jc * G.wq2 + c0 + cc;
    rh_e[k] = he;
    rh_o[k] = ho;
  }
}

// Write the owned tile of the four planes into x (a channel base).
__device__ __forceinline__ void store(Plane* s, float* __restrict__ x, const Geo& G,
                                      int r0, int c0) {
  for (int i = threadIdx.x; i < 4 * kTH * kTW; i += kThreads) {
    const int p = i / (kTH * kTW), k = i % (kTH * kTW);
    const int rr = k / kTW, cc = k % kTW;
    x[((size_t)p * G.hq + r0 + rr) * G.wq2 + c0 + cc] = s[p][kR + rr][kR + cc];
  }
}

// One block per (channel, kTH x kTW quarter tile). kAscend: the correction
// and nu2 sweeps (mg_up_q; with rmax, also the tile's max |r| of the swept
// state); kDescend: nu1 sweeps, the residual, the fused restriction into
// rc_t (C, chp, hq) or, with kSplit, the split row restriction into rh_e,
// rh_o (C, hq, wq2), and, with rmax, the tile's max |r| (mg_down_q; u ==
// nullptr is a known-zero guess). Both: mg_ud_q.
template <bool kAscend, bool kDescend, bool kSplit = false>
__global__ void __launch_bounds__(kThreads)
level_q_kernel(const float* __restrict__ u, const float* __restrict__ g,
               const float* __restrict__ e_even, const float* __restrict__ e_odd,
               float* __restrict__ u_out, float* __restrict__ rc_t,
               float* __restrict__ rh_e, float* __restrict__ rh_o,
               float* __restrict__ rmax, Geo G, int nu2, int nu1, int chp, Weights W) {
  extern __shared__ float smem[];
  Plane* su = reinterpret_cast<Plane*>(smem);
  Plane* sg = su + 4;
  const int c = blockIdx.z;
  const int r0 = blockIdx.y * kTH, c0 = blockIdx.x * kTW;
  const int gr0 = r0 - kR, gc0 = c0 - kR;
  const size_t chan = 4 * (size_t)G.hq * G.wq2;
  stage(su, u == nullptr ? nullptr : u + c * chan, G, gr0, gc0);
  stage(sg, g + c * chan, G, gr0, gc0);
  __syncthreads();
  if (kAscend) {
    const size_t eplane = (size_t)G.hq * G.wq2;  // e rows: hq (= hp2)
    correct(su, e_even + c * eplane, e_odd + c * eplane, G, W, gr0, gc0);
    sweeps(su, sg, G, gr0, gc0, nu2, false);
  }
  if (kDescend) sweeps(su, sg, G, gr0, gc0, nu1, u == nullptr);
  if (kDescend || rmax != nullptr) {
    Res* re = reinterpret_cast<Res*>(&sg[EO][0][0]);
    Res* ro = reinterpret_cast<Res*>(&sg[OE][0][0]);
    residual(su, sg, G, gr0, gc0, re, ro);
    if (rmax != nullptr)
      store_max(re, ro, rmax + ((size_t)c * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);
    if (kDescend && kSplit) {
      const size_t plane = (size_t)G.hq * G.wq2;
      store_rh(re, ro, G, W, rh_e + c * plane, rh_o + c * plane, r0, c0);
    } else if (kDescend) {
      store_rct(re, ro, G, W, rc_t + (size_t)c * chp * G.hq, chp, r0, c0);
    }
  }
  store(su, u_out + c * chan, G, r0, c0);
}

// Launch one instantiation on a (wq2 / kTW, hq / kTH, c) grid with the
// dynamic shared memory it needs; returns the cudaError_t.
template <bool kAscend, bool kDescend, bool kSplit = false>
int launch(const float* u, const float* g, const float* e_even, const float* e_odd,
           float* u_out, float* rc_t, float* rh_e, float* rh_o, float* rmax, int c, Geo G,
           int nu2, int nu1, int chp, Weights W, void* stream) {
  if (c <= 0 || G.hq <= 0 || G.wq2 <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(level_q_kernel<kAscend, kDescend, kSplit>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(G.wq2 / kTW, G.hq / kTH, c);
  level_q_kernel<kAscend, kDescend, kSplit><<<grid, kThreads, kSmemBytes,
                                              static_cast<cudaStream_t>(stream)>>>(
      u, g, e_even, e_odd, u_out, rc_t, rh_e, rh_o, rmax, G, nu2, nu1, chp, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mgq
