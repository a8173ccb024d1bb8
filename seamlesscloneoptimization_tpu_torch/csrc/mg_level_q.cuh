// mg_level_q.cuh: the quarter-plane finest multigrid level on a shared-memory
// tile, shared by mg_down_q.cu, mg_up_q.cu and mg_ud_q.cu (one kernel
// template, four instantiations: the descent in its fused-restrict and its
// split form, the ascent, the fused boundary).
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
// Here a block owns a kTH x kTW = 32 x 64 quarter tile (64 x 128 dense
// points) of one channel and stages u and g, all four planes, with a ring of
// quarter cells around it (Ring: top, bottom, left, right).
//
// What bounds it, and the design's answer (PERF.md section 6). The kernel
// moves u, g and the correction once (mg_ud_q: 0.145 ms at the 8K
// level on 3.35 TB/s). The first design took 0.71 ms: staging u and g with
// synchronous loads 0.35, the correction's scattered e loads 0.08, sweeps
// over every staged point 0.22. This one takes 0.33: staging u, g and the
// store 0.16 (DRAM), the correction 0.04, 6 half-sweeps 0.09, the residual
// and rc_t 0.03 (issue-bound), one block's phases after one another.
// - Staging is asynchronous: every thread issues 16-byte cp.async copies
//   (src-size 0 fills the off-plane points with the zero frame), u's then
//   g's as two groups; the correction's rows of e load into registers
//   meanwhile and are added once u has landed, while g's copies still fly.
//   Two blocks fit on an SM (99.7 KB each), so one block's copies overlap
//   the other's sweeps (a persistent block per SM that prefetched the
//   next tile into a second buffer measured slower: 0.45 ms).
// - The ring is as deep as the sweeps need, not the gate's worst case: 4 / 5
//   quarter rows above / below and 4 / 8 columns left / right (8 for the
//   16-byte alignment) keep 7 half-sweeps exact (Shallow, 1.52x the owned
//   points, against 2.25x before); only nu1 + nu2 > 3 takes Deep (8 all
//   round, 13 half-sweeps).
// - The update region shrinks (a trapezoid). What the block needs at the
//   end, N, is the owned tile, plus for the residual and the restriction one
//   dense layer above and left and three below and right. A half-sweep reads
//   one dense layer beyond the points it updates, so half-sweep k of H
//   updates N dilated by H - k dense layers, and the correction N dilated by
//   H. Each plane's region is one rectangle of local quarter cells, cut by
//   the domain once per half-sweep (no per-point domain test). By induction
//   the points of N dilated by H - k are exact after half-sweep k; the
//   rectangle stays inside the staged tile (its neighbours staged) while
//   H <= 2 top - 1, 2 left - 1 and 2 bottom - 3, 2 right - 3 (Ring::kDepth).
// - A thread updates four neighbouring columns of a colour's two planes
//   from 16-byte shared loads, the residual two (column pairs); each
//   correction row of e is read once, coalesced, and serves two quarter
//   rows.
//
// Arithmetic in the plain twin's order (ops/kernels.py: _q_sweeps,
// _q_residual, _q_rct, _q_correct); the build's -fmad=false keeps each
// operation rounded on its own, so the kernels are bit-equal to the twins.

#pragma once

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace mgq {

constexpr int kTH = 32;       // owned quarter rows per block
constexpr int kTW = 64;       // owned quarter columns per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum { EE = 0, EO = 1, OE = 2, OO = 3 };

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The staged ring, quarter cells above, below, left and right of the owned
// tile; kL and kR multiples of 4 (16-byte copies). kDepth: the half-sweeps
// after which the residual's reads are still exact (see the header note).
template <int T, int B, int L, int R>
struct Ring {
  static constexpr int kT = T, kB = B, kL = L, kR = R;
  static constexpr int kRows = kTH + T + B;
  static constexpr int kCols = kTW + L + R;
  static constexpr int kPlane = kRows * kCols;
  static constexpr int kDepth = cmin(cmin(2 * T - 1, 2 * B - 3), cmin(2 * L - 1, 2 * R - 3));
  static constexpr size_t kSmemBytes = 8 * kPlane * sizeof(float);  // u and g
};
using Shallow = Ring<4, 5, 4, 8>;  // 41 x 76, 7 half-sweeps, 99.7 KB
using Deep = Ring<8, 8, 8, 8>;     // 48 x 80, 13 half-sweeps, 122.9 KB

struct Geo {
  int h, w;      // true dense domain
  int hq, wq2;   // quarter plane extents (multiples of kTH, kTW)
};

struct Weights {
  float up_a, up_b;  // even h, ascent: rows h-2 / h-1 take mids * 2(1+1)/3, 2/3
  float dn_e, dn_o;  // even h, descent: coarse row hc-1 takes (1+1)/3 * 0.5, 1/3 * 0.5
  float rc_a, rc_b;  // even w, lane restriction: column wc-1 takes 2(1+1)/3, 2/3
};

// A rectangle of local staged cells, rows [r0, r1) x columns [c0, c1).
struct Rect {
  int r0, r1, c0, c1;
  __device__ __forceinline__ bool has(int r, int c) const {
    return r >= r0 && r < r1 && c >= c0 && c < c1;
  }
};

__device__ __forceinline__ bool in_dom(const Geo& G, int p, int gr, int gc) {
  const int r = 2 * gr + (p >> 1), c = 2 * gc + (p & 1);
  return r >= 0 && r < G.h && c >= 0 && c < G.w;
}

__device__ __forceinline__ int ceil_half(int x) { return (x + 1) >> 1; }  // any sign

// The local cells of plane p whose dense points lie in the owned-relative
// dense rectangle [dr0, dr1) x [dc0, dc1) and inside the domain, cut to the
// cells whose four neighbours are staged. (r0, c0): the owned tile's origin.
template <class Rg>
__device__ __forceinline__ Rect plane_rect(int p, int dr0, int dr1, int dc0, int dc1,
                                           const Geo& G, int r0, int c0) {
  const int rp = p >> 1, cp = p & 1;
  int q0 = max(ceil_half(dr0 - rp), -r0);
  int q1 = min(ceil_half(dr1 - rp), ceil_half(G.h - rp) - r0);
  int k0 = max(ceil_half(dc0 - cp), -c0);
  int k1 = min(ceil_half(dc1 - cp), ceil_half(G.w - cp) - c0);
  // EE reads the row above and the column left, OO below and right, EO
  // above and right, OE below and left
  const int top = rp == 0 ? 1 : 0, bot = rp == 1 ? 1 : 0;
  const int lft = (p == EE || p == OE) ? 1 : 0, rgt = 1 - lft;
  return Rect{max(q0 + Rg::kT, top), min(q1 + Rg::kT, Rg::kRows - bot),
              max(k0 + Rg::kL, lft), min(k1 + Rg::kL, Rg::kCols - rgt)};
}

// The dense rectangle N (owned-relative) that the block needs at the end,
// dilated by d: the owned tile, and with the residual one dense layer above
// and left, three below and right.
template <class Rg>
__device__ __forceinline__ Rect need_rect(int p, bool resid, int d, const Geo& G, int r0,
                                          int c0) {
  const int lo = resid ? -1 : 0;
  return plane_rect<Rg>(p, lo - d, 2 * kTH + (resid ? 3 : 0) + d, lo - d,
                        2 * kTW + (resid ? 3 : 0) + d, G, r0, c0);
}

// Issue the copies of the four planes of one channel (x: its base) around
// the tile whose (0, 0) staged cell is quarter (gr0, gc0); off-plane chunks
// are zero-filled (gc0 and wq2 are multiples of 4: a chunk is all in or all
// out).
template <class Rg>
__device__ __forceinline__ void stage_async(float* s, const float* __restrict__ x,
                                            const Geo& G, int gr0, int gc0) {
  constexpr int kChunks = Rg::kCols / 4;
  constexpr int kPerPlane = Rg::kRows * kChunks;
  for (int i = threadIdx.x; i < 4 * kPerPlane; i += kThreads) {
    const int p = i / kPerPlane, k = i % kPerPlane;
    const int lr = k / kChunks, ch = k % kChunks;
    const int gr = gr0 + lr, gc = gc0 + 4 * ch;
    const bool ok = gr >= 0 && gr < G.hq && gc >= 0 && gc < G.wq2;
    acp::copy16(s + (p * Rg::kRows + lr) * Rg::kCols + 4 * ch,
                ok ? x + ((size_t)p * G.hq + gr) * G.wq2 + gc : x, ok);
  }
}

template <class Rg>
__device__ __forceinline__ void zero_planes(float* s) {
  float4* s4 = reinterpret_cast<float4*>(s);
  for (int i = threadIdx.x; i < Rg::kPlane; i += kThreads)  // 4 planes = kPlane float4s
    s4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

#define MGQ_AT(a, p, r, c) a[((p) * Rg::kRows + (r)) * Rg::kCols + (c)]
#define MGQ_AT2(a, p, r, c) (*reinterpret_cast<float2*>(&MGQ_AT(a, p, r, c)))
#define MGQ_LD2(a, p, r, c) (*reinterpret_cast<const float2*>(&MGQ_AT(a, p, r, c)))

// A block-wide walk over n units of a row (column pairs or quads) in local
// rows [rlo, rhi): thread t takes items t, t + kThreads, ... in row-major
// order, stepped without a division.
struct Walk {
  int r, k, rhi, n, dr, dk;
  __device__ __forceinline__ Walk(int rlo, int rhi_, int n_) : rhi(rhi_), n(n_) {
    if (n <= 0) {
      r = rhi;
      return;
    }
    r = rlo + threadIdx.x / n;
    k = threadIdx.x % n;
    dr = kThreads / n;
    dk = kThreads % n;
  }
  __device__ __forceinline__ bool more() const { return r < rhi; }
  __device__ __forceinline__ void next() {
    r += dr;
    k += dk;
    if (k >= n) {
      k -= n;
      ++r;
    }
  }
};

// Store v.x at column c and v.y at column c + 1 of plane p, row r, where
// the flags say.
template <class Rg>
__device__ __forceinline__ void put2(float* u, int p, int r, int c, bool x, bool y, float2 v) {
  if (x && y)
    MGQ_AT2(u, p, r, c) = v;
  else if (x)
    MGQ_AT(u, p, r, c) = v.x;
  else if (y)
    MGQ_AT(u, p, r, c + 1) = v.y;
}

// Store the four columns c .. c + 3 of row r of plane p that lie in R (c a
// multiple of 4): one 16-byte store when all four do.
template <class Rg>
__device__ __forceinline__ void put4(float* u, int p, int r, int c, const Rect& R, float4 v) {
  if (r < R.r0 || r >= R.r1) return;
  if (c >= R.c0 && c + 4 <= R.c1) {
    *reinterpret_cast<float4*>(&MGQ_AT(u, p, r, c)) = v;
    return;
  }
  const float x[4] = {v.x, v.y, v.z, v.w};
  for (int i = 0; i < 4; ++i)
    if (c + i >= R.c0 && c + i < R.c1) MGQ_AT(u, p, r, c + i) = x[i];
}

__device__ __forceinline__ bool touches(const Rect& R, int r, int c) {  // columns c .. c + 3
  return r >= R.r0 && r < R.r1 && c + 4 > R.c0 && c < R.c1;
}

#define MGQ_LD4(a, p, r, c) (*reinterpret_cast<const float4*>(&MGQ_AT(a, p, r, c)))

// One half-sweep: colour 0 updates EE and OO, colour 1 EO and OE, each over
// its rectangle (need_rect dilated by d). A thread updates four
// neighbouring columns of both planes at once from 16-byte loads (c a
// multiple of 4; a point's own quad, plus the one scalar its stencil
// reaches across it), the planes' rows being multiples of 4 floats. Loads
// past a rectangle's edge stay inside the staged planes (u's reads past
// its last plane land in g's) and are discarded. A known-zero guess (the
// first red half-sweep of a descent from u == nullptr) gives (0 - g) * 0.25.
// Ends with a barrier.
template <class Rg>
__device__ __forceinline__ void half_sweep(float* u, const float* g, const Geo& G, int r0,
                                           int c0, int color, bool zero_guess, bool resid,
                                           int d) {
  const int pa = color == 0 ? EE : EO, pb = color == 0 ? OO : OE;
  const Rect A = need_rect<Rg>(pa, resid, d, G, r0, c0);
  const Rect B = need_rect<Rg>(pb, resid, d, G, r0, c0);
  const int clo = min(A.c0, B.c0) & ~3, chi = max(A.c1, B.c1);
  for (Walk it(min(A.r0, B.r0), max(A.r1, B.r1), (chi - clo + 3) >> 2); it.more();
       it.next()) {
    const int r = it.r, c = clo + 4 * it.k;
    const bool a = touches(A, r, c), b = touches(B, r, c);
    if (color == 0) {
      const float4 eo = MGQ_LD4(u, EO, r, c), oe = MGQ_LD4(u, OE, r, c);
      if (a) {
        const float4 up = MGQ_LD4(u, OE, r - 1, c), gg = MGQ_LD4(g, EE, r, c);
        const float lf = MGQ_AT(u, EO, r, c - 1);
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (!zero_guess)
          v = make_float4(((up.x + oe.x) + lf) + eo.x, ((up.y + oe.y) + eo.x) + eo.y,
                          ((up.z + oe.z) + eo.y) + eo.z, ((up.w + oe.w) + eo.z) + eo.w);
        put4<Rg>(u, EE, r, c, A,
                 make_float4((v.x - gg.x) * 0.25f, (v.y - gg.y) * 0.25f,
                             (v.z - gg.z) * 0.25f, (v.w - gg.w) * 0.25f));
      }
      if (b) {
        const float4 dn = MGQ_LD4(u, EO, r + 1, c), gg = MGQ_LD4(g, OO, r, c);
        const float rt = MGQ_AT(u, OE, r, c + 4);
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (!zero_guess)
          v = make_float4(((eo.x + dn.x) + oe.x) + oe.y, ((eo.y + dn.y) + oe.y) + oe.z,
                          ((eo.z + dn.z) + oe.z) + oe.w, ((eo.w + dn.w) + oe.w) + rt);
        put4<Rg>(u, OO, r, c, B,
                 make_float4((v.x - gg.x) * 0.25f, (v.y - gg.y) * 0.25f,
                             (v.z - gg.z) * 0.25f, (v.w - gg.w) * 0.25f));
      }
    } else {
      const float4 oo = MGQ_LD4(u, OO, r, c), ee = MGQ_LD4(u, EE, r, c);
      if (a) {
        const float4 up = MGQ_LD4(u, OO, r - 1, c), gg = MGQ_LD4(g, EO, r, c);
        const float rt = MGQ_AT(u, EE, r, c + 4);
        put4<Rg>(u, EO, r, c, A,
                 make_float4(((((up.x + oo.x) + ee.x) + ee.y) - gg.x) * 0.25f,
                             ((((up.y + oo.y) + ee.y) + ee.z) - gg.y) * 0.25f,
                             ((((up.z + oo.z) + ee.z) + ee.w) - gg.z) * 0.25f,
                             ((((up.w + oo.w) + ee.w) + rt) - gg.w) * 0.25f));
      }
      if (b) {
        const float4 dn = MGQ_LD4(u, EE, r + 1, c), gg = MGQ_LD4(g, OE, r, c);
        const float lf = MGQ_AT(u, OO, r, c - 1);
        put4<Rg>(u, OE, r, c, B,
                 make_float4(((((ee.x + dn.x) + lf) + oo.x) - gg.x) * 0.25f,
                             ((((ee.y + dn.y) + oo.x) + oo.y) - gg.y) * 0.25f,
                             ((((ee.z + dn.z) + oo.y) + oo.z) - gg.z) * 0.25f,
                             ((((ee.w + dn.w) + oo.z) + oo.w) - gg.w) * 0.25f));
      }
    }
  }
  __syncthreads();
}

// The ascent's correction over N dilated by d (the whole sweep count).
// e_even / e_odd (channel bases, (rows, wq2)): the even / odd dense-column
// planes of the lane-prolonged coarse correction, E(q) their row q for
// 0 <= q < hc and 0 elsewhere. Dense row 2q takes mids(q) = 0.5 (E(q-1) +
// E(q)), dense row 2q+1 takes E(q); for even h, quarter row hc (dense rows
// h-2, h-1) takes mids(hc) * up_a and mids(hc) * up_b.
//
// A thread takes one column pair and a run of at most kMax rows of it
// (a block has at most 40 pairs a row, so 256 threads cut the <= 48 rows
// into runs of <= 8). load() reads the run's rows of E, and the row above
// it, into registers (float2, coalesced) before the block waits for its
// staged tile, so the reads overlap the copies; apply() adds them.
__device__ __forceinline__ float2 mid2(float2 a, float2 b) {
  return make_float2(0.5f * (a.x + b.x), 0.5f * (a.y + b.y));
}

__device__ __forceinline__ float2 scale2(float2 a, float s) {
  return make_float2(a.x * s, a.y * s);
}

template <class Rg>
struct Correction {
  static constexpr int kMax = 8;
  static constexpr int kPairs = (Rg::kCols + 1) / 2, kRuns = kThreads / kPairs;
  static_assert((Rg::kRows + kRuns - 1) / kRuns <= kMax, "a run longer than kMax rows");
  Rect P[4];           // each plane's cells
  int c, ra, rb;       // the thread's column pair and rows [ra, rb)
  float2 e[kMax + 1];  // E_even(gr0 + ra - 1 + j), j = 0 .. kMax
  float2 o[kMax + 1];  // E_odd, the same rows

  __device__ __forceinline__ void load(const float* __restrict__ ee,
                                       const float* __restrict__ eo, const Geo& G, int r0,
                                       int c0, bool resid, int d) {
    for (int p = 0; p < 4; ++p) P[p] = need_rect<Rg>(p, resid, d, G, r0, c0);
    const int rlo = min(min(P[0].r0, P[1].r0), min(P[2].r0, P[3].r0));
    const int rhi = max(max(P[0].r1, P[1].r1), max(P[2].r1, P[3].r1));
    const int clo = min(min(P[0].c0, P[1].c0), min(P[2].c0, P[3].c0)) & ~1;
    const int chi = max(max(P[0].c1, P[1].c1), max(P[2].c1, P[3].c1));
    const int np = (chi - clo + 1) >> 1;
    ra = rb = 0;
    if (np <= 0 || rhi <= rlo) return;
    const int chunks = max(1, min(kThreads / np, rhi - rlo));
    const int per = (rhi - rlo + chunks - 1) / chunks;  // <= kMax
    if ((int)threadIdx.x >= np * chunks) return;
    c = clo + 2 * (threadIdx.x % np);
    ra = rlo + (threadIdx.x / np) * per;
    rb = min(ra + per, rhi);
    const int hc = (G.h - 1) / 2;
    const size_t gc = (size_t)(c0 - Rg::kL + c);  // even
    const int gr = r0 - Rg::kT + ra - 1;
#pragma unroll
    for (int j = 0; j <= kMax; ++j) {
      const int q = gr + j;
      const bool ok = j <= rb - ra && q >= 0 && q < hc;
      e[j] = ok ? *reinterpret_cast<const float2*>(&ee[(size_t)q * G.wq2 + gc])
                : make_float2(0.0f, 0.0f);
      o[j] = ok ? *reinterpret_cast<const float2*>(&eo[(size_t)q * G.wq2 + gc])
                : make_float2(0.0f, 0.0f);
    }
  }

  // Ends with a barrier.
  __device__ __forceinline__ void apply(float* u, const Geo& G, const Weights& W, int r0) {
    const int hc = (G.h - 1) / 2;
    const bool h_even = G.h % 2 == 0;
#pragma unroll
    for (int j = 0; j < kMax; ++j) {
      const int r = ra + j;
      if (r < rb) {
        const int gr = r0 - Rg::kT + r;
        const float2 mid_e = mid2(e[j], e[j + 1]), mid_o = mid2(o[j], o[j + 1]);
        float2 add[4] = {mid_e, mid_o, e[j + 1], o[j + 1]};
        if (h_even && gr == hc) {
          add[EE] = scale2(mid_e, W.up_a);
          add[EO] = scale2(mid_o, W.up_a);
          add[OE] = scale2(mid_e, W.up_b);
          add[OO] = scale2(mid_o, W.up_b);
        }
        for (int p = 0; p < 4; ++p) {
          const float2 v = MGQ_LD2(u, p, r, c);
          put2<Rg>(u, p, r, c, P[p].has(r, c), P[p].has(r, c + 1),
                   make_float2(v.x + add[p].x, v.y + add[p].y));
        }
      }
    }
    __syncthreads();
  }
};

// Residual of the red cells (black ones are exactly 0 after a black
// half-sweep) over quarter rows [r0, r0 + kTH] and columns [c0, c0 + kTW]:
//   re = g - (ns - 4 u) at EE, ro the same at OO, 0 outside the domain,
// written into g's EO and OE planes (the red residual does not read them),
// rows kTW + 2 wide so that a thread writes a column pair (column kTW + 1
// is computed and never read). Ends with a barrier.
using Res = float[kTW + 2];

template <class Rg>
__device__ __forceinline__ void residual(const float* u, const float* g, const Geo& G,
                                         int r0, int c0, Res* re, Res* ro) {
  for (Walk it(0, kTH + 1, kTW / 2 + 1); it.more(); it.next()) {
    const int rr = it.r, cc = 2 * it.k;
    const int r = Rg::kT + rr, c = Rg::kL + cc;
    const int gr = r0 + rr, gc = c0 + cc;
    const float2 eo = MGQ_LD2(u, EO, r, c), oe = MGQ_LD2(u, OE, r, c);
    const float2 up = MGQ_LD2(u, OE, r - 1, c), dn = MGQ_LD2(u, EO, r + 1, c);
    const float lf = MGQ_AT(u, EO, r, c - 1), rt = MGQ_AT(u, OE, r, c + 2);
    const float2 ee = MGQ_LD2(u, EE, r, c), oo = MGQ_LD2(u, OO, r, c);
    const float2 gee = MGQ_LD2(g, EE, r, c), goo = MGQ_LD2(g, OO, r, c);
    const float a0 = gee.x - ((((up.x + oe.x) + lf) + eo.x) - 4.0f * ee.x);
    const float a1 = gee.y - ((((up.y + oe.y) + eo.x) + eo.y) - 4.0f * ee.y);
    const float b0 = goo.x - ((((eo.x + dn.x) + oe.x) + oe.y) - 4.0f * oo.x);
    const float b1 = goo.y - ((((eo.y + dn.y) + oe.y) + rt) - 4.0f * oo.y);
    *reinterpret_cast<float2*>(&re[rr][cc]) =
        make_float2(in_dom(G, EE, gr, gc) ? a0 : 0.0f, in_dom(G, EE, gr, gc + 1) ? a1 : 0.0f);
    *reinterpret_cast<float2*>(&ro[rr][cc]) =
        make_float2(in_dom(G, OO, gr, gc) ? b0 : 0.0f, in_dom(G, OO, gr, gc + 1) ? b1 : 0.0f);
  }
  __syncthreads();
}

// max |re|, |ro| over the owned tile, stored by thread 0 at *out.
__device__ __forceinline__ void store_max(Res* re, Res* ro, float* out) {
  __shared__ float warp_max[kWarps];
  float m = 0.0f;
  for (int i = threadIdx.x; i < kTH * kTW; i += kThreads) {
    const int rr = i / kTW, cc = i % kTW;
    m = fmaxf(m, fmaxf(fabsf(re[rr][cc]), fabsf(ro[rr][cc])));
  }
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kWarps; ++k) m = fmaxf(m, warp_max[k]);
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

// Write the owned tile of the four planes into x (a channel base), 16 bytes
// a store.
template <class Rg>
__device__ __forceinline__ void store(const float* s, float* __restrict__ x, const Geo& G,
                                      int r0, int c0) {
  constexpr int kChunks = kTW / 4;
  for (int i = threadIdx.x; i < 4 * kTH * kChunks; i += kThreads) {
    const int p = i / (kTH * kChunks), k = i % (kTH * kChunks);
    const int rr = k / kChunks, ch = k % kChunks;
    const float4 v = *reinterpret_cast<const float4*>(
        &MGQ_AT(s, p, Rg::kT + rr, Rg::kL + 4 * ch));
    *reinterpret_cast<float4*>(&x[((size_t)p * G.hq + r0 + rr) * G.wq2 + c0 + 4 * ch]) = v;
  }
}

// One block per (channel, kTH x kTW quarter tile). kAscend: the correction
// and nu2 sweeps (mg_up_q; with rmax, also the tile's max |r| of the swept
// state); kDescend: nu1 sweeps, the residual, the fused restriction into
// rc_t (C, chp, hq) or, with kSplit, the split row restriction into rh_e,
// rh_o (C, hq, wq2), and, with rmax, the tile's max |r| (mg_down_q; u ==
// nullptr is a known-zero guess). Both: mg_ud_q. Rg::kDepth >= 2 (nu2 + nu1)
// half-sweeps (launch picks the ring).
template <bool kAscend, bool kDescend, bool kSplit, class Rg>
__global__ void __launch_bounds__(kThreads, 2)
level_q_kernel(const float* __restrict__ u, const float* __restrict__ g,
               const float* __restrict__ e_even, const float* __restrict__ e_odd,
               float* __restrict__ u_out, float* __restrict__ rc_t,
               float* __restrict__ rh_e, float* __restrict__ rh_o,
               float* __restrict__ rmax, Geo G, int nu2, int nu1, int chp, Weights W) {
  extern __shared__ __align__(16) float smem[];
  float* su = smem;
  float* sg = smem + 4 * Rg::kPlane;
  const int c = blockIdx.z;
  const int r0 = blockIdx.y * kTH, c0 = blockIdx.x * kTW;
  const int gr0 = r0 - Rg::kT, gc0 = c0 - Rg::kL;
  const size_t chan = 4 * (size_t)G.hq * G.wq2;
  // two copy groups, u then g: the correction needs only u, and runs
  // while g's copies are still landing
  if (u == nullptr)
    zero_planes<Rg>(su);
  else
    stage_async<Rg>(su, u + c * chan, G, gr0, gc0);
  acp::commit();
  stage_async<Rg>(sg, g + c * chan, G, gr0, gc0);
  acp::commit();
  const bool resid = kDescend || rmax != nullptr;
  const int n2 = kAscend ? nu2 : 0, n1 = kDescend ? nu1 : 0;
  int d = 2 * (n2 + n1);  // dense layers of dilation still to come
  if (kAscend) {
    Correction<Rg> corr;
    const size_t eplane = (size_t)G.hq * G.wq2;  // e rows: hq (= hp2)
    corr.load(e_even + c * eplane, e_odd + c * eplane, G, r0, c0, resid, d);
    acp::wait<1>();
    __syncthreads();
    corr.apply(su, G, W, r0);
  }
  acp::wait<0>();
  __syncthreads();
  for (int s = 0; s < n2 + n1; ++s) {
    half_sweep<Rg>(su, sg, G, r0, c0, 0, !kAscend && u == nullptr && s == 0, resid, --d);
    half_sweep<Rg>(su, sg, G, r0, c0, 1, false, resid, --d);
  }
  if (resid) {
    Res* re = reinterpret_cast<Res*>(sg + EO * Rg::kPlane);
    Res* ro = reinterpret_cast<Res*>(sg + OE * Rg::kPlane);
    residual<Rg>(su, sg, G, r0, c0, re, ro);
    if (rmax != nullptr)
      store_max(re, ro, rmax + ((size_t)c * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x);
    if (kDescend && kSplit) {
      const size_t plane = (size_t)G.hq * G.wq2;
      store_rh(re, ro, G, W, rh_e + c * plane, rh_o + c * plane, r0, c0);
    } else if (kDescend) {
      store_rct(re, ro, G, W, rc_t + (size_t)c * chp * G.hq, chp, r0, c0);
    }
  }
  store<Rg>(su, u_out + c * chan, G, r0, c0);
}

#undef MGQ_LD4
#undef MGQ_LD2
#undef MGQ_AT2
#undef MGQ_AT

template <bool kAscend, bool kDescend, bool kSplit, class Rg>
int launch_ring(const float* u, const float* g, const float* e_even, const float* e_odd,
                float* u_out, float* rc_t, float* rh_e, float* rh_o, float* rmax, int c,
                Geo G, int nu2, int nu1, int chp, Weights W, void* stream) {
  auto kernel = level_q_kernel<kAscend, kDescend, kSplit, Rg>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Rg::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(G.wq2 / kTW, G.hq / kTH, c);
  kernel<<<grid, kThreads, Rg::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      u, g, e_even, e_odd, u_out, rc_t, rh_e, rh_o, rmax, G, nu2, nu1, chp, W);
  return static_cast<int>(cudaGetLastError());
}

// Launch one instantiation on a (wq2 / kTW, hq / kTH, c) grid with the ring
// its 2 (nu2 + nu1) half-sweeps need; returns the cudaError_t.
template <bool kAscend, bool kDescend, bool kSplit = false>
int launch(const float* u, const float* g, const float* e_even, const float* e_odd,
           float* u_out, float* rc_t, float* rh_e, float* rh_o, float* rmax, int c, Geo G,
           int nu2, int nu1, int chp, Weights W, void* stream) {
  if (c <= 0 || G.hq <= 0 || G.wq2 <= 0) return 0;
  const int halves = 2 * ((kAscend ? nu2 : 0) + (kDescend ? nu1 : 0));
  if (halves > Deep::kDepth) return static_cast<int>(cudaErrorInvalidValue);
  if (halves <= Shallow::kDepth)
    return launch_ring<kAscend, kDescend, kSplit, Shallow>(
        u, g, e_even, e_odd, u_out, rc_t, rh_e, rh_o, rmax, c, G, nu2, nu1, chp, W, stream);
  return launch_ring<kAscend, kDescend, kSplit, Deep>(
      u, g, e_even, e_odd, u_out, rc_t, rh_e, rh_o, rmax, c, G, nu2, nu1, chp, W, stream);
}

}  // namespace mgq
