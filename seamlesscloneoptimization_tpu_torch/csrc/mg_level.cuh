// mg_level.cuh: one multigrid level's operator and red-black smoother on a
// shared-memory tile, shared by mg_down.cu and mg_up.cu.
//
// The TPU kernels (pallas_kernels.py:_level_ops, _mg_down_body,
// _mg_up_body) sweep full-width row strips with 8 ghost rows. Here a block
// owns a kTH x kTW tile of one channel and stages it with a kHalo-deep ring
// on all four sides. A half-sweep updates one colour of the tile's inner
// points in place (a red point reads only black neighbours, so there is no
// race inside a half-sweep), with __syncthreads() between half-sweeps. The
// ring's outermost points are never updated, so after k half-sweeps only
// points within k-1 of the tile edge can differ from the global sweep: with
// kHalo = 8 the owned tile is exact after 8 half-sweeps (mg_up's nu2 <= 4),
// and after 4 (mg_down's nu1 <= 2) so is the 1-px ring around the tile plus
// the 2 rows below it that the residual and the restriction read.
//
// Level operator (vertex-centred, unscaled, zero Dirichlet frame): the
// 5-point sum of neighbours, with the Shortley-Weller short gap of the
// coarse hierarchy on the last row and column when beta != 1:
//   nsum = (((up + dn) + lf) + rt) [+ lrow * up + lcol * lf]
//   diag = (row == h-1 ? 2/bh : 2) + (col == w-1 ? 2/bw : 2), inv_d = 1/diag
// (diag = 4, inv_d = 0.25 when bh == bw == 1). The coefficients arrive as
// f32 arguments, each rounded once from double on the host as the JAX
// package does, and every operation is written in the twin's order; the
// build's -fmad=false keeps each one rounded on its own, so a kernel is
// bit-equal to its plain twin (ops/kernels.py:_level_ops).

#pragma once

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace mg {

constexpr int kTH = 32;                  // owned rows per block
constexpr int kTW = 64;                  // owned columns per block
constexpr int kHalo = 8;                 // staged ring on each side
constexpr int kRows = kTH + 2 * kHalo;   // 48
constexpr int kCols = kTW + 2 * kHalo;   // 80
constexpr int kThreads = 256;

struct Level {
  int h, w;                // true domain at the slab's origin
  int uniform;             // bh == bw == 1: the plain 5-point operator
  float cuh, cuw;          // 2/(1+beta) - 1: last row / column neighbour weight
  float dh, dw;            // 2/beta: last row / column diagonal half
};

using Tile = float[kRows][kCols];

__device__ __forceinline__ bool in_domain(const Level& L, int gr, int gc) {
  return gr >= 0 && gr < L.h && gc >= 0 && gc < L.w;
}

__device__ __forceinline__ float nsum(const Tile& s, const Level& L, int lr,
                                      int lc, int gr, int gc) {
  const float up = s[lr - 1][lc], dn = s[lr + 1][lc];
  const float lf = s[lr][lc - 1], rt = s[lr][lc + 1];
  float n = ((up + dn) + lf) + rt;
  if (!L.uniform) {
    const float lrow = gr == L.h - 1 ? L.cuh : 0.0f;
    const float lcol = gc == L.w - 1 ? L.cuw : 0.0f;
    n = (n + lrow * up) + lcol * lf;
  }
  return n;
}

__device__ __forceinline__ float diag(const Level& L, int gr, int gc) {
  if (L.uniform) return 4.0f;
  return (gr == L.h - 1 ? L.dh : 2.0f) + (gc == L.w - 1 ? L.dw : 2.0f);
}

__device__ __forceinline__ float inv_diag(const Level& L, int gr, int gc) {
  return L.uniform ? 0.25f : 1.0f / diag(L, gr, gc);
}

// Stage x[c] (a (hp, wp) slab) around the tile whose (0, 0) ring point is
// global (gr0, gc0); points off the slab are 0. x == nullptr stages zeros.
__device__ __forceinline__ void stage(Tile& s, const float* __restrict__ x,
                                      int hp, int wp, int gr0, int gc0) {
  for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
    const int lr = i / kCols, lc = i % kCols;
    const int gr = gr0 + lr, gc = gc0 + lc;
    float v = 0.0f;
    if (x != nullptr && gr >= 0 && gr < hp && gc >= 0 && gc < wp)
      v = x[(size_t)gr * wp + gc];
    s[lr][lc] = v;
  }
}

// One half-sweep of colour `color` (0 red: (row + col) even) over the inner
// points: u <- (nsum(u) - g) * inv_d, or (0 - g) * inv_d for a known-zero
// guess. gr0 and gc0 are even, so a point's colour is that of (lr + lc).
// Ends with __syncthreads().
__device__ __forceinline__ void half_sweep(Tile& su, const Tile& sg,
                                           const Level& L, int gr0, int gc0,
                                           int color, bool zero_guess) {
  constexpr int kHalf = (kCols - 2) / 2;  // points of one colour per row
  for (int i = threadIdx.x; i < (kRows - 2) * kHalf; i += kThreads) {
    const int lr = 1 + i / kHalf;
    const int lc = 1 + 2 * (i % kHalf) + ((color + lr + 1) & 1);
    const int gr = gr0 + lr, gc = gc0 + lc;
    if (!in_domain(L, gr, gc)) continue;
    const float n = zero_guess ? 0.0f : nsum(su, L, lr, lc, gr, gc);
    su[lr][lc] = (n - sg[lr][lc]) * inv_diag(L, gr, gc);
  }
  __syncthreads();
}

__device__ __forceinline__ void sweeps(Tile& su, const Tile& sg,
                                       const Level& L, int gr0, int gc0, int n,
                                       bool zero_guess) {
  for (int k = 0; k < n; ++k) {
    half_sweep(su, sg, L, gr0, gc0, 0, zero_guess && k == 0);
    half_sweep(su, sg, L, gr0, gc0, 1, false);
  }
}

// Write the owned kTH x kTW tile of s into x[c] (rows < hp, cols < wp).
__device__ __forceinline__ void store(const Tile& s, float* __restrict__ x,
                                      int hp, int wp, int r0, int c0) {
  for (int i = threadIdx.x; i < kTH * kTW; i += kThreads) {
    const int rr = i / kTW, cc = i % kTW;
    const int gr = r0 + rr, gc = c0 + cc;
    if (gr < hp && gc < wp) x[(size_t)gr * wp + gc] = s[kHalo + rr][kHalo + cc];
  }
}

}  // namespace mg

// -- the ascent's tile (mg_up.cu) ------------------------------------------
//
// mg_up's block stages u, g and the tile's rows of the coarse correction
// with asynchronous copies, and sweeps a region that shrinks by one point a
// half-sweep (only points whose value can still reach the owned tile are
// updated). The helpers above stay as mg_down and rb_sweeps_tile use them.

namespace mg {

// A tile of kTH owned rows and 64 - 2 kRing owned columns with a kRing-deep
// ring (even, >= the half-sweeps it runs); 64 staged columns (32 lanes cover
// one colour of a row).
template <int kRing>
struct UpTile {
  static constexpr int kR = kRing;
  static constexpr int kTH = 32;
  static constexpr int kCols = 64;
  static constexpr int kTW = kCols - 2 * kRing;
  static constexpr int kRows = kTH + 2 * kRing;
  static constexpr int kERows = kRows / 2 + 1;  // correction rows q-1 .. of the staged rows
  static constexpr int kLanes = kCols / 2;      // threads over one colour of a row
};

// Issue the copies of x's rows [gr0, gr0 + kR) x columns [gc0, gc0 + kC)
// (row stride ld) into s (kR x kC); points outside rows [0, rows) x columns
// [0, cols) are zero-filled. vec: 16-byte copies (gc0, ld, cols and x's base
// multiples of 4 floats), else 4-byte ones.
template <int kR, int kC, int kThr>
__device__ __forceinline__ void stage_async(float* s, const float* __restrict__ x, int rows,
                                            int cols, int ld, int gr0, int gc0, bool vec) {
  if (vec) {
    constexpr int kChunks = kC / 4;
    for (int i = threadIdx.x; i < kR * kChunks; i += kThr) {
      const int lr = i / kChunks, ch = i % kChunks;
      const int gr = gr0 + lr, gc = gc0 + 4 * ch;
      const bool ok = gr >= 0 && gr < rows && gc >= 0 && gc < cols;
      acp::copy16(s + lr * kC + 4 * ch, ok ? x + (size_t)gr * ld + gc : x, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kR * kC; i += kThr) {
      const int lr = i / kC, lc = i % kC;
      const int gr = gr0 + lr, gc = gc0 + lc;
      const bool ok = gr >= 0 && gr < rows && gc >= 0 && gc < cols;
      acp::copy4(s + i, ok ? x + (size_t)gr * ld + gc : x, ok);
    }
  }
}

// The level operator on a staged tile of kC columns: nsum and inv_diag of
// the helpers above, the same arithmetic.
template <int kC>
__device__ __forceinline__ float nsum_t(const float* s, const Level& L, int lr, int lc,
                                        int gr, int gc) {
  const float up = s[(lr - 1) * kC + lc], dn = s[(lr + 1) * kC + lc];
  const float lf = s[lr * kC + lc - 1], rt = s[lr * kC + lc + 1];
  float n = ((up + dn) + lf) + rt;
  if (!L.uniform) {
    const float lrow = gr == L.h - 1 ? L.cuh : 0.0f;
    const float lcol = gc == L.w - 1 ? L.cuw : 0.0f;
    n = (n + lrow * up) + lcol * lf;
  }
  return n;
}

// The staged rows / columns [lo, hi) of the global band [g_lo, g_hi), cut to
// the domain [0, n) and to the staged points [1, k - 1) whose neighbours are
// staged. g0: the global index of staged point 0.
__device__ __forceinline__ void band(int g_lo, int g_hi, int n, int g0, int k, int& lo,
                                     int& hi) {
  lo = max(max(g_lo, 0) - g0, 1);
  hi = min(min(g_hi, n) - g0, k - 1);
}

// inv_diag's four values (the interior, the last column, the last row, the
// corner), each computed once per block as inv_diag does, so a sweep point
// selects its factor instead of dividing.
struct InvDiag {
  float in, col, row, both;  // interior, last column, last row, the corner
  __device__ __forceinline__ explicit InvDiag(const Level& L)
      : in(L.uniform ? 0.25f : 1.0f / (2.0f + 2.0f)),
        col(L.uniform ? 0.25f : 1.0f / (2.0f + L.dw)),
        row(L.uniform ? 0.25f : 1.0f / (L.dh + 2.0f)),
        both(L.uniform ? 0.25f : 1.0f / (L.dh + L.dw)) {}
  __device__ __forceinline__ float at(const Level& L, int gr, int gc) const {
    const bool lc = gc == L.w - 1;
    return gr == L.h - 1 ? (lc ? both : row) : (lc ? col : in);
  }
};

// One half-sweep of colour `color` over the owned tile widened by d on every
// side: u <- (nsum(u) - g) * inv_d, one point a thread. Ends with
// __syncthreads().
template <class T, int kThr>
__device__ __forceinline__ void half_sweep_band(float* su, const float* sg, const Level& L,
                                                const InvDiag& inv, int r0, int c0, int color,
                                                int d) {
  const int gr0 = r0 - T::kR, gc0 = c0 - T::kR;
  int rlo, rhi, clo, chi;
  band(r0 - d, r0 + T::kTH + d, L.h, gr0, T::kRows, rlo, rhi);
  band(c0 - d, c0 + T::kTW + d, L.w, gc0, T::kCols, clo, chi);
  constexpr int kRowsPerPass = kThr / T::kLanes;
  const int j = threadIdx.x % T::kLanes;
  for (int lr = rlo + threadIdx.x / T::kLanes; lr < rhi; lr += kRowsPerPass) {
    const int lc = 2 * j + ((color + lr) & 1);  // gr0, gc0 even: colour = (lr + lc) % 2
    if (lc < clo || lc >= chi) continue;
    const int gr = gr0 + lr, gc = gc0 + lc;
    const float n = nsum_t<T::kCols>(su, L, lr, lc, gr, gc);
    su[lr * T::kCols + lc] = (n - sg[lr * T::kCols + lc]) * inv.at(L, gr, gc);
  }
  __syncthreads();
}

}  // namespace mg
