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
