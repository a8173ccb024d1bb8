// rb_sweeps_tile: up to 4 red-black Gauss-Seidel sweeps of the 5-point
// Laplacian on a (C, hl, wl) f32 array whose colours and Dirichlet domain
// are given in GLOBAL coordinates, in one pass. Two wrappers launch it:
//
// - ops/kernels.py:rb_sweeps_tile, on one ghosted tile of a domain
//   decomposition. Replaces seamlesscloneoptimization_tpu/ops/
//   pallas_kernels.py: rb_sweeps_tile_pallas (body _rb_tile_kernel).
// - ops/kernels.py:rb_sweeps, on an exact-size array: origin (0, 0), the
//   whole array as the domain (the zero frame of solvers/jacobi.py's
//   redblack_sweep). Replaces pallas_kernels.py: rb_sweeps_pallas (launches
//   _rb_launch and _rb_launch_b, bodies _rb_body and _rb_sweep_loop).
//
// Both run k sweeps as ceil(k / 4) launches, as the TPU functions do.
//
// The window form (template kWin, entry rb_sweeps_tile_window_launch): u
// and g are windows of larger arrays, each with its own channel and row
// strides (the last stride 1), read where they lie, and the output is a
// dense (C, hl, wl) buffer. parallel/tiled.py's interior-first schedule
// sweeps four bands of each ghosted tile this way (two of them column
// bands, whose rows are tw + 2k apart), so no band is copied. The dense
// form is the same template with the strides of a dense array, the code of
// the two forms otherwise one.
//
// In: u, g (C, hl, wl) f32 whose local (0, 0) sits at global (org_r, org_c)
// (negative on tiles with a ghost band above or left of the domain). A
// point is updated only inside the local buffer AND inside the global
// domain [0, Ht) x [0, Wt); the host folds the two tests into one local
// rectangle [r_lo, r_hi) x [c_lo, c_hi). Points outside the buffer read as
// 0 (the twins' zero pad); points of the buffer outside the domain keep
// their input. Colour: red where global (row + col) is even; the host
// passes parity = (org_r + org_c) mod 2. One sweep is the red half, then
// the black half, each u <- (nsum(u) - g) * 0.25 with
// nsum = ((up + dn) + lf) + rt: the select form of parallel/tiled.py's
// sweep_region (twin: rb_sweeps_tile_plain) and of redblack_sweep (twin:
// rb_sweeps_plain). Built with -fmad=false, every operation rounds as the
// twins' separate ops do, so the kernel is bit-equal to them.
//
// Bound on this card: bytes. u and g read once, u written once per launch:
// 12 bytes per point, 97.2 MB at the 8K DD tile 3 x 1412 x 1912 (a 2x2 mesh
// over the 2800 x 3800 padded interior, 6-px ghost band; 0.0290 ms at
// 3.35 TB/s), 133.5 MB at the headline interior 3 x 1548 x 2396 (0.040 ms);
// 6 flops per point and sweep.
//
// The first design (mg_level.cuh's 32 x 64 tile with an 8-deep ring at every
// sweep count, synchronous scalar staging through an i / kCols division,
// every half-sweep over the whole inner ring through an i / 39 division,
// scalar stores) took 0.187-0.193 ms for 4 sweeps at the headline and
// 0.099-0.119 for the DD tile's 2 (PERF.md section 6). A second one (this
// file's ring and band, the warps walking strips of the band in shared
// memory) took 0.114 in a burst: a warp row cost ~7.5 shared-memory
// wavefronts (the stride-2 colour column of g and of the store among them),
// and the shared-memory pipe bound it. This design keeps the sweep in
// registers; it takes 0.072 ms a launch in the headline jacobi loop and
// 0.039 in the 8K DD loop (PERF.md section 6, H100 80GB HBM3 at 700 W),
// bound by instruction issue (~160 a warp a half-sweep):
//
// - The ring follows the launch. The kernel is templated on the launch's
//   sweep count n (1-4); its 2 n half-sweeps need a ring of 2 n points: kRr
//   = 2 n rows above and below the owned tile, kRc = 2 n rounded up to 4
//   columns left and right, so that the staged columns start on a 16-byte
//   chunk. A block stages kRows = 50 rows x 128 columns of one channel and
//   owns kTH = 50 - 4 n rows (46, 42, 38, 34) x kTW = 128 - 2 kRc columns
//   (120 for n <= 2, 112 for n = 3, 4): 1.16x its owned points at n = 1,
//   1.47x at n = 4 (a neighbour's owned points: mostly L2 hits).
// - Asynchronous staging: u with mg_level.cuh's stage_async, 16-byte
//   cp.async copies where wl % 4 == 0 and the bases are 16-byte aligned
//   (the staged columns start at c0 - kRc, a multiple of 4), 4-byte ones
//   otherwise (the 8K interior's 3798 columns, odd grids), zero fill off
//   the buffer (the twin's zero pad), one copy group. g is read only at
//   the points a lane updates, each once a launch, so it goes from device
//   memory straight into the lane's registers (float2 loads where aligned)
//   while u lands.
// - Registers, not shared memory, hold the sweep. Warp w owns the fixed
//   strip of staged rows [1 + 6 w, 7 + 6 w) (8 strips of kL = 6 cover rows
//   1 .. kRows - 2) over all 128 columns; lane j owns the column pairs
//   A = (2 j, 2 j + 1) and B = (64 + 2 j, 65 + 2 j), and keeps them for its 6
//   rows and the rows above and below (32 floats of u, 24 of g). In each
//   row of a half-sweep a pair holds one point of the colour (at column
//   parity p = colour ^ parity ^ row) and one of the other; up and dn are
//   the rows above and below at p, one side the pair's other point, the
//   other side the neighbour lane's by a shuffle (two a row: lane 0's B
//   takes lane 31's A, lane 31's A lane 0's B, from the same shuffles). No
//   division, no shared memory in the sweep: per point 4 adds, a subtract
//   and a multiply, and a shuffle for two points.
// - Between half-sweeps the strips swap their edge rows through shared
//   memory: each warp writes its first and last row into one of two
//   exchange slots (alternating, so one __syncthreads() a half-sweep
//   suffices), then reads its neighbours' into its rows above and below.
//   Strips 0 and 7 border the staged rows 0 and kRows - 1, which are never
//   updated.
// - A shrinking band: half-sweep k of 2 n updates only the points within
//   d = 2 n - k of the owned tile (the only ones whose values still reach
//   it; mg::band / half_sweep_band's idea), cut by the Rect and by the
//   staged points [1, kRows - 1) x [1, 127) whose neighbours are staged
//   (every staged row outside the first and last). A row outside the
//   band is skipped by the whole warp, a column by a predicate. The ring's
//   outer points are never written, so every updated point reads exact
//   values.
// - The colour of staged point (sr, sc) is that of (sr + sc + parity): the
//   staged origin (by kTH - kRr, bx kTW - kRc) is even in local coordinates,
//   and parity carries the global origin's (half_sweep_band assumes an even
//   global origin; a DD tile's origin can be odd). A strip starts on an odd
//   row, so the colour's parity of a strip's first row is the same in every
//   warp: two instantiations of the row loop, chosen a half-sweep.
// - The store: each warp writes its rows back into the staged tile, then
//   the owned rows go into the second buffer that _rb_burst
//   (ops/kernels.py) ping-pongs (the kernel never writes in place:
//   neighbouring blocks still read the input), a warp a row, one float4 a
//   lane where wl % 4 == 0 and the output is 16-byte aligned, scalar
//   stores otherwise.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include <stdint.h>

#include "mg_level.cuh"  // mg::stage_async, acp:: (the header is unchanged)

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 128;              // staged columns: pairs A (j) and B (32 + j) a lane
constexpr int kPairs = kCols / 2;
constexpr int kL = 6;                   // rows a warp's strip
constexpr int kRows = kWarps * kL + 2;  // staged rows: the strips and rows 0, kRows - 1

// The geometry of an n-sweep launch.
template <int kN>
struct Geom {
  static constexpr int kRr = 2 * kN;                // ring rows above and below
  static constexpr int kRc = (2 * kN + 3) / 4 * 4;  // ring columns: whole 16-byte chunks
  static constexpr int kTH = kRows - 2 * kRr;       // owned rows
  static constexpr int kTW = kCols - 2 * kRc;       // owned columns
};

struct Rect {
  int r_lo, r_hi, c_lo, c_hi;  // updated local points
};

struct Smem {
  float u[kRows][kCols];
  float2 ex[2][kWarps][2][kPairs];  // [slot][strip][first, last row][pair]
};

// The window form's input strides, in floats (unused by the dense form).
struct Win {
  long long u_plane, g_plane;
  int u_ld, g_ld;
};

// A lane's rows: pair q (0: A, 1: B) of rows a - 1 .. a + kL in rv, of rows
// a .. a + kL - 1 in gv.
using RowsU = float2[kL + 2][2];
using RowsG = float2[kL][2];

__device__ __forceinline__ float& at(float2& v, int p) { return p ? v.y : v.x; }
__device__ __forceinline__ float at(const float2& v, int p) { return p ? v.y : v.x; }

// One half-sweep of the strip's rows whose staged row lies in [rlo, rhi);
// kP0: the colour's column parity in the strip's first row. ok[q][p]: the
// lane's column 64 q + 2 j + p lies in the band.
template <int kP0>
__device__ __forceinline__ void sweep_rows(RowsU& rv, const RowsG& gv, int a, int rlo,
                                           int rhi, const bool (&ok)[2][2], int lane) {
#pragma unroll
  for (int i = 0; i < kL; ++i) {
    const int p = kP0 ^ (i & 1);
    const int r = a + i;
    if (r < rlo || r >= rhi) continue;  // warp-uniform
    float side[2];  // the neighbour lane's other point of pairs A and B
    if (p == 0) {   // lf: lane j - 1's y; lane 0's B: lane 31's A.y (column 63)
      const float sa = __shfl_sync(0xffffffffu, rv[i + 1][0].y, (lane + 31) & 31);
      const float sb = __shfl_sync(0xffffffffu, rv[i + 1][1].y, (lane + 31) & 31);
      side[0] = sa;
      side[1] = lane == 0 ? sa : sb;
    } else {        // rt: lane j + 1's x; lane 31's A: lane 0's B.x (column 64)
      const float sa = __shfl_sync(0xffffffffu, rv[i + 1][0].x, (lane + 1) & 31);
      const float sb = __shfl_sync(0xffffffffu, rv[i + 1][1].x, (lane + 1) & 31);
      side[0] = lane == 31 ? sb : sa;
      side[1] = sb;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float up = at(rv[i][q], p), dn = at(rv[i + 2][q], p);
      const float lf = p ? rv[i + 1][q].x : side[q];
      const float rt = p ? side[q] : rv[i + 1][q].y;
      const float n = ((up + dn) + lf) + rt;
      const float v = (n - at(gv[i][q], p)) * 0.25f;
      if (ok[q][p]) at(rv[i + 1][q], p) = v;
    }
  }
}

// g at local (lr, lc), (lr, lc + 1) (lc even), 0 off the buffer; ld: g's row
// stride.
__device__ __forceinline__ float2 load_g(const float* __restrict__ g, int hl, int wl, int ld,
                                         int lr, int lc, bool vec) {
  if (lr < 0 || lr >= hl || lc < 0 || lc >= wl) return make_float2(0.0f, 0.0f);
  const float* p = g + (size_t)lr * ld + lc;
  if (vec) return __ldg(reinterpret_cast<const float2*>(p));  // lc + 1 < wl: wl % 4 == 0
  return make_float2(__ldg(p), lc + 1 < wl ? __ldg(p + 1) : 0.0f);
}

template <int kN, bool kWin>
__global__ void __launch_bounds__(kThreads, 3)
rb_sweeps_tile_kernel(const float* __restrict__ u, const float* __restrict__ g,
                      float* __restrict__ out, int hl, int wl, Rect R, int parity, bool vec,
                      Win W) {
  using G = Geom<kN>;
  __shared__ __align__(16) Smem s;

  const size_t plane = (size_t)hl * wl;  // out's (and the dense form's u and g)
  const size_t u_plane = kWin ? (size_t)W.u_plane : plane;
  const size_t g_plane = kWin ? (size_t)W.g_plane : plane;
  const int u_ld = kWin ? W.u_ld : wl, g_ld = kWin ? W.g_ld : wl;
  const int ch = blockIdx.z;
  const int r0 = blockIdx.y * G::kTH, c0 = blockIdx.x * G::kTW;
  const int lr0 = r0 - G::kRr, lc0 = c0 - G::kRc;  // even: parity carries the origin's
  mg::stage_async<kRows, kCols, kThreads>(&s.u[0][0], u + ch * u_plane, hl, wl, u_ld, lr0,
                                          lc0, vec);
  acp::commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int a = 1 + warp * kL;  // the strip's first staged row (odd)
  RowsG gv;
#pragma unroll
  for (int i = 0; i < kL; ++i)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      gv[i][q] = load_g(g + ch * g_plane, hl, wl, g_ld, lr0 + a + i, lc0 + 64 * q + 2 * lane,
                        vec);
  acp::wait<0>();
  __syncthreads();
  RowsU rv;
#pragma unroll
  for (int i = 0; i < kL + 2; ++i)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      rv[i][q] = *reinterpret_cast<const float2*>(&s.u[a - 1 + i][64 * q + 2 * lane]);

#pragma unroll 1
  for (int k = 1; k <= 2 * kN; ++k) {  // red (odd k), then black; band 2 n - k
    const int want = (k - 1) & 1, d = 2 * kN - k;
    const int rlo = max(max(G::kRr - d, R.r_lo - lr0), 1);
    const int rhi = min(min(G::kRr + G::kTH + d, R.r_hi - lr0), kRows - 1);
    const int clo = max(max(G::kRc - d, R.c_lo - lc0), 1);
    const int chi = min(min(G::kRc + G::kTW + d, R.c_hi - lc0), kCols - 1);
    bool ok[2][2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int c = 64 * q + 2 * lane + p;
        ok[q][p] = c >= clo && c < chi;
      }
    if ((want ^ parity ^ a) & 1)
      sweep_rows<1>(rv, gv, a, rlo, rhi, ok, lane);
    else
      sweep_rows<0>(rv, gv, a, rlo, rhi, ok, lane);
    if (k < 2 * kN) {  // swap edge rows with the neighbouring strips
      const int slot = k & 1;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        s.ex[slot][warp][0][32 * q + lane] = rv[1][q];
        s.ex[slot][warp][1][32 * q + lane] = rv[kL][q];
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (warp > 0) rv[0][q] = s.ex[slot][warp - 1][1][32 * q + lane];
        if (warp < kWarps - 1) rv[kL + 1][q] = s.ex[slot][warp + 1][0][32 * q + lane];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kL; ++i)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      *reinterpret_cast<float2*>(&s.u[a + i][64 * q + 2 * lane]) = rv[i + 1][q];
  __syncthreads();

  float* o = out + ch * plane;
  for (int rr = warp; rr < G::kTH; rr += kWarps) {
    const int gr = r0 + rr;
    if (gr >= hl) break;
    const float* srow = &s.u[G::kRr + rr][G::kRc];
    float* orow = o + (size_t)gr * wl + c0;
    if (vec) {
      if (lane < G::kTW / 4 && c0 + 4 * lane < wl)
        *reinterpret_cast<float4*>(orow + 4 * lane) =
            *reinterpret_cast<const float4*>(srow + 4 * lane);
    } else {
      for (int cc = lane; cc < G::kTW && c0 + cc < wl; cc += 32) orow[cc] = srow[cc];
    }
  }
}

template <int kN, bool kWin>
void launch(const float* u, const float* g, float* out, int c, int hl, int wl, Rect R,
            int parity, bool vec, Win W, cudaStream_t st) {
  using G = Geom<kN>;
  const dim3 grid((wl + G::kTW - 1) / G::kTW, (hl + G::kTH - 1) / G::kTH, c);
  rb_sweeps_tile_kernel<kN, kWin><<<grid, kThreads, 0, st>>>(u, g, out, hl, wl, R, parity,
                                                              vec, W);
}

template <bool kWin>
int launch_n(const void* u, const void* g, void* out, int c, int hl, int wl, int n, Rect R,
             int parity, bool vec, Win W, void* stream) {
  const auto* uf = static_cast<const float*>(u);
  const auto* gf = static_cast<const float*>(g);
  auto* of = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: launch<1, kWin>(uf, gf, of, c, hl, wl, R, parity, vec, W, st); break;
    case 2: launch<2, kWin>(uf, gf, of, c, hl, wl, R, parity, vec, W, st); break;
    case 3: launch<3, kWin>(uf, gf, of, c, hl, wl, R, parity, vec, W, st); break;
    case 4: launch<4, kWin>(uf, gf, of, c, hl, wl, R, parity, vec, W, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// u, g, out: (c, hl, wl) f32 contiguous, out not aliasing u; 1 <= n <= 4
// (cudaErrorInvalidValue otherwise). [r_lo, r_hi) x [c_lo, c_hi): the local
// points inside the buffer and the global domain (possibly empty); parity:
// (org_r + org_c) mod 2.
extern "C" int rb_sweeps_tile_launch(const void* u, const void* g, void* out, int c,
                                     int hl, int wl, int n, int r_lo, int r_hi,
                                     int c_lo, int c_hi, int parity, void* stream) {
  if (c <= 0 || hl <= 0 || wl <= 0) return 0;
  const bool vec = wl % 4 == 0 && aligned(u) && aligned(g) && aligned(out);
  return launch_n<false>(u, g, out, c, hl, wl, n, Rect{r_lo, r_hi, c_lo, c_hi}, parity, vec,
                         Win{}, stream);
}

// The window form: u, g (c, hl, wl) windows whose channel c and row r start
// u_plane * c + u_ld * r (g_plane, g_ld) floats past the pointer, with
// u_ld, g_ld >= wl; out (c, hl, wl) dense, aliasing neither. The other
// arguments as above. 16-byte copies only where every row of both windows
// and of out starts on 16 bytes.
extern "C" int rb_sweeps_tile_window_launch(const void* u, const void* g, void* out, int c,
                                            int hl, int wl, int n, int r_lo, int r_hi,
                                            int c_lo, int c_hi, int parity,
                                            long long u_plane, int u_ld, long long g_plane,
                                            int g_ld, void* stream) {
  if (c <= 0 || hl <= 0 || wl <= 0) return 0;
  if (u_ld < wl || g_ld < wl) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = wl % 4 == 0 && u_ld % 4 == 0 && g_ld % 4 == 0 && u_plane % 4 == 0 &&
                   g_plane % 4 == 0 && aligned(u) && aligned(g) && aligned(out);
  return launch_n<true>(u, g, out, c, hl, wl, n, Rect{r_lo, r_hi, c_lo, c_hi}, parity, vec,
                        Win{u_plane, g_plane, u_ld, g_ld}, stream);
}
