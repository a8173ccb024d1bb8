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
// 6 flops per point and sweep. Design: the level machinery of mg_level.cuh.
// A block owns a 32 x 64 tile of one channel, stages u and g with the
// 8-deep ring in shared memory (48 x 80 each), sweeps there with
// __syncthreads() between half-sweeps and stores its owned tile into a
// second buffer (the neighbouring blocks still read the input). Two things
// differ from mg_level.cuh's half_sweep: the colour carries the origin's
// parity (half_sweep assumes an even origin; a block's staged origin is even
// in LOCAL coordinates, so a point's global colour is that of
// lr + lc + parity), and the update test is the rectangle above instead of
// mg::Level's domain at the origin. The ring's 8 layers cover 8
// half-sweeps, so a launch runs at most 4 sweeps; it costs 1.9x the owned
// points in staging reads and sweep work: simple and right first.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include "mg_level.cuh"

namespace {

using namespace mg;

struct Rect {
  int r_lo, r_hi, c_lo, c_hi;  // updated local points
};

// One half-sweep of the points whose (lr + lc) parity is `want` over the
// staged tile's inner points; (lr0, lc0) is the local coordinate of staged
// point (0, 0). Ends with __syncthreads().
__device__ __forceinline__ void half_sweep_tile(Tile& su, const Tile& sg, int lr0,
                                                int lc0, const Rect& R, int want) {
  constexpr int kHalf = (kCols - 2) / 2;  // points of one colour per row
  for (int i = threadIdx.x; i < (kRows - 2) * kHalf; i += kThreads) {
    const int lr = 1 + i / kHalf;
    const int lc = 1 + 2 * (i % kHalf) + ((want + lr + 1) & 1);
    const int r = lr0 + lr, c = lc0 + lc;
    if (r < R.r_lo || r >= R.r_hi || c < R.c_lo || c >= R.c_hi) continue;
    const float n = ((su[lr - 1][lc] + su[lr + 1][lc]) + su[lr][lc - 1]) + su[lr][lc + 1];
    su[lr][lc] = (n - sg[lr][lc]) * 0.25f;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
rb_sweeps_tile_kernel(const float* __restrict__ u, const float* __restrict__ g,
                      float* __restrict__ out, int hl, int wl, int n, Rect R,
                      int parity) {
  __shared__ Tile su;
  __shared__ Tile sg;

  const size_t plane = (size_t)hl * wl;
  const int c = blockIdx.z;
  const int r0 = blockIdx.y * kTH, c0 = blockIdx.x * kTW;
  const int lr0 = r0 - kHalo, lc0 = c0 - kHalo;  // even: parity carries the origin's
  stage(su, u + c * plane, hl, wl, lr0, lc0);
  stage(sg, g + c * plane, hl, wl, lr0, lc0);
  __syncthreads();
  for (int k = 0; k < n; ++k) {
    half_sweep_tile(su, sg, lr0, lc0, R, parity);      // red: global (row + col) even
    half_sweep_tile(su, sg, lr0, lc0, R, parity ^ 1);  // black
  }
  store(su, out + c * plane, hl, wl, r0, c0);
}

}  // namespace

// u, g, out: (c, hl, wl) f32 contiguous, out not aliasing u; 1 <= n <= 4.
// [r_lo, r_hi) x [c_lo, c_hi): the local points inside the buffer and the
// global domain (possibly empty); parity: (org_r + org_c) mod 2.
extern "C" int rb_sweeps_tile_launch(const void* u, const void* g, void* out, int c,
                                     int hl, int wl, int n, int r_lo, int r_hi,
                                     int c_lo, int c_hi, int parity, void* stream) {
  if (c <= 0 || hl <= 0 || wl <= 0) return 0;
  const dim3 grid((wl + kTW - 1) / kTW, (hl + kTH - 1) / kTH, c);
  rb_sweeps_tile_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(g),
      static_cast<float*>(out), hl, wl, n, Rect{r_lo, r_hi, c_lo, c_hi}, parity);
  return static_cast<int>(cudaGetLastError());
}
