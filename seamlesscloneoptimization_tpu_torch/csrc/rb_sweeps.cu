// rb_sweeps: up to 4 red-black Gauss-Seidel sweeps of the 5-point Dirichlet
// Laplacian on exact-size (C, H, W) f32 arrays, in one pass.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:
// rb_sweeps_pallas (launches _rb_launch and _rb_launch_b, bodies _rb_body and
// _rb_sweep_loop). The wrapper (ops/kernels.py:rb_sweeps) runs k sweeps as
// ceil(k / 4) launches, as the TPU function does.
//
// One sweep is the red half, then the black half (red: (row + col) even),
// each u <- (nsum(u) - g) * 0.25 on its colour with
// nsum = ((up + dn) + lf) + rt and a zero frame around the (H, W) domain:
// the select form of solvers/jacobi.py:redblack_sweep, whose k calls are the
// plain twin. Built with -fmad=false, every operation rounds as the twin's
// separate ops do, so the kernel is bit-equal to it.
//
// Bound on this card: bytes. u and g read once, u written once per launch:
// 12 bytes per point, 133.5 MB at the headline interior 3 x 1548 x 2396
// (0.040 ms at 3.35 TB/s); 6 flops per point and sweep. Design: the level
// machinery of mg_level.cuh with the plain operator (bh = bw = 1) on a slab
// that is the array itself (hp = H, wp = W: no padding, any H and W). A block
// owns a 32 x 64 tile of one channel, stages u and g with the 8-deep ring in
// shared memory (48 x 80 each), runs the sweeps there with __syncthreads()
// between half-sweeps, and stores its owned tile into a second buffer (the
// neighbouring blocks still read the input). The ring's 8 layers cover 8
// half-sweeps, so a launch runs at most 4 sweeps; it costs 1.9x the owned
// points in staging reads and sweep work: simple and right first.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include "mg_level.cuh"

namespace {

using namespace mg;

__global__ void __launch_bounds__(kThreads)
rb_sweeps_kernel(const float* __restrict__ u, const float* __restrict__ g,
                 float* __restrict__ out, int h, int w, int n) {
  __shared__ Tile su;
  __shared__ Tile sg;

  const size_t plane = (size_t)h * w;
  const int c = blockIdx.z;
  const int r0 = blockIdx.y * kTH, c0 = blockIdx.x * kTW;
  const int gr0 = r0 - kHalo, gc0 = c0 - kHalo;  // even: colours follow (lr + lc)
  stage(su, u + c * plane, h, w, gr0, gc0);
  stage(sg, g + c * plane, h, w, gr0, gc0);
  __syncthreads();
  const Level L{h, w, 1, 0.0f, 0.0f, 0.0f, 0.0f};
  sweeps(su, sg, L, gr0, gc0, n, false);
  store(su, out + c * plane, h, w, r0, c0);
}

}  // namespace

// u, g, out: (c, h, w) f32 contiguous, out not aliasing u; 1 <= n <= 4.
extern "C" int rb_sweeps_launch(const void* u, const void* g, void* out, int c,
                                int h, int w, int n, void* stream) {
  if (c <= 0 || h <= 0 || w <= 0) return 0;
  const dim3 grid((w + kTW - 1) / kTW, (h + kTH - 1) / kTH, c);
  rb_sweeps_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(g),
      static_cast<float*>(out), h, w, n);
  return static_cast<int>(cudaGetLastError());
}
