// unfold_minor: the inverse even/odd combine of the folded DST along the
// minor axis.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:
// unfold_minor_pallas (bodies _unfold_kernel, _unfold_body). It ends each
// folded axis's inverse on the per-axis branch, and the pair chain when the
// caller asks for the natural-order solution (no return_parts).
//
// For each of the R = C*M rows of e and o (width ep): out[x] = unfold_at(e,
// o, n, x) of fold.cuh for x < out_pad, exact zeros on [n, out_pad).
//
// Bound on this card: bytes. One f32 read of the he data lanes of e and of
// o and one f32 write of the out_pad output lanes per row. Design: one
// thread per output lane, threads along the row; the reversed half reads a
// contiguous run backwards, as in fold_minor.cu.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fold.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kRows = 4;

__global__ void unfold_minor_kernel(const float* __restrict__ e,
                                    const float* __restrict__ o,
                                    float* __restrict__ out, int rows, int ep,
                                    int n, int out_pad) {
  const int x = blockIdx.y * kLanes + threadIdx.x;
  const int row = blockIdx.x * kRows + threadIdx.y;
  if (x >= out_pad || row >= rows) return;
  const size_t base = (size_t)row * ep;
  out[(size_t)row * out_pad + x] = unfold_at(e + base, o + base, n, x);
}

}  // namespace

// e, o: (rows, ep) f32 contiguous; out: (rows, out_pad).
extern "C" int unfold_minor_launch(const void* e, const void* o, void* out,
                                   int rows, int ep, int n, int out_pad,
                                   void* stream) {
  if (rows <= 0 || out_pad <= 0) return 0;
  const dim3 block(kLanes, kRows);
  const dim3 grid((rows + kRows - 1) / kRows, (out_pad + kLanes - 1) / kLanes);
  unfold_minor_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(e), static_cast<const float*>(o),
      static_cast<float*>(out), rows, ep, n, out_pad);
  return static_cast<int>(cudaGetLastError());
}
