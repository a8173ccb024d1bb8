// fold_minor: the even/odd fold of the folded DST along the minor axis.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:fold_minor_pallas
// (body _fold_kernel). The folded chain runs it before each forward pair of
// half-GEMMs: twice a frame on the pair chain, once per folded axis on the
// per-axis branch.
//
// For each of the R = C*M rows of x (width np_, data on lanes [0, n)):
//   s[j] = x[j] + x[n-1-j], d[j] = x[j] - x[n-1-j]   for j < ho = n/2,
//   s[he-1] = x[he-1]                                for odd n (the middle,
//                                                     counted once),
// and exact zeros on every other lane of s (width ep) and d (width op). The
// TPU kernel leaves finite garbage beyond he/ho, which the zero rows of the
// folded factors absorb; here the outputs come from torch.empty and could
// hold NaN, and NaN * 0 is NaN, so every lane is written.
//
// Bound on this card: bytes. One f32 read of the n data lanes and one f32
// write of the ep + op output lanes per row (45 MB read + 52 MB written on
// the (3, 2432, 1664) headline slab, n = 1548). Design: one thread per output lane,
// threads along the row. The head read x[j] is coalesced; the tail read
// x[n-1-j] of a warp is one contiguous run walked backwards, which the
// memory system serves as the same few sectors. No shared memory: the TPU's
// anti-identity matmul and roll (Mosaic has no lane reversal) become index
// arithmetic.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;  // blockDim.x: output lanes per block
constexpr int kRows = 4;     // blockDim.y: rows per block

__global__ void fold_minor_kernel(const float* __restrict__ x,
                                  float* __restrict__ s, float* __restrict__ d,
                                  int rows, int np_, int n, int ep, int op) {
  const int j = blockIdx.y * kLanes + threadIdx.x;
  const int row = blockIdx.x * kRows + threadIdx.y;
  if (j >= ep || row >= rows) return;  // ep >= op always
  const float* xr = x + (size_t)row * np_;
  const int ho = n / 2;
  float sv = 0.0f, dv = 0.0f;
  if (j < ho) {
    const float a = xr[j];
    const float b = xr[n - 1 - j];
    sv = a + b;
    dv = a - b;
  } else if (j == ho && (n & 1)) {
    sv = xr[j];
  }
  s[(size_t)row * ep + j] = sv;
  if (j < op) d[(size_t)row * op + j] = dv;
}

}  // namespace

// x: (rows, np_) f32 contiguous; s: (rows, ep); d: (rows, op).
extern "C" int fold_minor_launch(const void* x, void* s, void* d, int rows,
                                 int np_, int n, int ep, int op, void* stream) {
  if (rows <= 0 || ep <= 0) return 0;
  const dim3 block(kLanes, kRows);
  const dim3 grid((rows + kRows - 1) / kRows, (ep + kLanes - 1) / kLanes);
  fold_minor_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(s),
      static_cast<float*>(d), rows, np_, n, ep, op);
  return static_cast<int>(cudaGetLastError());
}
