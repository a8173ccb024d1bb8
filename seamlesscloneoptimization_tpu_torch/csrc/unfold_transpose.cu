// unfold_transpose: unfold_minor fused with a windowed transpose.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:
// unfold_transpose_pallas (body _unfold_tp_kernel). The pair chain runs it
// twice a frame, after the inverse-h half-GEMMs: once for the even and once
// for the odd window of the grouped w spectrum, so the unfolded slab never
// reaches memory and the two outputs feed the inverse-w GEMMs whole.
//
// e, o: (C, M, ep); out (C, out_pad, rc):
//   out[c, x, r] = unfold_at(e[c, row_start + r], o[c, row_start + r], n, x)
// (fold.cuh), exact zeros for x >= n.
//
// Bound on this card: bytes. One f32 read of the he data lanes of e and of
// o per window row and one f32 write per output element (2 x 12 MB read,
// 26 MB written per 1280-row window of the (3, 2560, 896) headline pair). Design: the
// shared-memory tile of transpose.cu; the load phase computes the unfolded
// value of tile element (r, x) with threads along x (the reversed half
// reads a contiguous run backwards), the store phase writes along r.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fold.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // blockDim.y

__global__ void unfold_transpose_kernel(const float* __restrict__ e,
                                        const float* __restrict__ o,
                                        float* __restrict__ out, int m, int ep,
                                        int n, int out_pad, int row_start,
                                        int rc) {
  __shared__ float tile[kTile][kTile + 1];
  const int ci = blockIdx.z;
  const int r0 = blockIdx.y * kTile;
  const int x0 = blockIdx.x * kTile;

  const int x = x0 + threadIdx.x;
  for (int i = threadIdx.y; i < kTile; i += kRows) {
    const int r = r0 + i;
    if (r < rc && x < out_pad) {
      const size_t base = ((size_t)ci * m + row_start + r) * ep;
      tile[i][threadIdx.x] = unfold_at(e + base, o + base, n, x);
    }
  }
  __syncthreads();

  float* oc = out + (size_t)ci * out_pad * rc;
  const int r = r0 + threadIdx.x;
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    const int xj = x0 + j;
    if (xj < out_pad && r < rc) oc[(size_t)xj * rc + r] = tile[threadIdx.x][j];
  }
}

}  // namespace

// e, o: (c, m, ep) f32 contiguous; out: (c, out_pad, rc).
extern "C" int unfold_transpose_launch(const void* e, const void* o, void* out,
                                       int c, int m, int ep, int n, int out_pad,
                                       int row_start, int rc, void* stream) {
  if (c <= 0 || rc <= 0 || out_pad <= 0) return 0;
  const dim3 block(kTile, kRows);
  const dim3 grid((out_pad + kTile - 1) / kTile, (rc + kTile - 1) / kTile, c);
  unfold_transpose_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(e), static_cast<const float*>(o),
      static_cast<float*>(out), m, ep, n, out_pad, row_start, rc);
  return static_cast<int>(cudaGetLastError());
}
