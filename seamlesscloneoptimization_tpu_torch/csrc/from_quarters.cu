// from_quarters: four parity planes (C, 4, hq, wq) interleaved back into the
// dense level (C, 2 hq, 2 wq), x[c, 2 i + a, 2 j + b] = q[c, 2 a + b, i, j]; the
// inverse of to_quarters.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_mg_quarter.py:
// from_quarters_pallas (_from_q_kernel, quarters_to_dense_tile).
//
// In: q (C, 4, hq, wq) f32, contiguous. Out: (C, 2 hq, 2 wq) f32, 8-byte
// aligned, every element written. It only moves data: bit-equal to the twin
// (ops/kernels.py: from_quarters_plain), padding included.
//
// Bound on this card: bytes. The planes read once, x written once: 2 x 3 x
// 2816 x 3840 x 4 B = 260 MB for the 8K level (0.078 ms at 3.35 TB/s).
// Design: one thread per dense lane pair (a float2): it reads element (r/2, j)
// of the two planes of row parity r % 2 and writes x[r, 2j .. 2j+1]; reads
// and writes are coalesced, no shared memory.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns the launch's cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowsGrid = 65535;

__global__ void from_quarters_kernel(const float* __restrict__ q, float2* __restrict__ x,
                                     int hq, int wq) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= wq) return;
  const int c = blockIdx.z;
  const size_t plane = (size_t)hq * wq;
  for (int r = blockIdx.y; r < 2 * hq; r += gridDim.y) {
    const float* p = q + ((size_t)c * 4 + 2 * (r & 1)) * plane + (size_t)(r >> 1) * wq + j;
    x[((size_t)c * 2 * hq + r) * wq + j] = make_float2(p[0], p[plane]);
  }
}

}  // namespace

// q: (c, 4, hq, wq) f32 contiguous; x: (c, 2 hq, 2 wq) f32 contiguous, 8-byte
// aligned.
extern "C" int from_quarters_launch(const void* q, void* x, int c, int hq, int wq,
                                    void* stream) {
  if (c <= 0 || hq <= 0 || wq <= 0) return 0;
  const int rows = 2 * hq < kMaxRowsGrid ? 2 * hq : kMaxRowsGrid;
  const dim3 grid((wq + kThreads - 1) / kThreads, rows, c);
  from_quarters_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<float2*>(x), hq, wq);
  return static_cast<int>(cudaGetLastError());
}
