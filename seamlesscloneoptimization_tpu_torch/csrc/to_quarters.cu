// to_quarters: a dense level (C, 2 hq, 2 wq) split into its four parity
// planes (C, 4, hq, wq), out[c, 2 a + b, i, j] = x[c, 2 i + a, 2 j + b]: EE, EO,
// OE, OO (mg_level_q.cuh's layout).
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_mg_quarter.py:
// to_quarters_pallas (_to_q_kernel, dense_to_quarters_tile).
//
// In: x (C, 2 hq, 2 wq) f32, contiguous, 8-byte aligned. Out: (C, 4, hq, wq)
// f32, every element written. It only moves data: bit-equal to the twin
// (ops/kernels.py: to_quarters_plain), padding included.
//
// Bound on this card: bytes. x read once, the planes written once: 2 x 3 x
// 2816 x 3840 x 4 B = 260 MB for the 8K level (0.078 ms at 3.35 TB/s).
// Design: one thread per dense lane pair (a float2): it reads x[r, 2j .. 2j+1]
// and writes element (r/2, j) of the two planes of row parity r % 2. A warp
// reads 256 contiguous bytes and writes 128 contiguous bytes to each of two
// planes, so both sides stay coalesced and no shared memory is needed.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns the launch's cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowsGrid = 65535;

__global__ void to_quarters_kernel(const float2* __restrict__ x, float* __restrict__ out,
                                   int hq, int wq) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= wq) return;
  const int c = blockIdx.z;
  const size_t plane = (size_t)hq * wq;
  for (int r = blockIdx.y; r < 2 * hq; r += gridDim.y) {
    const float2 v = x[((size_t)c * 2 * hq + r) * wq + j];
    float* o = out + ((size_t)c * 4 + 2 * (r & 1)) * plane + (size_t)(r >> 1) * wq + j;
    o[0] = v.x;      // column parity 0
    o[plane] = v.y;  // column parity 1
  }
}

}  // namespace

// x: (c, 2 hq, 2 wq) f32 contiguous, 8-byte aligned; out: (c, 4, hq, wq) f32
// contiguous.
extern "C" int to_quarters_launch(const void* x, void* out, int c, int hq, int wq,
                                  void* stream) {
  if (c <= 0 || hq <= 0 || wq <= 0) return 0;
  const int rows = 2 * hq < kMaxRowsGrid ? 2 * hq : kMaxRowsGrid;
  const dim3 grid((wq + kThreads - 1) / kThreads, rows, c);
  to_quarters_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<float*>(out), hq, wq);
  return static_cast<int>(cudaGetLastError());
}
