// erode3: three 3x3 binary erosions of a {0,1} u8 mask with a zero border.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:erode3_pallas
// (body _erode3_kernel).
//
// Three 3x3 min-erosions with zeros outside the domain equal one 7x7 min
// over the zero-extended mask (structuring elements compose), which is
// separable: a radius-3 vertical min, then a radius-3 horizontal min.
//
// Bound on this card: bytes. One u8 read and one u8 write per pixel
// (7.4 MB at the 1550x2398 headline ROI), against ~12 integer mins per
// pixel. Design: one block per 32x32 output tile stages the tile plus its
// 3-px halo in shared memory (coalesced row loads, zeros outside the
// domain), takes the vertical min into a second shared array and the
// horizontal min from it, so each input byte is read from device memory
// about 1.4 times (halo overlap) and each output byte written once.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kR = 3;                       // 3 erosions = radius 3
constexpr int kWin = kTile + 2 * kR;        // 38

__global__ void erode3_kernel(const uint8_t* __restrict__ in,
                              uint8_t* __restrict__ out, int h, int w) {
  __shared__ uint8_t tile[kWin][kWin];
  __shared__ uint8_t vmin[kTile][kWin];
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;

  for (int i = tid; i < kWin * kWin; i += nt) {
    const int ty = i / kWin, tx = i % kWin;
    const int y = y0 + ty - kR, x = x0 + tx - kR;
    uint8_t v = 0;
    if (y >= 0 && y < h && x >= 0 && x < w) v = in[(size_t)y * w + x];
    tile[ty][tx] = v;
  }
  __syncthreads();

  // vmin[ty][tx] = min over window rows ty .. ty+6 (output row y0+ty)
  for (int i = tid; i < kTile * kWin; i += nt) {
    const int ty = i / kWin, tx = i % kWin;
    uint8_t m = tile[ty][tx];
#pragma unroll
    for (int k = 1; k <= 2 * kR; ++k) {
      const uint8_t v = tile[ty + k][tx];
      m = v < m ? v : m;
    }
    vmin[ty][tx] = m;
  }
  __syncthreads();

  for (int i = tid; i < kTile * kTile; i += nt) {
    const int ty = i / kTile, tx = i % kTile;
    const int y = y0 + ty, x = x0 + tx;
    if (y < h && x < w) {
      uint8_t m = vmin[ty][tx];
#pragma unroll
      for (int k = 1; k <= 2 * kR; ++k) {
        const uint8_t v = vmin[ty][tx + k];
        m = v < m ? v : m;
      }
      out[(size_t)y * w + x] = m;
    }
  }
}

}  // namespace

extern "C" int erode3_launch(const void* mask01, void* out, int h, int w,
                             void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile);
  erode3_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask01), static_cast<uint8_t*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}
