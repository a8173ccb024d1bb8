// clamp_cast_paste: the solved f32 interior -> u8, written in place into the
// destination at (top1, left1).
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:
// clamp_cast_guarded_pallas + paste_interior_pallas (serve path, planar
// destination) and clamp_cast_pallas (single-shot path, interleaved
// destination). The guarded slab between the TPU's two kernels existed only
// for Mosaic's aligned DMA windows; here one kernel reads the solution and
// writes the destination directly.
//
// out[c, top1 + r, left1 + j] = (u8)(int)clamp(u[c, r, j], 0, 255) for
// r < h2, j < w2: clamp first, then truncate (OpenCV's cast), never round.
// The destination is given by its element strides, so one kernel serves the
// planar (C, H, W) chained serve buffer and a (H, W, C) interleaved image.
//
// Bound on this card: bytes. One f32 read and one u8 write per interior
// pixel (56 MB at the 3 x 1548 x 2396 headline interior). Design: one thread
// per pixel, threads along the row, so the f32 reads are coalesced and the
// planar u8 writes are contiguous (the interleaved writes stride by 3 bytes).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void clamp_cast_paste_kernel(const float* __restrict__ u, int hu,
                                        int wu, uint8_t* __restrict__ dst,
                                        long long sc, long long sh, long long sw,
                                        int top1, int left1, int h2, int w2) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  const int c = blockIdx.z;
  if (j >= w2 || r >= h2) return;
  float v = u[((size_t)c * hu + r) * wu + j];
  v = fminf(fmaxf(v, 0.0f), 255.0f);
  dst[c * sc + (long long)(top1 + r) * sh + (long long)(left1 + j) * sw] =
      static_cast<uint8_t>(static_cast<int>(v));
}

}  // namespace

// u: (c, hu, wu) f32 contiguous, interior (h2, w2) at the origin.
// dst: u8 base pointer, element strides (sc, sh, sw) of its (C, H, W) view.
extern "C" int clamp_cast_paste_launch(const void* u, int c, int hu, int wu,
                                       void* dst, long long sc, long long sh,
                                       long long sw, int top1, int left1,
                                       int h2, int w2, void* stream) {
  if (c <= 0 || h2 <= 0 || w2 <= 0) return 0;
  const dim3 block(128, 4);
  const dim3 grid((w2 + 127) / 128, (h2 + 3) / 4, c);
  clamp_cast_paste_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), hu, wu, static_cast<uint8_t*>(dst), sc, sh,
      sw, top1, left1, h2, w2);
  return static_cast<int>(cudaGetLastError());
}
