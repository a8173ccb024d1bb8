// clamp_cast_paste_q: the quarter-plane multigrid solution -> u8, written in
// place into the destination at (top1, left1).
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:
// clamp_cast_guarded_quarters_pallas (_clamp_guard_q_kernel) with the paste
// that consumes its slab (paste_interior_pallas, ring_r=256) on the serve
// path, and from_quarters_pallas + clamp_cast_pallas on the single-shot
// path. The guarded slab existed only for Mosaic's aligned DMA windows: here
// one kernel reads the quarter planes and writes the destination.
//
// out[c, top1 + r, left1 + j] = (u8)(int)clamp(uq[c, 2 (r & 1) + (j & 1),
// r >> 1, j >> 1], 0, 255) for r < h2, j < w2: the dense interleave, then
// clamp, then truncate (OpenCV's cast). The destination is given by its
// element strides (clamp_cast_paste's contract), so one kernel serves the
// planar serve buffer and an interleaved image.
//
// Bound on this card: bytes. One f32 read and one u8 write per interior
// pixel (159 MB at the 8K interior 3 x 2798 x 3798; 0.048 ms at
// 3.35 TB/s). Design: one thread per pixel along the row; a warp reads two
// runs of 16 contiguous floats (the even and odd column planes) and writes
// 32 contiguous bytes (planar) or a 3-byte stride (interleaved).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void clamp_cast_paste_q_kernel(const float* __restrict__ uq, int hq, int wq2,
                                          uint8_t* __restrict__ dst, long long sc,
                                          long long sh, long long sw, int top1,
                                          int left1, int h2, int w2) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  const int c = blockIdx.z;
  if (j >= w2 || r >= h2) return;
  const int p = ((r & 1) << 1) | (j & 1);
  float v = uq[(((size_t)c * 4 + p) * hq + (r >> 1)) * wq2 + (j >> 1)];
  v = fminf(fmaxf(v, 0.0f), 255.0f);
  dst[c * sc + (long long)(top1 + r) * sh + (long long)(left1 + j) * sw] =
      static_cast<uint8_t>(static_cast<int>(v));
}

}  // namespace

// uq: (c, 4, hq, wq2) f32 contiguous, interior (h2, w2) at the dense origin.
// dst: u8 base pointer, element strides (sc, sh, sw) of its (C, H, W) view.
extern "C" int clamp_cast_paste_q_launch(const void* uq, int c, int hq, int wq2,
                                         void* dst, long long sc, long long sh,
                                         long long sw, int top1, int left1, int h2,
                                         int w2, void* stream) {
  if (c <= 0 || h2 <= 0 || w2 <= 0) return 0;
  const dim3 block(128, 4);
  const dim3 grid((w2 + 127) / 128, (h2 + 3) / 4, c);
  clamp_cast_paste_q_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(uq), hq, wq2, static_cast<uint8_t*>(dst), sc, sh, sw,
      top1, left1, h2, w2);
  return static_cast<int>(cudaGetLastError());
}
