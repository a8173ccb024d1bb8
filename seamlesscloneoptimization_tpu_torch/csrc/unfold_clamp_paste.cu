// unfold_clamp_paste: the pair chain's last unfold, fused with the clamp,
// the u8 cast and the paste into the destination.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:
// unfold_clamp_guarded_pallas (body _unfold_clamp_kernel) with the
// paste_interior_pallas that follows it on the TPU's serve path; on the
// TPU's single-shot path, unfold_minor_pallas + clamp_cast_pallas. The
// guarded slab existed only for Mosaic's aligned DMA windows, so one kernel
// here reads the inverse-w half-GEMM outputs and writes the destination,
// as clamp_cast_paste.cu does for the unfolded chain.
//
// For r < h2 and x < w2:
//   dst[c, top1 + r, left1 + x] = (u8)(int)clamp(unfold_at(e[c, r], o[c, r],
//                                                 w2, x), 0, 255)
// (fold.cuh): clamp first, then truncate (OpenCV's cast), never round. The
// destination is given by its element strides: the planar (C, H, W) serve
// buffer or a (H, W, C) interleaved image. Nothing outside the interior is
// written.
//
// Bound on this card: bytes. One f32 read of the he data lanes of e and of
// o per interior row and one u8 write per interior pixel (2 x 22 MB read,
// 11 MB written at the 3 x 1548 x 2396 headline interior). Design: one
// thread per pixel, threads along the row, as in clamp_cast_paste.cu.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fold.cuh"

namespace {

__global__ void unfold_clamp_paste_kernel(const float* __restrict__ e,
                                          const float* __restrict__ o, int hu,
                                          int ep, uint8_t* __restrict__ dst,
                                          long long sc, long long sh,
                                          long long sw, int top1, int left1,
                                          int h2, int w2) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  const int c = blockIdx.z;
  if (x >= w2 || r >= h2) return;
  const size_t base = ((size_t)c * hu + r) * ep;
  float v = unfold_at(e + base, o + base, w2, x);
  v = fminf(fmaxf(v, 0.0f), 255.0f);
  dst[c * sc + (long long)(top1 + r) * sh + (long long)(left1 + x) * sw] =
      static_cast<uint8_t>(static_cast<int>(v));
}

}  // namespace

// e, o: (c, hu, ep) f32 contiguous, rows [0, h2) used.
// dst: u8 base pointer, element strides (sc, sh, sw) of its (C, H, W) view.
extern "C" int unfold_clamp_paste_launch(const void* e, const void* o, int c,
                                         int hu, int ep, void* dst, long long sc,
                                         long long sh, long long sw, int top1,
                                         int left1, int h2, int w2,
                                         void* stream) {
  if (c <= 0 || h2 <= 0 || w2 <= 0) return 0;
  const dim3 block(128, 4);
  const dim3 grid((w2 + 127) / 128, (h2 + 3) / 4, c);
  unfold_clamp_paste_kernel<<<grid, block, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(e), static_cast<const float*>(o), hu, ep,
      static_cast<uint8_t*>(dst), sc, sh, sw, top1, left1, h2, w2);
  return static_cast<int>(cudaGetLastError());
}
