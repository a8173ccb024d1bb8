// postprocess_transposed: the TRANSPOSED solved interior (C, W-2, H-2) f32 ->
// the blended u8 ROI, written in place into the destination.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:
// postprocess_transposed_pallas (body _post_strip_kernel). The TPU kernel
// returns a new (C, H, W) ROI: the interior clamp(u_t^T, 0, 255) truncated
// to u8 and the one-pixel border from dest. Here the ROI is the destination
// view itself, whose border already holds dest: the kernel writes only the
// interior, dst[c, top1 + r, left1 + j] = (u8)(int)clamp(u_t[c, j, r], 0, 255)
// for r < H-2, j < W-2, clamp first, then truncate (OpenCV's cast), never
// round; the border stays as it is, so the ROI at (top1 - 1, left1 - 1) is
// the blended ROI. The destination is given by its element strides: the
// planar serve buffer or an interleaved (H, W, C) image.
//
// Bound on this card: bytes. In place the function reads u_t once and writes
// the u8 interior once, 5 bytes per interior pixel: 55.6 MB at the headline
// (u_t 3 x 2396 x 1548 into a 3 x 1550 x 2398 ROI), 0.0166 ms at 3.35 TB/s.
// The border is neither read nor written. Design:
// the classic shared-memory tiled transpose of csrc/transpose.cu. A 32 x 32
// tile of u_t is read with threads along u_t's rows (coalesced), clamped and
// truncated into an int tile whose rows are padded to 33 cells (the column
// reads hit 32 different banks), then written as u8 with threads along the
// destination's rows (contiguous for the planar buffer, 3-byte strides for
// the interleaved image).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // blockDim.y: each thread moves kTile / kRows elements

__global__ void postprocess_transposed_kernel(const float* __restrict__ u_t, int h2,
                                              int w2, uint8_t* __restrict__ dst,
                                              long long sc, long long sh,
                                              long long sw, int top1, int left1) {
  __shared__ int tile[kTile][kTile + 1];
  const int c = blockIdx.z;
  const float* uc = u_t + (size_t)c * w2 * h2;
  const int r0 = blockIdx.x * kTile;  // destination rows: u_t's minor axis
  const int j0 = blockIdx.y * kTile;  // destination columns: u_t's rows

  const int r = r0 + threadIdx.x;
  for (int i = threadIdx.y; i < kTile; i += kRows) {
    const int j = j0 + i;
    if (j < w2 && r < h2) {
      const float v = fminf(fmaxf(uc[(size_t)j * h2 + r], 0.0f), 255.0f);
      tile[i][threadIdx.x] = static_cast<int>(v);
    }
  }
  __syncthreads();

  const int j = j0 + threadIdx.x;
  uint8_t* dc = dst + c * sc;
  for (int i = threadIdx.y; i < kTile; i += kRows) {
    const int rr = r0 + i;
    if (rr < h2 && j < w2)
      dc[(long long)(top1 + rr) * sh + (long long)(left1 + j) * sw] =
          static_cast<uint8_t>(tile[threadIdx.x][i]);
  }
}

}  // namespace

// u_t: (c, w2, h2) f32 contiguous, the interior (h2, w2) transposed.
// dst: u8 base pointer, element strides (sc, sh, sw) of its (C, H, W) view;
// the interior lands at (top1, left1).
extern "C" int postprocess_transposed_launch(const void* u_t, int c, int h2, int w2,
                                             void* dst, long long sc, long long sh,
                                             long long sw, int top1, int left1,
                                             void* stream) {
  if (c <= 0 || h2 <= 0 || w2 <= 0) return 0;
  const dim3 block(kTile, kRows);
  const dim3 grid((h2 + kTile - 1) / kTile, (w2 + kTile - 1) / kTile, c);
  postprocess_transposed_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u_t), h2, w2, static_cast<uint8_t*>(dst), sc, sh, sw,
      top1, left1);
  return static_cast<int>(cudaGetLastError());
}
