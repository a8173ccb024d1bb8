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
// No byte outside that rectangle is written. The destination is given by
// its element strides, so one kernel serves the planar (C, H, W) chained
// serve buffer and a (H, W, C) interleaved image.
//
// Bound on this card: bytes. One f32 read and one u8 write per interior
// pixel (56 MB at the 3 x 1548 x 2396 headline interior, 0.0166 ms at
// 3.35 TB/s; 159 MB at the 8K interior 3 x 2798 x 3798, 0.0476 ms).
//
// Design: clamp_cast_paste_q.cu's warp walk on a dense source row. A warp
// owns kSpan columns of one destination row, a thread kParts 8-pixel chunks
// of it, 256 columns apart (chunk n = 32 p + lane). The thread reads a
// chunk's 8 floats with vector loads, clamps and truncates them in
// registers and packs the bytes into two 32-bit words; paste_words.cuh's
// paste_run writes the warp's run: a planar row as aligned 8-byte words
// joined across lanes (shuffle + funnel shift, at the row's byte offset),
// pieces of 4, 2 and 1 bytes at the ends, an interleaved row a byte a lane.
// The channel is the grid's fastest index, so the blocks that write an
// interleaved pixel's three bytes run together. u is any contiguous (C, hu,
// wu) array, so its rows are not all 16-byte aligned (the 8K exact-size
// solve has wu = 3798: every other row starts 8 bytes past a 16-byte
// boundary). The load width is picked per row, from the row's address:
// float4 where it is 16-byte aligned, float2 where it is 8-byte aligned,
// scalars otherwise; columns past w2 are not read, a chunk that w2 cuts
// takes scalars. No vector load is misaligned. Cold, on an H100 80GB HBM3
// at 700 W (chip_smoke.py, PERF.md section 6), it takes 0.065 ms planar and
// 0.078 interleaved at 8K (from the 16-byte aligned slab, and as much from
// the exact-size u whose rows alternate float4 and float2 loads), 0.029
// and 0.037 at the headline; the first design (one pixel a thread in
// 128 x 4 blocks: a 4-byte load, 64-bit index arithmetic and a byte store
// per pixel) took 0.117-0.119 at 8K and 0.047 at the headline.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "paste_words.cuh"

namespace {

constexpr int kParts = 2;               // 8-pixel chunks a thread
constexpr int kSpan = 32 * 8 * kParts;  // destination columns a warp
constexpr int kRows = 8;                // rows a block, one warp each

// The 8 floats of row[j0 .. j0 + 8) that lie below w2 (0 past it), in
// aligned loads of kW floats (row + j0 is kW-aligned); a load that w2 cuts
// takes scalars.
template <int kW>
__device__ __forceinline__ void load8(const float* __restrict__ row, int j0, int w2,
                                      float (&v)[8]) {
#pragma unroll
  for (int k = 0; k < 8; k += kW) {
    const int j = j0 + k;
    if (j + kW <= w2) {
      if constexpr (kW == 4) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(row + j));
        v[k] = x.x, v[k + 1] = x.y, v[k + 2] = x.z, v[k + 3] = x.w;
      } else if constexpr (kW == 2) {
        const float2 x = __ldg(reinterpret_cast<const float2*>(row + j));
        v[k] = x.x, v[k + 1] = x.y;
      } else {
        v[k] = __ldg(row + j);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kW; ++i) v[k + i] = j + i < w2 ? __ldg(row + j + i) : 0.0f;
    }
  }
}

template <int kW>
__device__ __forceinline__ void load_chunks(const float* __restrict__ row, int span0, int w2,
                                            uint32_t (&own)[kParts][2]) {
  const int lane = threadIdx.x;
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    float v[8];
    load8<kW>(row, span0 + 8 * (32 * p + lane), w2, v);
    own[p][0] = pack4(v[0], v[1], v[2], v[3]);
    own[p][1] = pack4(v[4], v[5], v[6], v[7]);
  }
}

// Block (32, kRows): warp y writes row r = kRows (gridDim.z - 1 - blockIdx.z)
// + y of channel blockIdx.x, its columns [kSpan blockIdx.y, kSpan
// (blockIdx.y + 1)). The grid walks the rows from the last: in a frame the
// solve wrote those last, and L2 may still hold them (1-5% off the paste
// in the loop on an H100, PERF.md section 6).
__global__ void __launch_bounds__(32 * kRows)
clamp_cast_paste_kernel(const float* __restrict__ u, int hu, int wu, uint8_t* __restrict__ dst,
                        long long sc, long long sh, long long sw, int top1, int left1, int h2,
                        int w2) {
  const int r = (gridDim.z - 1 - blockIdx.z) * kRows + threadIdx.y;
  if (r >= h2) return;  // the whole warp
  const int c = blockIdx.x, span0 = kSpan * blockIdx.y;
  const float* row = u + ((size_t)c * hu + r) * wu;
  uint32_t own[kParts][2];
  switch ((reinterpret_cast<uintptr_t>(row) >> 2) & 3) {  // the row's float offset mod 4
    case 0: load_chunks<4>(row, span0, w2, own); break;
    case 2: load_chunks<2>(row, span0, w2, own); break;
    default: load_chunks<1>(row, span0, w2, own); break;
  }
  paste_run<kParts>(dst + c * sc + (long long)(top1 + r) * sh + left1 * sw, sw, span0, w2, own);
}

}  // namespace

// u: (c, hu, wu) f32 contiguous, interior (h2, w2) at the origin.
// dst: u8 base pointer, element strides (sc, sh, sw) of its (C, H, W) view.
extern "C" int clamp_cast_paste_launch(const void* u, int c, int hu, int wu,
                                       void* dst, long long sc, long long sh,
                                       long long sw, int top1, int left1,
                                       int h2, int w2, void* stream) {
  if (c <= 0 || h2 <= 0 || w2 <= 0) return 0;
  const dim3 block(32, kRows);
  const dim3 grid(c, (w2 + kSpan - 1) / kSpan, (h2 + kRows - 1) / kRows);
  clamp_cast_paste_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), hu, wu, static_cast<uint8_t*>(dst), sc, sh, sw, top1,
      left1, h2, w2);
  return static_cast<int>(cudaGetLastError());
}
