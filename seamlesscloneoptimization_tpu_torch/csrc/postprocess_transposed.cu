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
// the blended ROI. No other byte is written. The destination is given by
// its element strides: the planar serve buffer or an interleaved (H, W, C)
// image.
//
// Bound on this card: bytes. In place the function reads u_t once and writes
// the u8 interior once, 5 bytes per interior pixel: 55.6 MB at the headline
// (u_t 3 x 2396 x 1548 into a 3 x 1550 x 2398 ROI), 0.0166 ms at 3.35 TB/s.
// The border is neither read nor written.
//
// Design (h2 a multiple of 4 and u_t 16-byte aligned, as on the dst_post_t
// frame: u_t (3, 2396, 1548)): a block of 256 threads owns a tile of kTR
// destination rows x kTJ destination columns, i.e. kTJ rows of u_t, kTR
// floats each. Every thread issues its kLoads 16-byte cp.async copies along
// u_t's rows (a warp instruction: 4 rows x 128 contiguous bytes) straight
// into a shared [j][r] tile of float4 units whose unit (j, q) sits at
// column q ^ ((j >> 3) & 7): an XOR swizzle on 16-byte units, so that both
// the row-wise writes (8 lanes: one j, q = 0 .. 7) and the transposed
// pass's float4 reads (8 lanes: j = 8 l + k, one q) hit 32 different banks.
// In that pass warp w owns destination rows 4 w .. 4 w + 3 of the tile and
// lane l the columns 8 l .. 8 l + 7: eight float4 reads give it a 4 x 8
// block, which it clamps, truncates and packs into two 32-bit words a row.
// paste_words.cuh's paste_run (clamp_cast_paste's walk, one chunk a lane)
// then writes each row's 256 columns: a planar row as aligned 8-byte words
// joined across lanes at the row's byte offset (the destination column
// left1 + j starts at any byte), pieces of 4, 2 and 1 bytes at the ends; an
// interleaved row a byte a lane, with the channel the grid's fastest index.
// The tile is 32 x 256 so that a warp writes 256-byte runs of a destination
// row (a 64 x 64 tile gives 64-byte runs). At the headline it takes 0.034
// ms planar and 0.040 interleaved, cold, on an H100 80GB HBM3 at 700 W
// (chip_smoke.py, PERF.md section 6). Measured there: the read is what
// costs. Without its global stores the kernel still takes 0.029 ms cold
// (clamp_cast_paste's dense read of the same bytes 0.026); a 64 x 256 tile
// that reads 256 bytes of each u_t row, persistent blocks that prefetch
// the next tile, and capping the registers at 6 blocks an SM were no
// faster. Any other shape (h2 % 4 != 0, or an unaligned u_t) takes the
// first design, kept as postprocess_transposed_ragged: a 32 x 33 int tile
// read with 4-byte loads and written with 1-byte stores (0.036 ms planar,
// 0.046 interleaved at the headline in the same runs).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "paste_words.cuh"

namespace {

constexpr int kTR = 32;                    // destination rows a tile (u_t's minor axis)
constexpr int kTJ = 256;                   // destination columns a tile (u_t's rows)
constexpr int kQ = kTR / 4;                // float4 units a u_t row of the tile
constexpr int kThreads = 32 * kTR / 4;     // a warp per 4 destination rows
constexpr int kLoads = kTJ * kQ / kThreads;  // float4 loads a thread
constexpr int kLoadRows = kThreads / kQ;   // u_t rows a load pass

__device__ __forceinline__ int swizzle(int j, int q) { return q ^ ((j >> 3) & 7); }

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Grid (c, row tiles, column tiles): block (x, y, z) owns destination rows
// [kTR y', kTR (y' + 1)) and columns [kTJ z', kTJ (z' + 1)) of channel x,
// y' = gridDim.y - 1 - y, z' = gridDim.z - 1 - z: the tiles are walked from
// u_t's end, which the solve wrote last and L2 may still hold (5% in the
// dst_post_t loop on an H100, PERF.md section 6).
__global__ void __launch_bounds__(kThreads)
postprocess_transposed_kernel(const float* __restrict__ u_t, int h2, int w2,
                              uint8_t* __restrict__ dst, long long sc, long long sh,
                              long long sw, int top1, int left1) {
  __shared__ float4 tile[kTJ][kQ];
  const int c = blockIdx.x, r0 = (gridDim.y - 1 - blockIdx.y) * kTR;
  const int j0 = (gridDim.z - 1 - blockIdx.z) * kTJ;
  const int t = threadIdx.x;
  const float* uc = u_t + (size_t)c * w2 * h2 + r0;

  // load: thread (u_t row t / kQ + kLoadRows i, unit t % kQ); h2 % 4 == 0,
  // so a unit is wholly inside the rows or wholly past them
  const int q = t % kQ, jr = t / kQ;
  const bool q_in = r0 + 4 * q < h2;
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int j = jr + kLoadRows * i;
    const bool ok = q_in && j0 + j < w2;
    acp::copy16(reinterpret_cast<float*>(&tile[j][swizzle(j, q)]),
                ok ? uc + (size_t)(j0 + j) * h2 + 4 * q : u_t, ok);
  }
  acp::commit();
  acp::wait<0>();
  __syncthreads();

  // store: warp w, destination rows r0 + 4 w + i (i < 4); lane l, columns
  // j0 + 8 l .. + 7
  const int w = t >> 5, lane = t & 31;
  if (r0 + 4 * w >= h2) return;  // the whole warp: its four rows are past h2
  float4 s[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) s[k] = tile[8 * lane + k][swizzle(8 * lane + k, w)];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t own[1][2] = {{pack4(at(s[0], i), at(s[1], i), at(s[2], i), at(s[3], i)),
                                 pack4(at(s[4], i), at(s[5], i), at(s[6], i), at(s[7], i))}};
    paste_run<1>(dst + c * sc + (long long)(top1 + r0 + 4 * w + i) * sh + left1 * sw, sw, j0,
                 w2, own);
  }
}

// Any shape: the first design, a 32 x 32 tile of u_t read with threads
// along u_t's rows, clamped and truncated into an int tile whose rows are
// padded to 33 cells, written as u8 with threads along the destination's
// rows.
constexpr int kRagged = 32;
constexpr int kRaggedRows = 8;  // blockDim.y: each thread moves kRagged / kRaggedRows elements

__global__ void postprocess_transposed_ragged(const float* __restrict__ u_t, int h2, int w2,
                                              uint8_t* __restrict__ dst, long long sc,
                                              long long sh, long long sw, int top1,
                                              int left1) {
  __shared__ int tile[kRagged][kRagged + 1];
  const int c = blockIdx.z;
  const float* uc = u_t + (size_t)c * w2 * h2;
  const int r0 = blockIdx.x * kRagged;  // destination rows: u_t's minor axis
  const int j0 = blockIdx.y * kRagged;  // destination columns: u_t's rows

  const int r = r0 + threadIdx.x;
  for (int i = threadIdx.y; i < kRagged; i += kRaggedRows) {
    const int j = j0 + i;
    if (j < w2 && r < h2) {
      const float v = fminf(fmaxf(uc[(size_t)j * h2 + r], 0.0f), 255.0f);
      tile[i][threadIdx.x] = static_cast<int>(v);
    }
  }
  __syncthreads();

  const int j = j0 + threadIdx.x;
  uint8_t* dc = dst + c * sc;
  for (int i = threadIdx.y; i < kRagged; i += kRaggedRows) {
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
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* u = static_cast<const float*>(u_t);
  auto* d = static_cast<uint8_t*>(dst);
  if (h2 % 4 == 0 && (reinterpret_cast<uintptr_t>(u_t) & 15) == 0) {
    const dim3 grid(c, (h2 + kTR - 1) / kTR, (w2 + kTJ - 1) / kTJ);
    postprocess_transposed_kernel<<<grid, kThreads, 0, st>>>(u, h2, w2, d, sc, sh, sw, top1,
                                                             left1);
  } else {
    const dim3 grid((h2 + kRagged - 1) / kRagged, (w2 + kRagged - 1) / kRagged, c);
    postprocess_transposed_ragged<<<grid, dim3(kRagged, kRaggedRows), 0, st>>>(
        u, h2, w2, d, sc, sh, sw, top1, left1);
  }
  return static_cast<int>(cudaGetLastError());
}
