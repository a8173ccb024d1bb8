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
// clamp, then truncate (OpenCV's cast). No byte outside that rectangle is
// written. The destination is given by its element strides
// (clamp_cast_paste's contract), so one kernel serves the planar serve
// buffer and an interleaved image.
//
// Bound on this card: bytes. One f32 read and one u8 write per interior
// pixel (159 MB at the 8K interior 3 x 2798 x 3798; 0.048 ms at
// 3.35 TB/s). The first design (one pixel a thread: a 4-byte load and a
// byte store, 64-bit index arithmetic per pixel) took 0.124 ms. Design: a
// warp owns 512 dense columns of one row, a thread kParts 8-byte chunks of
// it, 256 columns apart, so each of its float4 loads (4 quarter columns of
// the row's even and of its odd plane) is one 512-byte run across the
// warp. The thread interleaves, clamps and truncates in registers and packs
// the bytes into two 32-bit words a chunk. A planar row (element stride 1)
// starts at any byte offset e = address mod 8, so the thread of chunk n
// writes the aligned 8-byte word that holds the last e bytes of chunk n - 1
// and the first 8 - e of its own: it takes its neighbour lane's words with
// a shuffle and joins the two with a funnel shift (the mirror image of
// rhs_wide.cuh's read). Words that are not whole inside [left1, left1 + w2)
// (the row's two ends, and the one word at each end of a warp's run whose
// other part belongs to the next warp) are written in aligned pieces of 4,
// 2 and 1 bytes, so no byte outside the rectangle is touched. An
// interleaved destination (element stride 3) keeps byte stores, in the
// same kernel, a pixel a lane (each byte fetched from its chunk's lane by
// a shuffle), so a warp's store covers 96 contiguous bytes (that walk is
// paste_words.cuh's paste_run, shared with clamp_cast_paste.cu and
// postprocess_transposed.cu); the channel is the grid's fastest index, so the
// three blocks that write a pixel's bytes run together and L2 holds each
// 32-byte sector whole before it is written back. It takes 0.064 ms at 8K
// planar on an H100 80GB HBM3 at 700 W and 0.077 interleaved (chip_smoke.py,
// PERF.md section 6; 0.124 and 0.155 before).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "paste_words.cuh"

namespace {

constexpr int kParts = 2;                // 8-byte chunks a thread
constexpr int kSpan = 32 * 8 * kParts;   // dense columns a warp
constexpr int kRows = 8;                 // rows a block, one warp each

// Four quarter columns m0 .. m0 + 3 of a plane row (0 past `need`).
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int m0, int need) {
  if (kVec) {
    if (m0 >= need) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return __ldg(reinterpret_cast<const float4*>(row + m0));
  }
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = m0 + k < need ? __ldg(row + m0 + k) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Block (32, kRows): warp y writes dense row r = kRows blockIdx.z + y of
// channel blockIdx.x, its dense columns [kSpan blockIdx.y, kSpan
// (blockIdx.y + 1)); lane l owns the chunks n = 32 p + l (p < kParts),
// columns j0 = kSpan blockIdx.y + 8 n. The channel is the grid's fastest
// index, so the blocks that write the three bytes of an interleaved pixel
// run together and each 32-byte sector is whole in L2 before it is written
// back.
template <bool kVec>
__global__ void __launch_bounds__(32 * kRows)
clamp_cast_paste_q_kernel(const float* __restrict__ uq, int hq, int wq2,
                          uint8_t* __restrict__ dst, long long sc, long long sh,
                          long long sw, int top1, int left1, int h2, int w2) {
  const int r = blockIdx.z * kRows + threadIdx.y;
  if (r >= h2) return;  // the whole warp
  const int lane = threadIdx.x, c = blockIdx.x;
  const int span0 = kSpan * blockIdx.y;
  const int need = (w2 + 1) >> 1;  // quarter columns that hold a pixel
  const size_t plane = (size_t)hq * wq2;
  const float* ev = uq + ((size_t)c * 4 + 2 * (r & 1)) * plane + (size_t)(r >> 1) * wq2;
  const float* od = ev + plane;
  uint32_t own[kParts][2];
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    const int m0 = (span0 >> 1) + 4 * (32 * p + lane);
    const float4 a = load4<kVec>(ev, m0, need), b = load4<kVec>(od, m0, need);
    own[p][0] = pack4(a.x, b.x, a.y, b.y);
    own[p][1] = pack4(a.z, b.z, a.w, b.w);
  }
  paste_run<kParts>(dst + c * sc + (long long)(top1 + r) * sh + left1 * sw, sw, span0, w2,
                    own);
}

}  // namespace

// uq: (c, 4, hq, wq2) f32 contiguous, interior (h2, w2) at the dense origin.
// dst: u8 base pointer, element strides (sc, sh, sw) of its (C, H, W) view.
extern "C" int clamp_cast_paste_q_launch(const void* uq, int c, int hq, int wq2,
                                         void* dst, long long sc, long long sh,
                                         long long sw, int top1, int left1, int h2,
                                         int w2, void* stream) {
  if (c <= 0 || h2 <= 0 || w2 <= 0) return 0;
  const dim3 block(32, kRows);
  const dim3 grid(c, (w2 + kSpan - 1) / kSpan, (h2 + kRows - 1) / kRows);
  const bool vec = wq2 % 4 == 0 && (reinterpret_cast<uintptr_t>(uq) & 15) == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* u = static_cast<const float*>(uq);
  auto* d = static_cast<uint8_t*>(dst);
  if (vec)
    clamp_cast_paste_q_kernel<true><<<grid, block, 0, st>>>(u, hq, wq2, d, sc, sh, sw, top1,
                                                            left1, h2, w2);
  else
    clamp_cast_paste_q_kernel<false><<<grid, block, 0, st>>>(u, hq, wq2, d, sc, sh, sw, top1,
                                                             left1, h2, w2);
  return static_cast<int>(cudaGetLastError());
}
