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
// 11 MB written at the 3 x 1548 x 2396 headline interior).
//
// Design: clamp_cast_paste_q.cu's warp walk, on mirror pairs. A warp owns
// kSpan source lanes of one row, a thread kParts 8-lane chunks of it, 256
// lanes apart (chunk n = 32 p + lane), read as two float4 of e and two of o
// (fold.cuh's unfold_lanes4; scalar loads where ep % 4 != 0 or a pointer
// is not 16-byte aligned). From them the thread forms the chunk's 8 forward
// pixels, x = 8 n .. 8 n + 7 (s = e + o), and its 8 mirrored pixels, x =
// w2 - 8 - 8 n .. w2 - 1 - 8 n (d = e - o, lane k at x = w2 - 1 - k), and
// packs each run into two 32-bit words, the mirrored one byte-reversed
// (packed from its last lane down), so both are in address order. A planar
// row (element stride 1) starts at any byte offset: with e the address of
// x = 0 mod 8, the thread of forward chunk n writes the aligned 8-byte word
// that holds the last e bytes of chunk n - 1 (its lower neighbour lane's,
// by a shuffle) and the first 8 - e of its own, joined by a funnel shift;
// the mirrored run goes right to left across lanes, so with e' the address
// of x = w2 mod 8 the thread of mirrored chunk n writes the word that holds
// the last e' bytes of chunk n + 1 (its upper neighbour lane's) and the
// first 8 - e' of its own. The forward run is clipped to [0, he) and the
// mirrored one to [he, w2), so the word at x = he where they meet is written
// by both, each its own bytes. Words that are not whole inside their run
// (the row's ends, the word at he, and the one word at each end of a warp's
// run whose other part belongs to the next warp) go out in aligned pieces of
// 4, 2 and 1 bytes, so no byte outside [left1, left1 + w2) is touched. An
// interleaved destination (element stride 3) takes byte stores, a pixel a
// lane, in the same kernel, with the channel the grid's fastest index (as
// in clamp_cast_paste_q.cu). At the headline it takes 0.029 ms planar and
// 0.037 interleaved, cold, on an H100 80GB HBM3 at 700 W (chip_smoke.py,
// PERF.md section 6), against 0.051 and 0.055 for the first design (one
// pixel a thread: two scalar f32 loads, 64-bit index arithmetic and a byte
// store per pixel, the mirrored half reading again what the forward half
// read).
//
// Strips (the per-axis route's 122 rows of w2 = 2396: 3 x 3 x 16 blocks,
// fewer than two an SM): the same kernel with kStripParts chunks a thread,
// kSpan / 2 source lanes a warp, twice the blocks, each thread half the
// loads: 0.0032 ms in the strip frame's loop against 0.0036 with
// kParts (H100 80GB HBM3 at 700 W, chip_smoke.py).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fold.cuh"
#include "paste_words.cuh"

namespace {

constexpr int kParts = 2;               // 8-lane chunks a thread
constexpr int kStripParts = 1;          // on a strip
constexpr int kSpan = 32 * 8 * kParts;  // source lanes a warp
constexpr int kRows = 8;                // rows a block, one warp each
constexpr unsigned kFull = 0xffffffffu;

// Row bytes [lo, hi) that lie in the 8-byte word v at row offset `at` (an
// 8-aligned address): one 8-byte store when the word is whole.
__device__ __forceinline__ void store_clip(uint8_t* row, int at, uint2 v, int lo, int hi) {
  lo = max(lo, at);
  hi = min(hi, at + 8);
  if (lo >= hi) return;
  if (lo == at && hi == at + 8)
    *reinterpret_cast<uint2*>(row + at) = v;
  else
    store_part(row + at, v, lo - at, hi - at);
}

// Byte b (0 .. 7) of the chunk (w0, w1).
__device__ __forceinline__ uint8_t byte_of(uint32_t w0, uint32_t w1, int b) {
  return static_cast<uint8_t>((b < 4 ? w0 : w1) >> (8 * (b & 3)));
}

// Block (32, kRows): warp y writes row r = kRows blockIdx.z + y of channel
// blockIdx.x from source lanes [kSpan blockIdx.y, kSpan (blockIdx.y + 1)),
// kSpan = 256 kParts; lane l owns the chunks n = kSpan / 8 blockIdx.y + 32
// p + l (p < kParts).
template <bool kVec, int kParts>
__global__ void __launch_bounds__(32 * kRows)
unfold_clamp_paste_kernel(const float* __restrict__ e, const float* __restrict__ o, int hu,
                          int ep, uint8_t* __restrict__ dst, long long sc, long long sh,
                          long long sw, int top1, int left1, int h2, int w2) {
  constexpr int kSpan = 32 * 8 * kParts;
  const int r = blockIdx.z * kRows + threadIdx.y;
  if (r >= h2) return;  // the whole warp
  const int lane = threadIdx.x, c = blockIdx.x;
  const int span0 = kSpan * blockIdx.y;
  const int he = w2 - w2 / 2, ho = w2 / 2;
  const size_t base = ((size_t)c * hu + r) * ep;
  uint32_t fw[kParts][2], mw[kParts][2];  // forward, mirrored chunk words
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    const int k = span0 + 8 * (32 * p + lane);
    float4 s0, d0, s1, d1;
    unfold_lanes4<kVec>(e + base, o + base, k, he, s0, d0);
    unfold_lanes4<kVec>(e + base, o + base, k + 4, he, s1, d1);
    fw[p][0] = pack4(s0.x, s0.y, s0.z, s0.w);
    fw[p][1] = pack4(s1.x, s1.y, s1.z, s1.w);
    mw[p][0] = pack4(d1.w, d1.z, d1.y, d1.x);
    mw[p][1] = pack4(d0.w, d0.z, d0.y, d0.x);
  }
  if (sw != 1) {  // an interleaved destination: byte stores, a pixel a lane
    uint8_t* row = dst + c * sc + (long long)(top1 + r) * sh + left1 * sw;
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        // source lane k = span0 + 256 p + 32 t + lane: byte lane % 8 of the
        // forward chunk of lane 4 t + lane / 8, byte 7 - lane % 8 of its
        // mirrored chunk
        const int src = 4 * t + (lane >> 3), b = lane & 7;
        const uint32_t f0 = __shfl_sync(kFull, fw[p][0], src);
        const uint32_t f1 = __shfl_sync(kFull, fw[p][1], src);
        const uint32_t m0 = __shfl_sync(kFull, mw[p][0], src);
        const uint32_t m1 = __shfl_sync(kFull, mw[p][1], src);
        const int k = span0 + 256 * p + 32 * t + lane;
        if (k < he) row[k * sw] = byte_of(f0, f1, b);
        if (k < ho) row[(w2 - 1 - k) * sw] = byte_of(m0, m1, 7 - b);
      }
    }
    return;
  }
  uint8_t* row = dst + c * sc + (long long)(top1 + r) * sh + left1;
  const int ef = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 7);
  const int em = (ef + w2) & 7;
  // the forward run's lower neighbour (lane 0: lane 31's, of the previous
  // part) and the mirrored run's (lane 31: lane 0's, of the next part)
  uint32_t prev[kParts][2], next[kParts][2];
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      prev[p][i] = __shfl_sync(kFull, fw[p][i], (lane + 31) & 31);
      next[p][i] = __shfl_sync(kFull, mw[p][i], (lane + 1) & 31);
    }
  }
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    const int j = span0 + 8 * (32 * p + lane);  // forward chunk [j, j + 8)
    const int pb = p > 0 ? p - 1 : 0;           // constants: registers, selected by lane
    const int pn = p < kParts - 1 ? p + 1 : p;
    const bool back = lane == 0 && p > 0, ahead = lane == 31 && p < kParts - 1;
    const bool first = lane == 0 && p == 0;  // the chunk below is another warp's
    const bool last = lane == 31 && p == kParts - 1;
    const uint2 fv = join(back ? prev[pb][0] : prev[p][0], back ? prev[pb][1] : prev[p][1],
                          fw[p][0], fw[p][1], ef);
    store_clip(row, j - ef, fv, first ? j : 0, he);
    const int y = w2 - 8 - j;  // mirrored chunk [y, y + 8)
    const uint2 mv = join(ahead ? next[pn][0] : next[p][0], ahead ? next[pn][1] : next[p][1],
                          mw[p][0], mw[p][1], em);
    store_clip(row, y - em, mv, last ? max(he, y) : he, w2);
  }
  if (lane == 31 && ef != 0) {  // the last forward chunk's tail
    const int j1 = span0 + kSpan;
    store_clip(row, j1 - ef, join(fw[kParts - 1][0], fw[kParts - 1][1], 0u, 0u, ef), 0,
               min(he, j1));
  }
  if (lane == 0 && em != 0) {  // the first mirrored chunk's tail
    const int y1 = w2 - span0;  // its end
    store_clip(row, y1 - em, join(mw[0][0], mw[0][1], 0u, 0u, em), he, y1);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// e, o: (c, hu, ep) f32 contiguous, rows [0, h2) used.
// dst: u8 base pointer, element strides (sc, sh, sw) of its (C, H, W) view.
extern "C" int unfold_clamp_paste_launch(const void* e, const void* o, int c,
                                         int hu, int ep, void* dst, long long sc,
                                         long long sh, long long sw, int top1,
                                         int left1, int h2, int w2,
                                         void* stream) {
  if (c <= 0 || h2 <= 0 || w2 <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int he = w2 - w2 / 2;
  const int row_blocks = (h2 + kRows - 1) / kRows;
  // fewer than two blocks an SM (a strip): half the lanes a warp
  const bool strip = (long long)c * ((he + kSpan - 1) / kSpan) * row_blocks < 2LL * sms;
  const int span = strip ? 32 * 8 * kStripParts : kSpan;
  const dim3 block(32, kRows);
  const dim3 grid(c, (he + span - 1) / span, row_blocks);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ef = static_cast<const float*>(e);
  const auto* of = static_cast<const float*>(o);
  auto* d = static_cast<uint8_t*>(dst);
  const bool vec = ep % 4 == 0 && aligned16(e) && aligned16(o);
  if (vec && !strip)
    unfold_clamp_paste_kernel<true, kParts><<<grid, block, 0, st>>>(ef, of, hu, ep, d, sc, sh,
                                                                    sw, top1, left1, h2, w2);
  else if (!strip)
    unfold_clamp_paste_kernel<false, kParts><<<grid, block, 0, st>>>(ef, of, hu, ep, d, sc, sh,
                                                                     sw, top1, left1, h2, w2);
  else if (vec)
    unfold_clamp_paste_kernel<true, kStripParts><<<grid, block, 0, st>>>(
        ef, of, hu, ep, d, sc, sh, sw, top1, left1, h2, w2);
  else
    unfold_clamp_paste_kernel<false, kStripParts><<<grid, block, 0, st>>>(
        ef, of, hu, ep, d, sc, sh, sw, top1, left1, h2, w2);
  return static_cast<int>(cudaGetLastError());
}
