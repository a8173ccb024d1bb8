// paste_words.cuh: the u8 word packing and the aligned-word stores shared by
// clamp_cast_paste.cu, clamp_cast_paste_q.cu, postprocess_transposed.cu and
// unfold_clamp_paste.cu.
//
// A planar destination row starts at any byte offset, so those kernels pack
// 8 clamped, truncated pixels a thread into two 32-bit words (a chunk), join
// two neighbouring chunks across lanes into the aligned 8-byte word that
// straddles them, and write the words that are not whole inside the row in
// aligned pieces of 4, 2 and 1 bytes. paste_run is that walk for a warp's
// forward run of chunks (all but unfold_clamp_paste, whose mirrored run
// joins the other way).

#pragma once

#include <stdint.h>

// clamp to [0, 255], then truncate (OpenCV's cast), never round
__device__ __forceinline__ uint32_t cast_byte(float v) {
  return static_cast<uint32_t>(static_cast<int>(fminf(fmaxf(v, 0.0f), 255.0f)));
}

// Four pixels -> the bytes of one 32-bit word, the first in the low byte.
__device__ __forceinline__ uint32_t pack4(float a, float b, float c, float d) {
  return cast_byte(a) | (cast_byte(b) << 8) | (cast_byte(c) << 16) | (cast_byte(d) << 24);
}

// The 8 bytes that start `8 - e` bytes into the 16 bytes p0 p1 q0 q1 (e in
// 0 .. 7): the aligned word whose first e bytes end chunk p and whose last
// 8 - e begin chunk q.
__device__ __forceinline__ uint2 join(uint32_t p0, uint32_t p1, uint32_t q0, uint32_t q1,
                                      int e) {
  const int sb = 8 - e, wq = sb >> 2, bs = 8 * (sb & 3);
  const uint32_t x0 = wq == 0 ? p0 : wq == 1 ? p1 : q0;
  const uint32_t x1 = wq == 0 ? p1 : wq == 1 ? q0 : q1;
  const uint32_t x2 = wq == 0 ? q0 : q1;  // read only when bs != 0 (wq <= 1)
  return make_uint2(__funnelshift_r(x0, x1, bs), __funnelshift_r(x1, x2, bs));
}

// Bytes [lo, hi) (0 <= lo < hi <= 8) of the 8-byte word v at the 8-aligned
// address a, in aligned pieces of 4, 2 and 1 bytes.
__device__ __forceinline__ void store_part(uint8_t* a, uint2 v, int lo, int hi) {
  const unsigned long long x = v.x | (static_cast<unsigned long long>(v.y) << 32);
  for (int o = lo; o < hi;) {
    if ((o & 3) == 0 && o + 4 <= hi) {
      *reinterpret_cast<uint32_t*>(a + o) = static_cast<uint32_t>(x >> (8 * o));
      o += 4;
    } else if ((o & 1) == 0 && o + 2 <= hi) {
      *reinterpret_cast<uint16_t*>(a + o) = static_cast<uint16_t>(x >> (8 * o));
      o += 2;
    } else {
      a[o] = static_cast<uint8_t>(x >> (8 * o));
      o += 1;
    }
  }
}

// Row [lo, hi) of the aligned word that holds row bytes [j - e, j - e + 8)
// (clipped to the row [0, w2)): one 8-byte store when it is whole.
__device__ __forceinline__ void store_word(uint8_t* row, int j, int e, uint2 v, int lo,
                                           int w2) {
  const int at = j - e, hi = min(w2, at + 8);
  lo = max(lo, 0);
  if (lo >= hi) return;
  if (lo == at && hi == at + 8)
    *reinterpret_cast<uint2*>(row + at) = v;
  else
    store_part(row + at, v, lo - at, hi - at);
}

// A warp writes columns [span0, span0 + 256 kParts) of one destination row
// (clipped to [0, w2)) from its chunks: lane l holds chunk n = 32 p + l,
// columns span0 + 8 n .. + 7, as the words own[p] (first pixel in the low
// byte). `row` is the address of the row's column 0, `sw` the element
// stride. A planar row (sw == 1) starts at any byte offset e = address mod
// 8, so the thread of chunk n writes the aligned 8-byte word that holds the
// last e bytes of chunk n - 1 (its neighbour lane's, by a shuffle) and the
// first 8 - e of its own, joined by a funnel shift; the word at each end of
// the run whose other part is another warp's, and the row's ends, go out in
// aligned pieces. An interleaved row takes byte stores, a pixel a lane, so
// a warp's store covers 32 sw contiguous bytes. Every lane of the warp
// calls it (shuffles).
template <int kParts>
__device__ __forceinline__ void paste_run(uint8_t* row, long long sw, int span0, int w2,
                                          const uint32_t (&own)[kParts][2]) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  if (sw != 1) {  // an interleaved destination: byte stores, a pixel a lane
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        // pixel 256 p + 32 t + lane of the warp's run: byte lane % 8 of the
        // chunk of lane 4 t + lane / 8
        const int src = 4 * t + (lane >> 3), b = lane & 7;
        const uint32_t w0 = __shfl_sync(kFull, own[p][0], src);
        const uint32_t w1 = __shfl_sync(kFull, own[p][1], src);
        const int j = span0 + 256 * p + 32 * t + lane;
        if (j < w2) row[j * sw] = static_cast<uint8_t>((b < 4 ? w0 : w1) >> (8 * (b & 3)));
      }
    }
    return;
  }
  const int e = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 7);
  // the previous lane's words (lane 0: lane 31's, of the previous part)
  uint32_t prev[kParts][2];
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    prev[p][0] = __shfl_sync(kFull, own[p][0], (lane + 31) & 31);
    prev[p][1] = __shfl_sync(kFull, own[p][1], (lane + 31) & 31);
  }
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    const int j0 = span0 + 8 * (32 * p + lane);
    const bool first = lane == 0 && p == 0;  // the chunk before is another warp's
    const int pb = p > 0 ? p - 1 : 0;  // constant: a register, selected by lane
    const bool back = lane == 0 && p > 0;
    const uint32_t q0 = back ? prev[pb][0] : prev[p][0];
    const uint32_t q1 = back ? prev[pb][1] : prev[p][1];
    store_word(row, j0, e, join(q0, q1, own[p][0], own[p][1], e), first ? j0 : j0 - e, w2);
  }
  if (lane == 31 && e != 0) {  // the last chunk's tail: the next warp's first word
    const int j1 = span0 + 256 * kParts;
    store_word(row, j1, e, join(own[kParts - 1][0], own[kParts - 1][1], 0u, 0u, e), j1 - e,
               min(w2, j1));
  }
}
