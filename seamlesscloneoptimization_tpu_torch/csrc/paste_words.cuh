// paste_words.cuh: the u8 word packing and the aligned-word stores shared by
// clamp_cast_paste_q.cu and unfold_clamp_paste.cu.
//
// A planar destination row starts at any byte offset, so those kernels pack
// 8 clamped, truncated pixels a thread into two 32-bit words (a chunk), join
// two neighbouring chunks across lanes into the aligned 8-byte word that
// straddles them, and write the words that are not whole inside the row in
// aligned pieces of 4, 2 and 1 bytes.

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
