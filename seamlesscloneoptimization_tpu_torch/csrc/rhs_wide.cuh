// rhs_wide.cuh: the Poisson right-hand side of a 2 x 4 patch of interior
// pixels a thread, from u8 rows staged in shared memory as 32-bit words;
// the design of preprocess_rhs_q.cu and preprocess_rhs_p.cu and, with
// one-array windows (Rows, at the end), of preprocess_rhs_t.cu.
//
// The function (the TPU kernels' _fused_lap_tile): for the (h, w) ROI and
// its interior pixel (y, x), gx/gy the forward differences of the
// destination d and the patch p (0 in the last column / row), MIXED
// replacing the patch's by the destination's where take_d, blended by the
// eroded {0,1} mask, then
//   lap = (gx[y][x] - gx[y][x-1]) + (gy[y][x] - gy[y-1][x])
// minus d's Dirichlet border pixel on the rows/cols next to it, 0 outside
// the interior. Every value is an integer of magnitude < 2^11, so the
// kernel computes it in int32 and converts once: exact, bit-equal to the
// plain twin's float arithmetic in any order.
//
// Staging (stage_rows): a block's window is kWinR image rows of the mask
// and of every channel's destination and patch, copied in two groups: the
// rows of the first row pass, then the rest, which land while the block
// computes the first pass. Where a row's pixels are contiguous (element
// stride 1: the planar serve buffer, the patch, the mask, the stride-0
// gray patch) the row lands as kChunks asynchronous
// 16-byte copies from the aligned chunk that holds its first pixel, so it
// starts `shift` bytes into its shared row (the ROI's origin is at any
// byte offset); only chunks that hold a pixel of the row are read, the rest
// are zero-filled, so no copy leaves the row's allocation (whose 16-byte
// chunks are whole). Other strides (an interleaved destination) load byte
// by byte in the same loop into words at shift 0. A thread reads its two
// words of a row (pixels x0 .. x0 + 7) across the row's shift with a
// funnel shift. Pixels past the row's end (x >= w) may hold the next bytes
// of the image and rows past h hold 0: neither reaches an interior output
// (the gradients there are masked and the outputs zero).
//
// Arithmetic: a NORMAL patch inside the interior (no edge test applies)
// takes rhs_patch_packed, two columns a lane pair in 32-bit words; MIXED,
// and any patch that touches the frame, the last row or column or the
// interior's border, takes rhs_patch, one pixel at a time with every test.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace rhsw {

constexpr int kTX = 64, kTY = 4;        // block: 64 x 4 threads
constexpr int kThreads = kTX * kTY;
constexpr int kPasses = 2;             // row passes a block: 2 rows a thread each
constexpr int kPassR = 2 * kTY;         // 8 dense rows a pass
constexpr int kTileR = kPasses * kPassR;  // 16 dense rows a block
constexpr int kTileC = 4 * kTX;         // 256 dense columns (4 a thread)
constexpr int kWinR = kTileR + 2;       // image rows r0 .. r0 + 17
constexpr int kChunks = 18;             // 16-byte chunks: 260 bytes from any shift
constexpr int kPitch = 4 * kChunks;     // words a staged row
constexpr int kMaxC = 3;                // channels a block

// A u8 (rows, w) array: base of its row 0, row and element strides.
struct Src {
  const uint8_t* base;
  long long sh, sw;
};

// The bytes of pixels x0 .. x0 + 3 of row y (0 past w), for strides != 1.
__device__ __forceinline__ uint32_t load_bytes(const Src& a, int y, int x0, int w) {
  const uint8_t* row = a.base + y * a.sh;
  uint32_t v = 0u;
  for (int b = 0; b < 4; ++b)
    if (x0 + b < w) v |= static_cast<uint32_t>(row[(x0 + b) * a.sw]) << (8 * b);
  return v;
}

// The arrays a block stages: 0 the mask, 1 .. nc the destination's
// channels, nc + 1 .. 2 nc the patch's.
struct Inputs {
  Src m, d, p;          // d, p: the block's first channel
  long long dsc, psc;   // channel strides
  int nc;
  __device__ __forceinline__ Src at(int a) const {
    if (a == 0) return m;
    if (a <= nc) return Src{d.base + (a - 1) * dsc, d.sh, d.sw};
    return Src{p.base + (a - 1 - nc) * psc, p.sh, p.sw};
  }
};

// A block's staged windows: per array (0 the mask, then nc destination and
// nc patch channels) kWinR rows of kPitch words, each row starting `shift`
// bytes in.
struct Window {
  uint32_t w[2 * kMaxC + 1][kWinR][kPitch];
  uint8_t shift[2 * kMaxC + 1][kWinR];
};

// Start the copies of window rows [lo, lo + kRows) (image rows r0 + lo ..,
// pixels from j0) of the 1 + 2 nc arrays into s; the caller commits them
// as one group.
template <int kRows>
__device__ __forceinline__ void stage_rows(Window& s, const Inputs& in, int h, int w, int r0,
                                           int j0, int lo) {
  const int tid = threadIdx.y * kTX + threadIdx.x;
  for (int i = tid; i < (1 + 2 * in.nc) * kRows * kChunks; i += kThreads) {
    const int a = i / (kRows * kChunks), rest = i % (kRows * kChunks);
    const int ry = lo + rest / kChunks, k = rest % kChunks;
    const int y = r0 + ry;
    const Src src = in.at(a);
    uint32_t* dst = &s.w[a][ry][4 * k];
    if (src.sw == 1) {
      const uint8_t* p = src.base + y * src.sh + j0;
      const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
      const uint8_t* chunk = p - sh + 16 * k;  // pixels j0 - sh + 16 k ..
      const bool ok = y < h && j0 - sh + 16 * k < w;
      acp::copy16(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(chunk), ok);
      if (k == 0) s.shift[a][ry] = static_cast<uint8_t>(sh);
    } else {
      for (int m = 0; m < 4; ++m)
        dst[m] = y < h ? load_bytes(src, y, j0 + 16 * k + 4 * m, w) : 0u;
      if (k == 0) s.shift[a][ry] = 0;
    }
  }
}

// The thread's two words of window row ry of array a (pixels x0 .. x0 + 7,
// x0 = j0 + 4 tx), joined across the row's shift.
__device__ __forceinline__ void row_words(const Window& s, int a, int ry, int tx,
                                          uint32_t (&v)[2]) {
  const int shift = s.shift[a][ry];
  const int wi = (shift >> 2) + tx, bs = 8 * (shift & 3);
  const uint32_t w0 = s.w[a][ry][wi], w1 = s.w[a][ry][wi + 1], w2 = s.w[a][ry][wi + 2];
  v[0] = __funnelshift_r(w0, w1, bs);
  v[1] = __funnelshift_r(w1, w2, bs);
}

__device__ __forceinline__ int byte_at(const uint32_t (&v)[2], int b) {
  return static_cast<int>((v[b >> 2] >> (8 * (b & 3))) & 0xffu);
}

// The RHS of the thread's 2 x 4 interior pixels (y0 + 1 + i, x0 + 1 + k),
// i < 2, k < 4, into lap[i][k], in int32 one pixel at a time. D, P: the
// thread's four window rows y0 .. y0 + 3 (columns x0 .. x0 + 7, of which x0 .. x0 + 5 are read), M: the
// mask's rows y0 .. y0 + 2. mode: 0 NORMAL, 1 MIXED "opencv", 2 MIXED
// "norm".
template <int kMode>
__device__ __forceinline__ void rhs_patch(const uint32_t (&D)[4][2], const uint32_t (&P)[4][2],
                                          const uint32_t (&M)[3][2], int y0, int x0, int h,
                                          int w, float (&lap)[2][4]) {
  int gx[3][5], gy[3][5];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 5; ++b) {
      if (a == 0 && b == 0) continue;  // read by no output
      int dx = byte_at(D[a], b + 1) - byte_at(D[a], b);
      int dy = byte_at(D[a + 1], b) - byte_at(D[a], b);
      int px = byte_at(P[a], b + 1) - byte_at(P[a], b);
      int py = byte_at(P[a + 1], b) - byte_at(P[a], b);
      if (x0 + b >= w - 1) dx = px = 0;
      if (y0 + a >= h - 1) dy = py = 0;
      if (kMode != 0) {
        const bool take_d = kMode == 2 ? px * px + py * py < dx * dx + dy * dy
                                       : abs(px - py) <= abs(dx - dy);
        if (take_d) {
          px = dx;
          py = dy;
        }
      }
      const bool m = byte_at(M[a], b) != 0;
      gx[a][b] = m ? px : dx;
      gy[a][b] = m ? py : dy;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int a = i + 1, b = k + 1;
      int v = (gx[a][b] - gx[a][b - 1]) + (gy[a][b] - gy[a - 1][b]);
      const int y = y0 + a, x = x0 + b;
      if (y > h - 2 || x > w - 2) {
        v = 0;
      } else {
        if (y == 1) v -= byte_at(D[a - 1], b);
        if (y == h - 2) v -= byte_at(D[a + 1], b);
        if (x == 1) v -= byte_at(D[a], b - 1);
        if (x == w - 2) v -= byte_at(D[a], b + 1);
      }
      lap[i][k] = static_cast<float>(v);
    }
  }
}

// Bytes f and f + 2 of the 8 bytes v[0]:v[1] as two 16-bit lanes.
__device__ __forceinline__ uint32_t lanes(const uint32_t (&v)[2], int f) {
  return __funnelshift_r(v[0], v[1], 8 * f) & 0x00ff00ffu;
}

// Lanes of all ones where the mask's byte lane is not 0.
__device__ __forceinline__ uint32_t lane_mask(uint32_t q) {
  return (((q + 0x00ff00ffu) >> 8) & 0x00010001u) * 0xffffu;
}

__device__ __forceinline__ uint32_t blend(uint32_t m, uint32_t p, uint32_t d) {
  return (p & m) | (d & ~m);
}

// rhs_patch<NORMAL, false> two columns at a time: lanes hold columns b and
// b + 2 in 16 bits. A difference of bytes is kept as 256 + d (b - a + 256
// never borrows across lanes), so the mask blends whole lanes and the
// divergence (gx(b) + gy(b) + 1024) - gx(b - 1) - gy_above(b) stays in
// [4, 2044] at every step: lane = lap + 1024, exact. The masks mm[a][f]
// (lane_mask of the mask's lanes f of row a) are the caller's, once for
// every channel.
__device__ __forceinline__ void rhs_patch_packed(const uint32_t (&D)[4][2],
                                                 const uint32_t (&P)[4][2],
                                                 const uint32_t (&mm)[3][3],
                                                 float (&lap)[2][4]) {
  constexpr uint32_t kB = 0x01000100u, kL = 0x04000400u;
  uint32_t gy13[3], gy24[3];  // gy at columns 1, 3 and 2, 4 of rows 0 .. 2
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    gy13[a] = blend(mm[a][1], lanes(P[a + 1], 1) + kB - lanes(P[a], 1),
                    lanes(D[a + 1], 1) + kB - lanes(D[a], 1));
    gy24[a] = blend(mm[a][2], lanes(P[a + 1], 2) + kB - lanes(P[a], 2),
                    lanes(D[a + 1], 2) + kB - lanes(D[a], 2));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int a = i + 1;
    uint32_t pq[4], dq[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      pq[f] = lanes(P[a], f);
      dq[f] = lanes(D[a], f);
    }
    const uint32_t gx02 = blend(mm[a][0], pq[1] + kB - pq[0], dq[1] + kB - dq[0]);
    const uint32_t gx13 = blend(mm[a][1], pq[2] + kB - pq[1], dq[2] + kB - dq[1]);
    const uint32_t gx24 = blend(mm[a][2], pq[3] + kB - pq[2], dq[3] + kB - dq[2]);
    const uint32_t l13 = ((gx13 + gy13[a] + kL) - gx02) - gy13[a - 1];
    const uint32_t l24 = ((gx24 + gy24[a] + kL) - gx13) - gy24[a - 1];
    lap[i][0] = static_cast<float>(static_cast<int>(l13 & 0xffffu) - 1024);
    lap[i][2] = static_cast<float>(static_cast<int>(l13 >> 16) - 1024);
    lap[i][1] = static_cast<float>(static_cast<int>(l24 & 0xffffu) - 1024);
    lap[i][3] = static_cast<float>(static_cast<int>(l24 >> 16) - 1024);
  }
}

// -- one array a window: preprocess_rhs_t.cu's staging ----------------------
//
// The transposed kernel stages each array into a window of its own (the
// mask, then every channel's destination and patch): kR rows of kC 16-byte
// chunks, each row starting `shift` bytes in, copied as stage_rows copies.

template <int kR, int kC>
struct __align__(16) Rows {
  static constexpr int kRows = kR, kRowChunks = kC;
  uint32_t w[kR][4 * kC];
  uint8_t shift[kR];
};

// A window and the array it stages.
template <class Win>
struct Slot {
  Win* win;
  Src src;
};

// Start the copies of rows [0, kRows) (image rows r0 .., pixels from j0) of
// the n arrays at(0) .. at(n - 1) (each a Slot<Win>), spread over the
// block's nthr threads; the caller commits them as one group.
template <class Win, class At>
__device__ __forceinline__ void stage_arrays(const At& at, int n, int h, int w, int r0, int j0,
                                             int tid, int nthr) {
  constexpr int kR = Win::kRows, kC = Win::kRowChunks;
  for (int i = tid; i < n * kR * kC; i += nthr) {
    const int a = i / (kR * kC), rest = i % (kR * kC);
    const int ry = rest / kC, k = rest % kC;
    const int y = r0 + ry;
    const Slot<Win> sl = at(a);
    uint32_t* dst = &sl.win->w[ry][4 * k];
    if (sl.src.sw == 1) {
      const uint8_t* p = sl.src.base + y * sl.src.sh + j0;
      const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
      const uint8_t* chunk = p - sh + 16 * k;
      const bool ok = y < h && j0 - sh + 16 * k < w;
      acp::copy16(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(chunk), ok);
      if (k == 0) sl.win->shift[ry] = static_cast<uint8_t>(sh);
    } else {
      for (int m = 0; m < 4; ++m)
        dst[m] = y < h ? load_bytes(sl.src, y, j0 + 16 * k + 4 * m, w) : 0u;
      if (k == 0) sl.win->shift[ry] = 0;
    }
  }
}

// row_words on a one-array window.
template <int kR, int kC>
__device__ __forceinline__ void row_words(const Rows<kR, kC>& s, int ry, int tx,
                                          uint32_t (&v)[2]) {
  const int shift = s.shift[ry];
  const int wi = (shift >> 2) + tx, bs = 8 * (shift & 3);
  const uint32_t w0 = s.w[ry][wi], w1 = s.w[ry][wi + 1], w2 = s.w[ry][wi + 2];
  v[0] = __funnelshift_r(w0, w1, bs);
  v[1] = __funnelshift_r(w1, w2, bs);
}

}  // namespace rhsw
