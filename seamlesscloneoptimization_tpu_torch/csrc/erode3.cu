// erode3: three 3x3 erosions with a zero border of a u8 mask (any nonzero
// byte is inside), written as {0,1}.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:erode3_pallas
// (body _erode3_kernel).
//
// Three 3x3 min-erosions with zeros outside the domain equal one 7x7 min
// over the zero-extended mask (structuring elements compose), which is
// separable: a radius-3 vertical min, then a radius-3 horizontal min. On a
// mask of {0, nonzero} the min is an AND of bits: a lane packs 16 pixels
// of a row into 16 bits (a few word-wide instructions), ANDs 7 rows (3
// LOP3s), and takes the horizontal min (radius 1, then radius 2 on that)
// on 48 bits: its own and its neighbour lanes' 16.
//
// Bound on this card: bytes. One u8 read and one u8 write per pixel
// (7.4 MB at the 1550x2398 headline ROI, 0.0022 ms at 3.35 TB/s). The
// first design (one byte a thread through a 38x38 shared tile, ~15 shared
// byte loads an output) took 0.0205 ms in the headline frame, 0.056 at 8K;
// the same walk as below on bytes instead of bits was held by its ~140
// instructions an output row (PERF.md).
//
// Design: a block of kWarps warps owns kSpan = 464 output columns (29
// aligned 16-byte chunks of each output row); each warp owns kRW rows (8,
// 4 or 2: the most that still gives kFillBlocks blocks).
//  - Staging: a warp copies the input rows its rows need (3 above and
//    below) into shared memory, kChunks asynchronous 16-byte copies a row
//    from the aligned chunk that holds the row's column xs = x_span - kLead
//    (a row starts at any byte offset: w is 2398, 3800 or 124); chunks that
//    hold no pixel of the row, and rows outside [0, h), are zero-filled and
//    read nothing.
//  - Rows: lane l reads staged chunk l of a row and packs it to 16 bits,
//    bit j = (byte j != 0); with its right neighbour's 16 bits (a shuffle)
//    it shifts them across the row's byte shift, so that its bits are the
//    columns [xs + 16 l, + 16) of every row (a fixed column frame: the
//    7-row AND rolls in registers), zeroed outside [0, w).
//  - Output row: the 7-row AND, then the horizontal min on the 48 bits of
//    the left neighbour, the lane and the right neighbour (two shuffles).
//    Output row y starts at its own byte offset so; lane l writes output
//    chunk l - 1 of the row, whose columns [x_span - so + 16 (l - 1), + 16)
//    are bits 24 - so .. of those 48: one funnel shift, then 4 bits to 4
//    bytes of {0,1} by a multiply, and one aligned 16-byte store (aligned
//    8/4/2/1-byte pieces where the row's ends cut the chunk). Lanes 0, 30
//    and 31 write nothing: 0 and 30 lend their bits to lanes 1 and 29, so
//    each output chunk of a row belongs to exactly one block.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kWarps = 4;              // warps a block
constexpr int kR = 3;                  // 3 erosions: radius 3
constexpr int kSpan = 464;             // output columns a block (29 chunks)
constexpr int kLead = 24;              // lane 0's columns start kLead before the span
constexpr int kChunks = 32;            // staged 16-byte chunks a row
constexpr int kFillBlocks = 264;       // two blocks an SM of an H100
constexpr unsigned kFull = 0xffffffffu;

// The 16 pixels of a chunk as 16 bits, bit j = (byte j != 0): a byte's
// 0x80 = (b != 0) (no carry crosses a byte: (b & 0x7f) + 0x7f <= 0xfe),
// then a word's four 0x80 bits gathered into 4 bits by a multiply (the
// partial products land on distinct bits).
__device__ __forceinline__ uint32_t pack16(uint4 c) {
  const uint32_t x[4] = {c.x, c.y, c.z, c.w};
  uint32_t n[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t m = (((x[i] & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x[i]) & 0x80808080u;
    n[i] = (m * 0x00204081u) >> 28;
  }
  return (n[0] | (n[1] << 4)) | ((n[2] | (n[3] << 4)) << 8);
}

// Bits at .. at + 3 -> 4 bytes of {0,1}, bit j to byte j (again distinct
// partial products).
__device__ __forceinline__ uint32_t unpack4(uint32_t bits, int at) {
  return (((bits >> at) & 0xfu) * 0x00204081u) & 0x01010101u;
}

// Bytes [lo, hi) (0 <= lo < hi <= 16) of the 16-byte word v at the
// 16-aligned address a, in aligned pieces of 8, 4, 2 and 1 bytes (the
// words picked by selects: a runtime index into v would put it in local
// memory).
__device__ __forceinline__ void store_part(uint8_t* a, const uint32_t (&v)[4], int lo, int hi) {
  for (int o = lo; o < hi;) {
    const int wi = o >> 2;
    const uint32_t x = wi == 0 ? v[0] : wi == 1 ? v[1] : wi == 2 ? v[2] : v[3];
    if ((o & 7) == 0 && o + 8 <= hi) {
      *reinterpret_cast<uint2*>(a + o) = make_uint2(x, wi == 0 ? v[1] : v[3]);
      o += 8;
    } else if ((o & 3) == 0 && o + 4 <= hi) {
      *reinterpret_cast<uint32_t*>(a + o) = x;
      o += 4;
    } else if ((o & 1) == 0 && o + 2 <= hi) {
      *reinterpret_cast<uint16_t*>(a + o) = static_cast<uint16_t>(x >> (8 * (o & 3)));
      o += 2;
    } else {
      a[o] = static_cast<uint8_t>(x >> (8 * (o & 3)));
      o += 1;
    }
  }
}

template <int kRW>
__global__ void __launch_bounds__(32 * kWarps)
erode3_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, int h, int w) {
  constexpr int kRows = kRW + 2 * kR;  // staged rows a warp
  __shared__ uint4 band[kWarps][kRows][kChunks];
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const int x_span = blockIdx.x * kSpan;
  const int xs = x_span - kLead;  // lane 0's first column
  const int ys = (blockIdx.y * kWarps + wi) * kRW - kR;  // image row of staged row 0
  const uintptr_t ib = reinterpret_cast<uintptr_t>(in);
  const uintptr_t ob = reinterpret_cast<uintptr_t>(out);
  uint4 (&rows)[kRows][kChunks] = band[wi];

  // lane l copies chunk l of each row: the l-th aligned chunk from the one
  // that holds column xs of image row ys + t
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    const int y = ys + t;
    const uintptr_t row = ib + static_cast<uintptr_t>(static_cast<long long>(y) * w);
    const uintptr_t chunk = ((row + xs) & ~static_cast<uintptr_t>(15)) + 16 * lane;
    const bool ok = y >= 0 && y < h && chunk < row + w && chunk + 16 > row;
    acp::copy16(reinterpret_cast<float*>(&rows[t][lane]),
                reinterpret_cast<const float*>(ok ? chunk : ib), ok);
  }
  acp::commit();

  // the bits of this lane's 16 columns that lie in [0, w)
  const int xl = xs + 16 * lane;
  const uint32_t keep = xl >= w || xl + 16 <= 0
                            ? 0u
                            : (0xffffu >> max(0, xl + 16 - w)) & (0xffffu << max(0, -xl));
  // the byte shifts of staged row t and of output row t - 2 kR, advanced a
  // row at a time
  int sh = static_cast<int>((ib + static_cast<uintptr_t>(static_cast<long long>(ys) * w) + xs) &
                            15);
  int so = static_cast<int>(
      (ob + static_cast<uintptr_t>(static_cast<long long>(ys + kR) * w) + x_span) & 15);
  uint32_t win[2 * kR + 1] = {};  // the last 7 rows' bits
  acp::wait<0>();
  __syncwarp();
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    // staged chunk l holds columns xs - sh + 16 l ..: this lane's columns
    // are bits sh .. sh + 15 of its and the next lane's 16 bits
    const uint32_t p = pack16(rows[t][lane]);
    const uint32_t q = __shfl_down_sync(kFull, p, 1);
    const uint32_t v = ((p | (q << 16)) >> sh) & keep;
    sh = (sh + w) & 15;
#pragma unroll
    for (int k = 0; k < 2 * kR; ++k) win[k] = win[k + 1];
    win[2 * kR] = v;
    if (t < 2 * kR) continue;

    // output row yo = staged row t - kR: the vertical min of the 7 rows,
    // then the horizontal one on e = [left | this | right] (48 bits, the
    // low word lo and the high word hi)
    const int yo = ys + t - kR;
    const uint32_t c = win[0] & win[1] & win[2] & win[3] & win[4] & win[5] & win[6];
    const uint32_t lo = __byte_perm(__shfl_up_sync(kFull, c, 1), c, 0x5410);
    const uint32_t hi = __shfl_down_sync(kFull, c, 1);
    const uint32_t m1l = lo & __funnelshift_r(lo, hi, 1) & (lo << 1);
    const uint32_t m1h = hi & (hi >> 1) & __funnelshift_l(lo, hi, 1);
    const uint32_t m3l = m1l & __funnelshift_r(m1l, m1h, 2) & (m1l << 2);
    const uint32_t m3h = m1h & (m1h >> 2) & __funnelshift_l(m1l, m1h, 2);

    // output chunk lane - 1 of row yo: columns [x_span - so + 16 (lane - 1),
    // + 16), bits 24 - so .. of e
    const uint32_t bits = __funnelshift_r(m3l, m3h, 24 - so);
    const int c0 = x_span - so + 16 * (lane - 1);  // the chunk's first column
    so = (so + w) & 15;
    if (lane == 0 || lane >= 30 || yo >= h) continue;
    const uint32_t o[4] = {unpack4(bits, 0), unpack4(bits, 4), unpack4(bits, 8),
                           unpack4(bits, 12)};
    const uintptr_t orow = ob + static_cast<uintptr_t>(static_cast<long long>(yo) * w);
    uint8_t* dst = reinterpret_cast<uint8_t*>(orow + c0);
    if (c0 >= 0 && c0 + 16 <= w) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
      const int first = max(0, -c0), last = min(16, w - c0);
      if (first < last) store_part(dst, o, first, last);
    }
  }
}

template <int kRW>
void launch(const uint8_t* in, uint8_t* out, int h, int w, int gx, cudaStream_t s) {
  const dim3 grid(gx, (h + kWarps * kRW - 1) / (kWarps * kRW));
  erode3_kernel<kRW><<<grid, 32 * kWarps, 0, s>>>(in, out, h, w);
}

}  // namespace

extern "C" int erode3_launch(const void* mask, void* out, int h, int w, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  // a row of the output spans columns [-so, w) from its first aligned chunk
  const int gx = (w + 15 + kSpan - 1) / kSpan;
  const auto* in = static_cast<const uint8_t*>(mask);
  auto* o = static_cast<uint8_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  // the most rows a warp that still fills the card (short masks, the
  // per-axis strips, take fewer)
  if (gx * ((h + kWarps * 8 - 1) / (kWarps * 8)) >= kFillBlocks)
    launch<8>(in, o, h, w, gx, s);
  else if (gx * ((h + kWarps * 4 - 1) / (kWarps * 4)) >= kFillBlocks)
    launch<4>(in, o, h, w, gx, s);
  else
    launch<2>(in, o, h, w, gx, s);
  return static_cast<int>(cudaGetLastError());
}
