// preprocess_rhs_t: u8 destination and patch + eroded mask -> the Poisson
// right-hand side, transposed, at the origin of a zero-padded f32 slab.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:
// preprocess_rhs_transposed_pallas (bodies _fused_lap_tile, _pre_strip_kernel_t).
//
// out[c, x-1, y-1] = lap(y, x) for interior pixels, rhs_wide.cuh's integer
// arithmetic (exact); every other element of the (C, WPo, HPo) slab is
// written as an exact zero (the padded GEMM chain relies on it).
//
// Bound on this card: bytes. u8 destination, patch and mask read once,
// f32 slab written once (74.6 MB at the headline ROI, two thirds of it the
// store; 0.022 ms at 3.35 TB/s), ~30 integer operations per pixel. The
// first design (one block per channel and 32 x 32 tile, byte
// loads through 64-bit strides, the mask read again per channel, the
// guidance and the divergence as float passes through shared memory) took
// 0.109 ms. Design: one block of 32 x 8 threads for every channel of a
// 32-row x 128-column dense tile (rows r = y - 1 along the slab's minor
// axis; on a grid of fewer tiles than two an SM, a strip, one block a
// channel, each copying the mask). It stages the window rows of the mask
// once and of each channel's
// destination and patch in turn, as rhs_wide.cuh stages them (16-byte
// asynchronous copies from the aligned chunk below each row's first
// pixel, byte loads for an interleaved destination), in two channel
// buffers: a channel's rows land while the block computes and stores the
// one before. A thread computes the RHS of a 2 x 4 patch in each of two
// row passes (rhs_wide.cuh's arithmetic: NORMAL interiors two columns at
// a time in 16-bit lanes) and writes it into a shared [x][y] tile as two
// floats of one column; the tile's rows are XOR-swizzled by pairs so that
// these writes and the store's float4 reads are free of bank conflicts.
// The store writes each output line (fixed x) of the tile as one run of
// 32 floats, 8 float4 a line, so a warp writes four whole 128-byte lines.
// Tiles wholly in the padding write their zeros the same way and read
// nothing. It takes 0.063 ms at the headline on an H100 80GB HBM3 at
// 700 W (chip_smoke.py, PERF.md section 6): the staging alone 0.043 (34
// rows of 160 bytes from each of seven arrays a tile, read at about
// 1 TB/s), the arithmetic 0.016, the store 0.004. Copying every
// channel's windows up front (0.068) and a block walking a run of tiles
// with the next tile's copies in flight (0.077) measured slower.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include "rhs_wide.cuh"

namespace {

using namespace rhsw;

constexpr int kBX = 32, kBY = 8;     // block: 32 x 8 threads
constexpr int kNThreads = kBX * kBY;
constexpr int kTR = 32;              // dense rows a tile: the slab's minor axis
constexpr int kTC = 4 * kBX;         // 128 dense columns (4 a thread)
constexpr int kPassRows = 2 * kBY;   // 16 rows a pass, 2 passes
constexpr int kGranules = kTC * kTR / 4;  // float4 granules of a channel's tile
// NORMAL's resident blocks an SM: registers capped at 65536 / (256 x 4).
constexpr int kNormalBlocks = 4;

using Win = Rows<kTR + 2, 10>;  // 34 image rows; 160 bytes: 130 pixels from any shift

struct Smem {
  Win m;         // the mask
  Win dp[2][2];  // channel buffers: [b][0] the destination, [b][1] the patch
  float lap[kTC][kTR];  // [x - x0][(y - y0) ^ swizzle(x - x0)]
};

// The swizzle of tile row jj: XOR on bits 1 .. 4 of the y index keeps each
// pair (2i, 2i + 1) together and permutes a row's eight float4 granules
// (bits 2 .. 4) and the pairs inside each (bit 1).
__device__ __forceinline__ int swizzle(int jj) { return ((jj >> 2) & 15) << 1; }

// Row pass q of channel (D, P) of the tile at dense (r0, j0): the thread's
// 2 x 4 patch at window rows kPassRows q + 2 ty .., into the shared tile.
template <int kMode>
__device__ __forceinline__ void rhs_pass_t(const Win& mw, const Win& dw, const Win& pw,
                                           float (*lap)[kTR], int q, int h, int w, int r0,
                                           int j0) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int wr = kPassRows * q + 2 * ty;     // the patch's first window row
  const int y0 = r0 + wr, x0 = j0 + 4 * tx;  // its image (y, x)
  const bool packed = kMode == 0 &&
                      y0 >= 1 && y0 + 2 < h - 2 && x0 >= 1 && x0 + 4 < w - 2;
  uint32_t M[3][2], mm[3][3], D[4][2], P[4][2];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    row_words(mw, wr + a, tx, M[a]);
#pragma unroll
    for (int f = 0; f < 3; ++f) mm[a][f] = lane_mask(lanes(M[a], f));
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    row_words(dw, wr + a, tx, D[a]);
    row_words(pw, wr + a, tx, P[a]);
  }
  float l[2][4];
  if (packed)
    rhs_patch_packed(D, P, mm, l);
  else
    rhs_patch<kMode>(D, P, M, y0, x0, h, w, l);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int jj = 4 * tx + k;
    *reinterpret_cast<float2*>(&lap[jj][wr ^ swizzle(jj)]) = make_float2(l[0][k], l[1][k]);
  }
}

// The slab's lines x = j0 .. j0 + kTC - 1, rows r0 .. r0 + kTR - 1 of channel
// plane oc: granule i of the tile is line i / 8, rows 4 (i % 8) .. + 3,
// taken from the shared tile (or zeros when lap is null).
__device__ __forceinline__ void store_tile(const float* lap, float* __restrict__ oc,
                                           int wpo, int hpo, int r0, int j0, int tid) {
  for (int i = tid; i < kGranules; i += kNThreads) {
    const int jj = i >> 3, g = i & 7;
    const int j = j0 + jj, r = r0 + 4 * g;
    if (j >= wpo || r >= hpo) continue;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (lap != nullptr) {
      v = *reinterpret_cast<const float4*>(lap + jj * kTR + 4 * (g ^ ((jj >> 3) & 7)));
      if ((jj >> 2) & 1) v = make_float4(v.z, v.w, v.x, v.y);
    }
    *reinterpret_cast<float4*>(oc + (size_t)j * hpo + r) = v;
  }
}

// The arrays a block reads: the mask, and channel k's destination and patch.
struct Arrays {
  const uint8_t* dest;
  long long dsc, dsh, dsw;
  const uint8_t* patch;
  long long psc, psh, psw;
  const uint8_t* me;
};

// Start the copies of channel k's windows into buffer b (with the mask's,
// for a block's first channel) for the tile at dense (r0, j0).
__device__ __forceinline__ void stage_channel(Smem& s, const Arrays& in, int k, int b,
                                              bool mask, int h, int w, int r0, int j0,
                                              int tid) {
  const int skip = mask ? 0 : 1;
  const auto at = [&](int a) {
    a += skip;
    return a == 0 ? Slot<Win>{&s.m, Src{in.me, w, 1}}
                  : a == 1 ? Slot<Win>{&s.dp[b][0], Src{in.dest + k * in.dsc, in.dsh, in.dsw}}
                           : Slot<Win>{&s.dp[b][1], Src{in.patch + k * in.psc, in.psh, in.psw}};
  };
  stage_arrays<Win>(at, 3 - skip, h, w, r0, j0, tid, kNThreads);
}

// One block per 32 x 128 dense tile and group of cpb channels (blockIdx.z),
// its channels in turn: the mask and the first channel, then the second,
// are copied up front; channel k + 2's rows are copied into the buffer
// channel k leaves, while channel k is stored.
template <int kMode>
__global__ void __launch_bounds__(kNThreads, kMode == 0 ? kNormalBlocks : 1)
preprocess_rhs_t_kernel(Arrays in, float* __restrict__ out, int c, int cpb, int h, int w,
                        int wpo, int hpo) {
  __shared__ Smem s;
  const int j0 = blockIdx.x * kTC;  // dense index j = x - 1: the slab's major axis
  const int r0 = blockIdx.y * kTR;  // dense index r = y - 1: its minor axis
  const int tid = threadIdx.y * kBX + threadIdx.x;
  const size_t plane = (size_t)wpo * hpo;
  const int c0 = blockIdx.z * cpb, nc = min(cpb, c - c0);
  float* const oc = out + c0 * plane;
  if (r0 >= h - 2 || j0 >= w - 2) {  // the padding: zeros only
    for (int k = 0; k < nc; ++k)
      store_tile(nullptr, oc + k * plane, wpo, hpo, r0, j0, tid);
    return;
  }
  stage_channel(s, in, c0, 0, true, h, w, r0, j0, tid);
  acp::commit();
  if (nc > 1) stage_channel(s, in, c0 + 1, 1, false, h, w, r0, j0, tid);
  acp::commit();
  // one group committed a channel: channel k's is the one before last
  for (int k = 0; k < nc; ++k) {
    acp::wait<1>();
    __syncthreads();  // channel k has landed; the tile of channel k - 1 is stored
    const int b = k & 1;
#pragma unroll
    for (int q = 0; q < kTR / kPassRows; ++q)
      rhs_pass_t<kMode>(s.m, s.dp[b][0], s.dp[b][1], s.lap, q, h, w, r0, j0);
    __syncthreads();  // the tile is complete and buffer b free
    if (k + 2 < nc) stage_channel(s, in, c0 + k + 2, b, false, h, w, r0, j0, tid);
    acp::commit();
    store_tile(&s.lap[0][0], oc + k * plane, wpo, hpo, r0, j0, tid);
  }
}

}  // namespace

// dest/patch: u8 (C, h, w) views given by element strides (dsc, dsh, dsw),
// (psc, psh, psw); me: (h, w) u8 {0,1} contiguous; out: (c, wpo, hpo) f32
// contiguous, 16-byte aligned, with wpo >= w-2 and hpo >= h-2 a multiple of
// 4 (cudaErrorInvalidValue otherwise). flags: 1 NORMAL, 2 MIXED; norm_rule:
// 0 "opencv", 1 "norm".
extern "C" int preprocess_rhs_t_launch(
    const void* dest, long long dsc, long long dsh, long long dsw,
    const void* patch, long long psc, long long psh, long long psw,
    const void* me, void* out, int c, int h, int w, int wpo, int hpo,
    int flags, int norm_rule, void* stream) {
  if (c <= 0 || wpo <= 0 || hpo <= 0) return 0;
  if (hpo % 4 != 0 || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);  // the float4 lines
  // every channel in one block, unless that leaves fewer than two blocks
  // an SM (a strip): then one channel a block, the mask read per channel
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int tiles = ((wpo + kTC - 1) / kTC) * ((hpo + kTR - 1) / kTR);
  const int cpb = tiles >= 2 * sms ? c : 1;
  const dim3 block(kBX, kBY);
  const dim3 grid((wpo + kTC - 1) / kTC, (hpo + kTR - 1) / kTR, (c + cpb - 1) / cpb);
  const auto st = static_cast<cudaStream_t>(stream);
  const Arrays in{static_cast<const uint8_t*>(dest), dsc, dsh, dsw,
                  static_cast<const uint8_t*>(patch), psc, psh, psw,
                  static_cast<const uint8_t*>(me)};
  auto* o = static_cast<float*>(out);
  if (flags != 2)
    preprocess_rhs_t_kernel<0><<<grid, block, 0, st>>>(in, o, c, cpb, h, w, wpo, hpo);
  else if (norm_rule == 0)
    preprocess_rhs_t_kernel<1><<<grid, block, 0, st>>>(in, o, c, cpb, h, w, wpo, hpo);
  else
    preprocess_rhs_t_kernel<2><<<grid, block, 0, st>>>(in, o, c, cpb, h, w, wpo, hpo);
  return static_cast<int>(cudaGetLastError());
}
