// unfold_transpose: unfold_minor fused with a windowed transpose.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:
// unfold_transpose_pallas (body _unfold_tp_kernel). The pair chain runs it
// twice a frame, after the inverse-h half-GEMMs: once for the even and once
// for the odd window of the grouped w spectrum, so the unfolded slab never
// reaches memory and the two outputs feed the inverse-w GEMMs whole.
//
// e, o: (C, M, ep); out (C, out_pad, rc):
//   out[c, x, r] = unfold_at(e[c, row_start + r], o[c, row_start + r], n, x)
// (fold.cuh), exact zeros for x >= n.
//
// Bound on this card: bytes. One f32 read of the he data lanes of e and of
// o per window row and one f32 write per output element (2 x 12 MB read,
// 26 MB written per 1280-row window of the (3, 2560, 896) headline pair).
//
// Design (whole tiles: rc a multiple of kT, ep of 4, every pointer 16-byte
// aligned, as on the chain, where every dimension is a multiple of 128):
// transpose_pair.cu's tile, on mirror pairs. A block of 256 threads owns
// source lanes k in [k0, k0 + kT) of kT window rows and loads e and o there
// once, as float4 along k (lanes from he on read as 0). It forms s = e + o,
// the output row x = k, and d = e - o, the output row x = n - 1 - k, and
// stores each into its own shared tile whose float4 unit (row, q) sits at
// column q ^ ((row >> 2) & 7) (an XOR swizzle on 16-byte units: the
// row-wise writes and the 4-row reads are free of bank conflicts). A thread
// then owns a 4 x 4 block of each tile: four float4 reads, a transpose in
// registers, and float4 stores along r, the s rows where k < he and the d
// rows where k < n / 2 (for odd n the middle lane has an s row only); the
// d rows of a block are one run of kT output rows in reverse order. Each
// element of e and o is read once. The rows x in [n, out_pad) are exact
// zeros and store-only: blocks of their own, past the lane tiles, write
// them. At the headline a window takes 0.023 ms cold on an H100 80GB HBM3
// at 700 W (chip_smoke.py, PERF.md section 6) against 0.040 for the first
// design: a 32 x 32 tile of 4-byte accesses that evaluated unfold_at per
// output element and so read every lane below n / 2 twice, from two
// blocks. Other shapes (windows of any length, an unaligned pointer) take
// that design, kept as unfold_transpose_ragged.
//
// Strips (the per-axis route's 2 x (3, 128, 1280) -> (3, 2432, 128): 20
// lane and zero tiles x 2 x 3, fewer than two blocks an SM):
// unfold_transpose_strip, the same walk on kTS = 32 window rows in 256
// threads, twice the blocks, each thread half the loads; after the
// barrier the block's first 128 threads store the s tile and the other 128
// the d tile. In the strip frame's loop it takes 0.0030 ms against the
// headline tile's 0.0034 (H100 80GB HBM3 at 700 W, chip_smoke.py).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fold.cuh"

namespace {

constexpr int kT = 64;                // tile: kT window rows x kT source lanes
constexpr int kQ = kT / 4;            // float4 units a tile row
constexpr int kThreads = 256;         // kQ x 16 threads
constexpr int kPass = kThreads / kQ;  // tile rows a load pass (16)
constexpr int kMinBlocks = 5;         // resident blocks an SM

__device__ __forceinline__ int swizzle(int row, int q) { return q ^ ((row >> 2) & 7); }

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Thread (r4 = t % 16, p4 = t / 16) of the store phase: tile rows 4 r4 ..
// 4 r4 + 3, float4 unit p4, transposed: v[i] holds lane 4 p4 + i of the
// four rows.
__device__ __forceinline__ void transposed(const float4 (*tile)[kQ], int r4, int p4,
                                           float4 (&v)[4]) {
  float4 s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = tile[4 * r4 + j][swizzle(4 * r4 + j, p4)];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = make_float4(at(s[0], i), at(s[1], i), at(s[2], i), at(s[3], i));
}

// Grid (lane_tiles + zero tiles, rc / kT, C): block x < lane_tiles owns
// source lanes [kT x, kT x + kT); block lane_tiles + z zeroes output rows
// [n + kT z, n + kT z + kT) (below out_pad) of the window's kT columns.
// kMinBlocks blocks an SM cap the registers at 48 (58 uncapped: 4 blocks,
// 1.7 waves of the headline's 900 blocks; 6 blocks spill).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
unfold_transpose_kernel(const float* __restrict__ e, const float* __restrict__ o,
                        float* __restrict__ out, int m, int ep, int n, int out_pad,
                        int row_start, int rc, int lane_tiles) {
  __shared__ float4 tile_s[kT][kQ];
  __shared__ float4 tile_d[kT][kQ];
  const int ci = blockIdx.z, r0 = blockIdx.y * kT;
  const int t = threadIdx.x, q = t % kQ, rr = t / kQ;
  float* oc = out + (size_t)ci * out_pad * rc + r0;
  if (blockIdx.x >= lane_tiles) {
    const int x0 = n + kT * (blockIdx.x - lane_tiles);
#pragma unroll
    for (int i = 0; i < kT / kPass; ++i) {
      const int x = x0 + rr + kPass * i;
      if (x < out_pad)
        *reinterpret_cast<float4*>(oc + (size_t)x * rc + 4 * q) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const int he = n - n / 2, ho = n / 2;
  const int k0 = blockIdx.x * kT;

  // load: thread (row rr + kPass i, unit q) of the tile
  float4 s[kT / kPass], d[kT / kPass];
#pragma unroll
  for (int i = 0; i < kT / kPass; ++i) {
    const size_t base = ((size_t)ci * m + row_start + r0 + rr + kPass * i) * ep;
    unfold_lanes4<true>(e + base, o + base, k0 + 4 * q, he, s[i], d[i]);
  }
#pragma unroll
  for (int i = 0; i < kT / kPass; ++i) {
    const int row = rr + kPass * i;
    tile_s[row][swizzle(row, q)] = s[i];
    tile_d[row][swizzle(row, q)] = d[i];
  }
  __syncthreads();

  // store: out[k][r0 + 4 r4 ..] = s, out[n - 1 - k][r0 + 4 r4 ..] = d for
  // the lanes k = k0 + 4 p4 + i
  const int r4 = t % 16, p4 = t / 16;
  float4 v[4];
  transposed(tile_s, r4, p4, v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * p4 + i;
    if (k < he) *reinterpret_cast<float4*>(oc + (size_t)k * rc + 4 * r4) = v[i];
  }
  transposed(tile_d, r4, p4, v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * p4 + i;
    if (k < ho) *reinterpret_cast<float4*>(oc + (size_t)(n - 1 - k) * rc + 4 * r4) = v[i];
  }
}

// The strip form: kTS window rows x kT source lanes, 256 threads. Load:
// thread (row t / kQ + kPass i, unit t % kQ), i < kTS / kPass; store: thread
// half h = t / 128 takes tile h (s, then d), tt = t % 128 the rows 4 (tt %
// 8) .. + 3 at unit tt / 8. Zero blocks write rows [n + kT z, + kT) of the
// window's kTS columns, a float4 a thread and row pass.
constexpr int kTS = 32;

__global__ void __launch_bounds__(kThreads)
unfold_transpose_strip(const float* __restrict__ e, const float* __restrict__ o,
                       float* __restrict__ out, int m, int ep, int n, int out_pad,
                       int row_start, int rc, int lane_tiles) {
  __shared__ float4 tile[2][kTS][kQ];
  const int ci = blockIdx.z, r0 = blockIdx.y * kTS;
  const int t = threadIdx.x, q = t % kQ, rr = t / kQ;
  float* oc = out + (size_t)ci * out_pad * rc + r0;
  if (blockIdx.x >= lane_tiles) {
    const int x0 = n + kT * (blockIdx.x - lane_tiles);
    const int zq = t % (kTS / 4), zr = t / (kTS / 4);  // 8 units x 32 rows a pass
#pragma unroll
    for (int i = 0; i < kT / (kThreads / (kTS / 4)); ++i) {
      const int x = x0 + zr + (kThreads / (kTS / 4)) * i;
      if (x < out_pad)
        *reinterpret_cast<float4*>(oc + (size_t)x * rc + 4 * zq) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  const int he = n - n / 2, ho = n / 2;
  const int k0 = blockIdx.x * kT;
  float4 s[kTS / kPass], d[kTS / kPass];
#pragma unroll
  for (int i = 0; i < kTS / kPass; ++i) {
    const size_t base = ((size_t)ci * m + row_start + r0 + rr + kPass * i) * ep;
    unfold_lanes4<true>(e + base, o + base, k0 + 4 * q, he, s[i], d[i]);
  }
#pragma unroll
  for (int i = 0; i < kTS / kPass; ++i) {
    const int row = rr + kPass * i;
    tile[0][row][swizzle(row, q)] = s[i];
    tile[1][row][swizzle(row, q)] = d[i];
  }
  __syncthreads();

  const int half = t / 128, tt = t % 128, r4 = tt % 8, p4 = tt / 8;
  float4 v[4];
  transposed(tile[half], r4, p4, v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * p4 + i;
    if (half == 0 && k < he)
      *reinterpret_cast<float4*>(oc + (size_t)k * rc + 4 * r4) = v[i];
    if (half == 1 && k < ho)
      *reinterpret_cast<float4*>(oc + (size_t)(n - 1 - k) * rc + 4 * r4) = v[i];
  }
}

// Any shape: a 32 x 32 tile of 4-byte accesses, rows padded to 33 floats;
// the load phase evaluates unfold_at per output element with threads along
// x, the store phase writes along r.
constexpr int kRagged = 32;
constexpr int kRaggedRows = 8;  // blockDim.y

__global__ void unfold_transpose_ragged(const float* __restrict__ e,
                                        const float* __restrict__ o,
                                        float* __restrict__ out, int m, int ep,
                                        int n, int out_pad, int row_start,
                                        int rc) {
  __shared__ float tile[kRagged][kRagged + 1];
  const int ci = blockIdx.z;
  const int r0 = blockIdx.y * kRagged;
  const int x0 = blockIdx.x * kRagged;

  const int x = x0 + threadIdx.x;
  for (int i = threadIdx.y; i < kRagged; i += kRaggedRows) {
    const int r = r0 + i;
    if (r < rc && x < out_pad) {
      const size_t base = ((size_t)ci * m + row_start + r) * ep;
      tile[i][threadIdx.x] = unfold_at(e + base, o + base, n, x);
    }
  }
  __syncthreads();

  float* oc = out + (size_t)ci * out_pad * rc;
  const int r = r0 + threadIdx.x;
  for (int j = threadIdx.y; j < kRagged; j += kRaggedRows) {
    const int xj = x0 + j;
    if (xj < out_pad && r < rc) oc[(size_t)xj * rc + r] = tile[threadIdx.x][j];
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// e, o: (c, m, ep) f32 contiguous; out: (c, out_pad, rc).
extern "C" int unfold_transpose_launch(const void* e, const void* o, void* out,
                                       int c, int m, int ep, int n, int out_pad,
                                       int row_start, int rc, void* stream) {
  if (c <= 0 || rc <= 0 || out_pad <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ef = static_cast<const float*>(e);
  const float* of = static_cast<const float*>(o);
  float* outf = static_cast<float*>(out);
  if (rc % kT == 0 && ep % 4 == 0 && aligned16(e) && aligned16(o) && aligned16(out)) {
    const int lane_tiles = (n - n / 2 + kT - 1) / kT;
    const int zero_tiles = (out_pad - n + kT - 1) / kT;
    if ((long long)(lane_tiles + zero_tiles) * (rc / kT) * c < 2LL * sms) {
      const dim3 grid(lane_tiles + zero_tiles, rc / kTS, c);  // a strip
      unfold_transpose_strip<<<grid, kThreads, 0, s>>>(ef, of, outf, m, ep, n, out_pad,
                                                       row_start, rc, lane_tiles);
    } else {
      const dim3 grid(lane_tiles + zero_tiles, rc / kT, c);
      unfold_transpose_kernel<<<grid, kThreads, 0, s>>>(ef, of, outf, m, ep, n, out_pad,
                                                        row_start, rc, lane_tiles);
    }
  } else {
    const dim3 grid((out_pad + kRagged - 1) / kRagged, (rc + kRagged - 1) / kRagged, c);
    unfold_transpose_ragged<<<grid, dim3(kRagged, kRaggedRows), 0, s>>>(
        ef, of, outf, m, ep, n, out_pad, row_start, rc);
  }
  return static_cast<int>(cudaGetLastError());
}
