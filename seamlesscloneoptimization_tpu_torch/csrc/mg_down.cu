// mg_down: one multigrid level's descent, nu1 red-black sweeps + the residual
// + its (1/4, 1/2, 1/4) row restriction, in one pass.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:
// mg_down_pallas, padded_io form (bodies _mg_down_body, _mg_down_kernel_b,
// _mg_down_kernel_b0 for the known-zero guess).
//
// In: g, u (C, hp, wp) f32, true domain (h, w) at the origin, exact zeros
// elsewhere; u == nullptr is a known-zero guess (every coarse level), which
// the kernel synthesizes instead of reading, and whose first red half-sweep
// is (0 - g) * inv_d. Out: the swept u (C, hp, wp) and rh (C, rh_rows, wp):
//   r = g - (nsum(u) - diag * u) inside the domain, 0 outside (and below hp)
//   rh[j] = (0.25 r[2j] + 0.5 r[2j+1]) + 0.25 r[2j+2],   j < hp/2
//   even h, j = hc-1 (hc = (h-1)/2): rh[j] = (rh[j] + c1 r[2j+2]) + c2 r[2j+3],
//     the transpose of the beta-gap edge prolongation (c1, c2 from bh)
//   rh[j] = 0 for hp/2 <= j < rh_rows (the TPU leaves these rows unwritten;
//     here every element of both outputs is written).
// Arithmetic in the plain twin's order, bit-equal to it (mg_level.cuh).
//
// Bound on this card: bytes. g and u read once, u and rh written once: 18
// bytes per fine point, 454 MB for the 8K level-0 slab 3 x 2816 x 3840
// (0.136 ms at 3.35 TB/s); 14 bytes (g, u, rh) with a known-zero guess, 81 MB
// at the 8K "q" chain's coarse level 1 (3, 1920, 1408) (0.0245 ms).
// The first design (48 x 80 tiles of u and g, an 8-deep ring, synchronous
// 4-byte loads, every staged point swept, a divide per point, the residual
// through a third shared array) took 0.419 ms at level 0: staging and the
// stores 0.303, the sweeps 0.109, the residual 0.007 (PERF.md section 6).
// Design (DownTile): a block owns a 32 x 64 tile of one channel and stages
// g, and u unless it is known zero (then a shared tile of zeros), with
// asynchronous 16-byte copies (4-byte ones on odd-width slabs) and a ring
// only as deep as the sweeps need. The restriction reads the residual of
// the owned rows and the two below them, the last of those only as the
// even-h edge row h - 1, whose neighbour below lies outside the domain; so
// the block needs u exact at the end on N = the owned rows widened by one
// above and two below, and the owned columns widened by one. Half-sweep k
// of H = 2 nu1 updates N widened by H - k (cut to the domain), which reads
// N widened by H - k + 1, so the ring takes H + 1 rows above, H + 2 below
// and H + 1 columns a side (DownTile::kDepth). inv_diag's four quotients
// are computed once a block. One thread a column walks ten rows of the
// residual in registers and writes four rows of rh; u leaves shared memory in 16-byte stores. The
// zero rows of rh below hp/2 are spread over the tile rows of the grid.
// Level 0 now takes 0.205 ms (staging and the stores 0.183), coarse level 1
// 0.049 (0.037): the staging and the stores are 1.35x and 1.5x their bytes'
// bound; the sweeps and the residual follow the block's copies.
//
// The fused form, mg_down_t (vcycle_t's descent): the same tile, staging,
// sweeps and residual walk, followed by the lane-direction restriction of
// mg_restrict_t (Replaces: pallas_kernels.py: mg_restrict_t_pallas, body
// _restrict_t_kernel), so rh never leaves the block. Out: the swept u and
// rc_t (C, out_rows, hp2), bit-equal to mg_restrict_t(mg_down(..., rh_rows
// = hp2)[1], out_rows): for j < wc and l < hc
//   rc_t[j, l] = (a + 2 b) + a1,  a, b, a1 = rh[l, 2j], rh[l, 2j+1], rh[l, 2j+2]
//   even w, j = wc-1: ((a + 2 b) + c5 a1) + c6 rh[l, 2j+3]
// and exact zeros elsewhere (the next level's descent relies on them). The
// block keeps its 16 rows x 66 columns of rh in shared memory, even and odd
// columns apart (so the restriction's reads, a half-warp along l for each of
// two coarse columns, and the walk's writes are free of bank conflicts),
// and writes its 32 coarse columns x 16 lanes transposed, 64-byte runs
// along l. The last coarse column of a tile reads rh two columns past the
// tile, so rh takes two more columns, and u must be exact on N widened by
// one more column to the right (kDepthT): the second of those columns is
// read only as the even-w edge column w - 1, whose right neighbour lies
// outside the domain. The two columns are one warp's work, a lane a point
// of r and then a lane an rh value. The rc_t band that no tile covers
// (rows j >= 32 gridDim.x, lanes l >= 16 gridDim.y) is written as zeros,
// spread over the grid. Bound on this card: bytes. g (and u unless known
// zero) read once, u and rc_t written once: at the 8K "q" chain's coarse
// level 1 (3, 1920, 1408) with rc_t (3, 768, 1024), 74 MB (0.0222 ms at
// 3.35 TB/s) against 0.0325 ms for mg_down + mg_restrict_t apart. The
// kernel is bound by issue, not bytes: there (H100 80GB HBM3, 700 W, back
// to back) mg_down takes 0.044 ms without storing rh, and a first design
// whose extra columns 8 threads walked (the block waiting on them) took
// 0.0564, of it the walk 0.0072 and the restriction 0.0055; one warp's
// lanes bring it to 0.0490 against 0.0621 for the pair apart.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include "mg_level.cuh"

namespace {

using namespace mg;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// A 32 x 64 owned tile with kT rows of ring above, kB below, kL columns left
// and kR right (kT, kL even: the staged origin keeps the colours; kL, kCols
// multiples of 4: 16-byte copies). kDepth: the half-sweeps it keeps exact;
// kDepthT: the same for the fused form, whose N reaches one column further
// right.
template <int T, int B, int L, int R>
struct DownTile {
  static constexpr int kT = T, kB = B, kL = L, kR = R;
  static constexpr int kTH = 32, kTW = 64;
  static constexpr int kRows = kTH + T + B, kCols = kTW + L + R;
  static constexpr int kDepth = cmin(cmin(T - 1, B - 2), cmin(L - 1, R - 1));
  static constexpr int kDepthT = cmin(cmin(T - 1, B - 2), cmin(L - 1, R - 2));
  static constexpr int kLanes = kCols / 2;  // threads over one colour of a row
};
using Shallow = DownTile<4, 4, 4, 4>;  // 40 x 72, nu1 <= 1
using Deep = DownTile<6, 6, 8, 8>;     // 44 x 80, nu1 = 2

// The fused form's rh tile: 16 rows x 66 columns, even columns at [k][col /
// 2], odd ones kOdd further (a bank offset of 16 from the even ones).
constexpr int kRhW = 34;                  // a row's even (or odd) columns, padded
constexpr int kOdd = 16 * kRhW + 16;
constexpr int kRh = kOdd + 16 * kRhW;
constexpr int kExtraWarp = kThreads / 32 - 1;  // the warp that walks columns 64, 65

// One half-sweep of colour `color` over N widened by d (the header note; N
// reaches kRight columns right of the owned tile), one point a thread:
// u <- (nsum(u) - g) * inv_d, or (0 - g) * inv_d for the first red
// half-sweep of a known-zero guess. Ends with __syncthreads().
template <class T, int kRight>
__device__ __forceinline__ void half_sweep_down(float* su, const float* sg, const Level& L,
                                                const InvDiag& inv, int r0, int c0, int color,
                                                int d, bool zero_guess) {
  const int gr0 = r0 - T::kT, gc0 = c0 - T::kL;
  int rlo, rhi, clo, chi;
  band(r0 - 1 - d, r0 + T::kTH + 2 + d, L.h, gr0, T::kRows, rlo, rhi);
  band(c0 - 1 - d, c0 + T::kTW + kRight + d, L.w, gc0, T::kCols, clo, chi);
  constexpr int kPass = kThreads / T::kLanes;
  if ((int)threadIdx.x < kPass * T::kLanes) {
    const int j = threadIdx.x % T::kLanes;
    for (int lr = rlo + threadIdx.x / T::kLanes; lr < rhi; lr += kPass) {
      const int lc = 2 * j + ((color + lr) & 1);  // gr0, gc0 even: colour = (lr + lc) % 2
      if (lc < clo || lc >= chi) continue;
      const int gr = gr0 + lr, gc = gc0 + lc;
      const float n = zero_guess ? 0.0f : nsum_t<T::kCols>(su, L, lr, lc, gr, gc);
      su[lr * T::kCols + lc] = (n - sg[lr * T::kCols + lc]) * inv.at(L, gr, gc);
    }
  }
  __syncthreads();
}

// Issue the copies of the block's g and u (a shared tile of zeros for a
// known-zero guess) as one group.
template <class T>
__device__ __forceinline__ void stage_down(float* su, float* sg, const float* u, const float* g,
                                           int c, int hp, int wp, int r0, int c0, bool vec) {
  const int gr0 = r0 - T::kT, gc0 = c0 - T::kL;  // both even
  const size_t plane = (size_t)hp * wp;
  stage_async<T::kRows, T::kCols, kThreads>(sg, g + c * plane, hp, wp, wp, gr0, gc0, vec);
  if (u != nullptr)
    stage_async<T::kRows, T::kCols, kThreads>(su, u + c * plane, hp, wp, wp, gr0, gc0, vec);
  acp::commit();
  if (u == nullptr) {  // the known-zero guess, while g's copies land
    float4* s4 = reinterpret_cast<float4*>(su);
    for (int i = threadIdx.x; i < T::kRows * T::kCols / 4; i += kThreads)
      s4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// The nu1 sweeps: 2 nu1 half-sweeps over a band that shrinks by one a
// half-sweep.
template <class T, int kRight>
__device__ __forceinline__ void sweeps_down(float* su, const float* sg, const Level& L, int r0,
                                            int c0, int nu1, bool zero_guess) {
  const InvDiag inv(L);
  int d = 2 * nu1;
  for (int s = 0; s < nu1; ++s) {
    half_sweep_down<T, kRight>(su, sg, L, inv, r0, c0, 0, --d, zero_guess && s == 0);
    half_sweep_down<T, kRight>(su, sg, L, inv, r0, c0, 1, --d, false);
  }
}

// The residual down tile column cc (global gc) over owned-relative rows
// 8q .. 8q + 9 (the last one for the even-h edge row), and from it rh rows
// r0/2 + 4q .. + 3 into v.
template <class T>
__device__ __forceinline__ void rh_column(const float* su, const float* sg, const Level& L,
                                          int r0, int cc, int gc, int q, float c1, float c2,
                                          float v[4]) {
  constexpr int kC = T::kCols;
  const int lc = T::kL + cc;
  const bool col_in = gc < L.w;
  float r[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const int rr = 8 * q + i, gr = r0 + rr, lr = T::kT + rr;
    r[i] = 0.0f;
    if (col_in && gr < L.h) {
      const float uu = su[lr * kC + lc];
      r[i] = sg[lr * kC + lc] - (nsum_t<kC>(su, L, lr, lc, gr, gc) - diag(L, gr, gc) * uu);
    }
  }
  const int hc = (L.h - 1) / 2;
  const bool h_even = L.h % 2 == 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = r0 / 2 + 4 * q + k;
    v[k] = (0.25f * r[2 * k] + 0.5f * r[2 * k + 1]) + 0.25f * r[2 * k + 2];
    if (h_even && j == hc - 1) v[k] = (v[k] + c1 * r[2 * k + 2]) + c2 * r[2 * k + 3];
  }
}

// The fused form: rh rows 4q .. 4q + 3 of tile column col into srh.
template <class T>
__device__ __forceinline__ void rh_to_shared(float* srh, const float* su, const float* sg,
                                             const Level& L, int r0, int c0, int col, int q,
                                             float c1, float c2) {
  float v[4];
  rh_column<T>(su, sg, L, r0, col, c0 + col, q, c1, c2, v);
  float* s = srh + ((col & 1) ? kOdd : 0) + (col >> 1);
#pragma unroll
  for (int k = 0; k < 4; ++k) s[(4 * q + k) * kRhW] = v[k];
}

// The fused form: rh of tile columns 64 and 65 (the last coarse column
// reads them) by one warp, a lane a (column, row) of r into sx, then a
// lane a (column, rh row): ~100 instructions, where a thread a column
// walking as above took ~1000 (the block waited on 8 such threads).
template <class T>
__device__ __forceinline__ void rh_extra_columns(float* srh, float* sx, const float* su,
                                                 const float* sg, const Level& L, int r0,
                                                 int c0, float c1, float c2) {
  constexpr int kC = T::kCols, kR = T::kTH + 2;  // r rows 0 .. 33
  const int lane = threadIdx.x % 32;
  for (int i = lane; i < 2 * kR; i += 32) {
    const int col = T::kTW + (i & 1), rr = i >> 1;
    const int gr = r0 + rr, gc = c0 + col, lr = T::kT + rr, lc = T::kL + col;
    float r = 0.0f;
    if (gc < L.w && gr < L.h) {
      const float uu = su[lr * kC + lc];
      r = sg[lr * kC + lc] - (nsum_t<kC>(su, L, lr, lc, gr, gc) - diag(L, gr, gc) * uu);
    }
    sx[i] = r;
  }
  __syncwarp();
  const int odd = lane & 1, k = lane >> 1;  // rh row k of column 64 + odd
  const float* x = sx + odd;                // r row rr at x[2 rr]
  float v = (0.25f * x[4 * k] + 0.5f * x[4 * k + 2]) + 0.25f * x[4 * k + 4];
  if (L.h % 2 == 0 && r0 / 2 + k == (L.h - 1) / 2 - 1)
    v = (v + c1 * x[4 * k + 4]) + c2 * x[4 * k + 6];
  srh[(odd ? kOdd : 0) + k * kRhW + T::kTW / 2] = v;
}

// The owned tile of u, 16-byte stores where the slab allows.
template <class T>
__device__ __forceinline__ void store_u(const float* su, float* out, int hp, int wp, int r0,
                                        int c0, bool vec) {
  constexpr int kC = T::kCols;
  if (vec) {
    constexpr int kQuads = T::kTW / 4;
    for (int i = threadIdx.x; i < T::kTH * kQuads; i += kThreads) {
      const int rr = i / kQuads, c4 = 4 * (i % kQuads);
      const int gr = r0 + rr;
      if (gr < hp && c0 + c4 < wp)
        *reinterpret_cast<float4*>(&out[(size_t)gr * wp + c0 + c4]) =
            *reinterpret_cast<const float4*>(&su[(T::kT + rr) * kC + T::kL + c4]);
    }
  } else {
    for (int i = threadIdx.x; i < T::kTH * T::kTW; i += kThreads) {
      const int rr = i / T::kTW, cx = i % T::kTW;
      const int gr = r0 + rr;
      if (gr < hp && c0 + cx < wp) out[(size_t)gr * wp + c0 + cx] = su[(T::kT + rr) * kC + T::kL + cx];
    }
  }
}

// One block per (channel, 32 x 64 tile).
template <class T>
__global__ void __launch_bounds__(kThreads)
mg_down_kernel(const float* __restrict__ u, const float* __restrict__ g,
               float* __restrict__ u_out, float* __restrict__ rh, int hp, int wp,
               int rh_rows, int nu1, Level L, float c1, float c2, bool vec) {
  __shared__ __align__(16) float su[T::kRows * T::kCols];
  __shared__ __align__(16) float sg[T::kRows * T::kCols];

  const int c = blockIdx.z;
  const int r0 = blockIdx.y * T::kTH, c0 = blockIdx.x * T::kTW;
  stage_down<T>(su, sg, u, g, c, hp, wp, r0, c0, vec);
  // the zero rows of rh: row hp/2 + k by tile row k mod gridDim.y
  float* rhc = rh + (size_t)c * rh_rows * wp;
  const int cc = threadIdx.x % T::kTW, q = threadIdx.x / T::kTW;
  const int gc = c0 + cc;
  const int jz0 = hp / 2;
  for (int k = blockIdx.y + gridDim.y * q; k < rh_rows - jz0;
       k += gridDim.y * (kThreads / T::kTW))
    if (gc < wp) rhc[(size_t)(jz0 + k) * wp + gc] = 0.0f;
  acp::wait<0>();
  __syncthreads();

  sweeps_down<T, 1>(su, sg, L, r0, c0, nu1, u == nullptr);

  // rh rows r0/2 + 4q .. + 3 of column cc
  float v[4];
  rh_column<T>(su, sg, L, r0, cc, gc, q, c1, c2, v);
  if (gc < wp) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = r0 / 2 + 4 * q + k;
      if (j >= jz0) break;
      rhc[(size_t)j * wp + gc] = v[k];
    }
  }
  store_u<T>(su, u_out + c * (size_t)hp * wp, hp, wp, r0, c0, vec);
}

// The fused form: one block per (channel, 32 x 64 tile) as mg_down_kernel,
// rh kept in shared memory and restricted into rc_t's 32 coarse columns x
// 16 lanes of the tile.
template <class T>
__global__ void __launch_bounds__(kThreads)
mg_down_t_kernel(const float* __restrict__ u, const float* __restrict__ g,
                 float* __restrict__ u_out, float* __restrict__ rc_t, int hp, int wp, int hp2,
                 int out_rows, int nu1, Level L, float c1, float c2, float c5, float c6,
                 bool vec) {
  __shared__ __align__(16) float su[T::kRows * T::kCols];
  __shared__ __align__(16) float sg[T::kRows * T::kCols];
  __shared__ float srh[kRh];
  __shared__ float sx[2 * (T::kTH + 2)];

  const int c = blockIdx.z;
  const int r0 = blockIdx.y * T::kTH, c0 = blockIdx.x * T::kTW;
  stage_down<T>(su, sg, u, g, c, hp, wp, r0, c0, vec);
  // the zero band of rc_t that no tile covers: whole rows j >= jc, then
  // lanes l >= lz of the rows below jc, spread over the grid's blocks
  float* oc = rc_t + (size_t)c * out_rows * hp2;
  {
    const int jc = min((int)gridDim.x * (T::kTW / 2), out_rows);
    const int lz = min((int)gridDim.y * (T::kTH / 2), hp2);
    const size_t b = blockIdx.x + (size_t)gridDim.x * blockIdx.y;
    const size_t step = (size_t)gridDim.x * gridDim.y * kThreads;
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4* rows4 = reinterpret_cast<float4*>(oc + (size_t)jc * hp2);
    const size_t n_rows = (size_t)(out_rows - jc) * hp2 / 4;
    for (size_t i = b * kThreads + threadIdx.x; i < n_rows; i += step) rows4[i] = z;
    const int lanes4 = (hp2 - lz) / 4;
    const size_t n_lanes = (size_t)jc * lanes4;
    for (size_t i = b * kThreads + threadIdx.x; i < n_lanes; i += step) {
      const size_t j = i / lanes4;
      *reinterpret_cast<float4*>(oc + j * hp2 + lz + 4 * (i % lanes4)) = z;
    }
  }
  acp::wait<0>();
  __syncthreads();

  sweeps_down<T, 2>(su, sg, L, r0, c0, nu1, u == nullptr);

  // rh of the tile's 16 rows x 66 columns into srh: columns 0 .. 63 a
  // thread a column, 64 and 65 (read only where c0 + 64 < w) by one warp
  const int cc = threadIdx.x % T::kTW, q = threadIdx.x / T::kTW;
  rh_to_shared<T>(srh, su, sg, L, r0, c0, cc, q, c1, c2);
  if (threadIdx.x / 32 == kExtraWarp && c0 + T::kTW < L.w)
    rh_extra_columns<T>(srh, sx, su, sg, L, r0, c0, c1, c2);
  __syncthreads();

  // the lane restriction, transposed: coarse column j = c0/2 + jj, lane
  // l = r0/2 + ll, a half-warp along l for each of two coarse columns
  const int hc = (L.h - 1) / 2, wc = (L.w - 1) / 2;
  const bool w_even = L.w % 2 == 0;
  constexpr int kJ = T::kTW / 2, kLn = T::kTH / 2;
  {
    const int ll = threadIdx.x % kLn, l = r0 / 2 + ll;
    const float* e = srh + ll * kRhW;  // rh columns 2 jj, 2 jj + 2
    const float* o = e + kOdd;         // rh columns 2 jj + 1, 2 jj + 3
    float* dst = oc + l;
    if (l < hp2) {
#pragma unroll
      for (int p = 0; p < kJ * kLn / kThreads; ++p) {
        const int jj = threadIdx.x / kLn + p * (kThreads / kLn);
        const int j = c0 / 2 + jj;
        if (j >= out_rows) break;
        float v = 0.0f;
        if (j < wc && l < hc) {
          const float ab = e[jj] + 2.0f * o[jj];
          v = ab + e[jj + 1];
          if (w_even && j == wc - 1) v = (ab + c5 * e[jj + 1]) + c6 * o[jj + 1];
        }
        dst[(size_t)j * hp2] = v;
      }
    }
  }
  store_u<T>(su, u_out + c * (size_t)hp * wp, hp, wp, r0, c0, vec);
}

template <class T>
int launch_tile(const float* u, const float* g, float* u_out, float* rh, int c, int hp,
                int wp, int rh_rows, int nu1, const Level& L, float c1, float c2, bool vec,
                cudaStream_t stream) {
  const dim3 grid((wp + T::kTW - 1) / T::kTW, (hp + T::kTH - 1) / T::kTH, c);
  mg_down_kernel<T><<<grid, kThreads, 0, stream>>>(u, g, u_out, rh, hp, wp, rh_rows, nu1, L,
                                                   c1, c2, vec);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_tile_t(const float* u, const float* g, float* u_out, float* rc_t, int c, int hp,
                  int wp, int hp2, int out_rows, int nu1, const Level& L, float c1, float c2,
                  float c5, float c6, bool vec, cudaStream_t stream) {
  const dim3 grid((wp + T::kTW - 1) / T::kTW, (hp + T::kTH - 1) / T::kTH, c);
  mg_down_t_kernel<T><<<grid, kThreads, 0, stream>>>(u, g, u_out, rc_t, hp, wp, hp2, out_rows,
                                                     nu1, L, c1, c2, c5, c6, vec);
  return static_cast<int>(cudaGetLastError());
}

static_assert(Shallow::kDepth >= 2 && Deep::kDepth >= 4, "a ring shallower than its sweeps");
static_assert(Shallow::kDepthT >= 2 && Deep::kDepthT >= 4,
              "a ring shallower than the fused form's sweeps");

bool aligned16(const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; }

}  // namespace

// u (nullable: known-zero guess), g, u_out: (c, hp, wp) f32 contiguous;
// rh: (c, rh_rows, wp) f32 contiguous, rh_rows >= hp/2; hp even. (h, w):
// the true domain; nu1 <= 2; uniform: bh == bw == 1; cuh, cuw, dh, dw: the
// level constants (mg_level.cuh); c1, c2: the even-h edge weights.
extern "C" int mg_down_launch(const void* u, const void* g, void* u_out, void* rh,
                              int c, int hp, int wp, int rh_rows, int h, int w,
                              int nu1, int uniform, float cuh, float cuw, float dh,
                              float dw, float c1, float c2, void* stream) {
  if (c <= 0 || hp <= 0 || wp <= 0) return 0;
  if (nu1 < 0 || nu1 > 2) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = wp % 4 == 0 && aligned16(u) && aligned16(g) && aligned16(u_out);
  const Level L{h, w, uniform, cuh, cuw, dh, dw};
  const auto* uf = static_cast<const float*>(u);
  const auto* gf = static_cast<const float*>(g);
  auto* of = static_cast<float*>(u_out);
  auto* rf = static_cast<float*>(rh);
  const auto st = static_cast<cudaStream_t>(stream);
  if (nu1 <= 1)
    return launch_tile<Shallow>(uf, gf, of, rf, c, hp, wp, rh_rows, nu1, L, c1, c2, vec, st);
  return launch_tile<Deep>(uf, gf, of, rf, c, hp, wp, rh_rows, nu1, L, c1, c2, vec, st);
}

// The fused form. u, g, u_out as for mg_down_launch; rc_t: (c, out_rows,
// hp2) f32 contiguous, 16-byte aligned, hp2 a multiple of 4 and >= hp/2,
// out_rows >= wc; wp >= 2 wc + 2; c5, c6: the even-w edge weights.
extern "C" int mg_down_t_launch(const void* u, const void* g, void* u_out, void* rc_t,
                                int c, int hp, int wp, int hp2, int out_rows, int h, int w,
                                int nu1, int uniform, float cuh, float cuw, float dh,
                                float dw, float c1, float c2, float c5, float c6,
                                void* stream) {
  if (c <= 0 || hp <= 0 || wp <= 0) return 0;
  if (nu1 < 0 || nu1 > 2 || hp2 % 4 != 0 || 2 * hp2 < hp || !aligned16(rc_t))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = wp % 4 == 0 && aligned16(u) && aligned16(g) && aligned16(u_out);
  const Level L{h, w, uniform, cuh, cuw, dh, dw};
  const auto* uf = static_cast<const float*>(u);
  const auto* gf = static_cast<const float*>(g);
  auto* of = static_cast<float*>(u_out);
  auto* rf = static_cast<float*>(rc_t);
  const auto st = static_cast<cudaStream_t>(stream);
  if (nu1 <= 1)
    return launch_tile_t<Shallow>(uf, gf, of, rf, c, hp, wp, hp2, out_rows, nu1, L, c1, c2,
                                  c5, c6, vec, st);
  return launch_tile_t<Deep>(uf, gf, of, rf, c, hp, wp, hp2, out_rows, nu1, L, c1, c2, c5, c6,
                             vec, st);
}
