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
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include "mg_level.cuh"

namespace {

using namespace mg;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// A 32 x 64 owned tile with kT rows of ring above, kB below, kL columns left
// and kR right (kT, kL even: the staged origin keeps the colours; kL, kCols
// multiples of 4: 16-byte copies). kDepth: the half-sweeps it keeps exact.
template <int T, int B, int L, int R>
struct DownTile {
  static constexpr int kT = T, kB = B, kL = L, kR = R;
  static constexpr int kTH = 32, kTW = 64;
  static constexpr int kRows = kTH + T + B, kCols = kTW + L + R;
  static constexpr int kDepth = cmin(cmin(T - 1, B - 2), cmin(L - 1, R - 1));
  static constexpr int kLanes = kCols / 2;  // threads over one colour of a row
};
using Shallow = DownTile<4, 4, 4, 4>;  // 40 x 72, nu1 <= 1
using Deep = DownTile<6, 6, 8, 8>;     // 44 x 80, nu1 = 2

// One half-sweep of colour `color` over N widened by d (the header note),
// one point a thread: u <- (nsum(u) - g) * inv_d, or (0 - g) * inv_d for the
// first red half-sweep of a known-zero guess. Ends with __syncthreads().
template <class T>
__device__ __forceinline__ void half_sweep_down(float* su, const float* sg, const Level& L,
                                                const InvDiag& inv, int r0, int c0, int color,
                                                int d, bool zero_guess) {
  const int gr0 = r0 - T::kT, gc0 = c0 - T::kL;
  int rlo, rhi, clo, chi;
  band(r0 - 1 - d, r0 + T::kTH + 2 + d, L.h, gr0, T::kRows, rlo, rhi);
  band(c0 - 1 - d, c0 + T::kTW + 1 + d, L.w, gc0, T::kCols, clo, chi);
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

// One block per (channel, 32 x 64 tile).
template <class T>
__global__ void __launch_bounds__(kThreads)
mg_down_kernel(const float* __restrict__ u, const float* __restrict__ g,
               float* __restrict__ u_out, float* __restrict__ rh, int hp, int wp,
               int rh_rows, int nu1, Level L, float c1, float c2, bool vec) {
  __shared__ __align__(16) float su[T::kRows * T::kCols];
  __shared__ __align__(16) float sg[T::kRows * T::kCols];
  constexpr int kC = T::kCols;

  const int c = blockIdx.z;
  const int r0 = blockIdx.y * T::kTH, c0 = blockIdx.x * T::kTW;
  const int gr0 = r0 - T::kT, gc0 = c0 - T::kL;  // both even
  const size_t plane = (size_t)hp * wp;
  stage_async<T::kRows, kC, kThreads>(sg, g + c * plane, hp, wp, wp, gr0, gc0, vec);
  if (u != nullptr)
    stage_async<T::kRows, kC, kThreads>(su, u + c * plane, hp, wp, wp, gr0, gc0, vec);
  acp::commit();
  if (u == nullptr) {  // the known-zero guess, while g's copies land
    float4* s4 = reinterpret_cast<float4*>(su);
    for (int i = threadIdx.x; i < T::kRows * kC / 4; i += kThreads)
      s4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
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

  const InvDiag inv(L);
  int d = 2 * nu1;
  for (int s = 0; s < nu1; ++s) {
    half_sweep_down<T>(su, sg, L, inv, r0, c0, 0, --d, u == nullptr && s == 0);
    half_sweep_down<T>(su, sg, L, inv, r0, c0, 1, --d, false);
  }

  // the residual down column cc over owned-relative rows 8q .. 8q + 9 (the
  // last one for the even-h edge row), then rh rows r0/2 + 4q .. + 3
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
  if (gc < wp) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = r0 / 2 + 4 * q + k;
      if (j >= jz0) break;
      float v = (0.25f * r[2 * k] + 0.5f * r[2 * k + 1]) + 0.25f * r[2 * k + 2];
      if (h_even && j == hc - 1) v = (v + c1 * r[2 * k + 2]) + c2 * r[2 * k + 3];
      rhc[(size_t)j * wp + gc] = v;
    }
  }

  // the owned tile of u
  float* out = u_out + c * plane;
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

template <class T>
int launch_tile(const float* u, const float* g, float* u_out, float* rh, int c, int hp,
                int wp, int rh_rows, int nu1, const Level& L, float c1, float c2, bool vec,
                cudaStream_t stream) {
  const dim3 grid((wp + T::kTW - 1) / T::kTW, (hp + T::kTH - 1) / T::kTH, c);
  mg_down_kernel<T><<<grid, kThreads, 0, stream>>>(u, g, u_out, rh, hp, wp, rh_rows, nu1, L,
                                                   c1, c2, vec);
  return static_cast<int>(cudaGetLastError());
}

static_assert(Shallow::kDepth >= 2 && Deep::kDepth >= 4, "a ring shallower than its sweeps");

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
  const bool vec = wp % 4 == 0 &&
      ((reinterpret_cast<size_t>(u) | reinterpret_cast<size_t>(g) |
        reinterpret_cast<size_t>(u_out)) & 15) == 0;
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
