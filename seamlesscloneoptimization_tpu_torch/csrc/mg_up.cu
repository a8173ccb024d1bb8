// mg_up: one multigrid level's ascent, the row prolongation of the coarse
// correction + the add + nu2 red-black sweeps, in one pass.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:
// mg_up_pallas, padded_io form (bodies _mg_up_body, _mg_up_kernel_b).
//
// In: u, g (C, hp, wp) f32 as for mg_down; e (C, e_rows >= hp/2, wp), the
// coarse correction already prolonged along w (mg_prolong_t), whose rows
// [0, hc) are used and the rest taken as 0 (hc = (h-1)/2, E(k) below).
// Fine row 2q takes mids(q) = 0.5 (E(q-1) + E(q)), fine row 2q+1 takes
// E(q); for even h, row h-2 takes mids(hc) * c3 and row h-1 mids(hc) * c4
// (the linear interpolation over the beta gap, c3, c4 from bh). Inside the
// domain u += correction, then nu2 <= 4 sweeps. Out: the swept u; points
// outside the domain keep their (zero) input. Arithmetic in the plain
// twin's order, bit-equal to it (mg_level.cuh).
//
// Bound on this card: bytes. u and g read once, e (half height) read once,
// u written once: 14 bytes per fine point, 113 MB at the 8K "q" chain's
// coarse level 1 (3, 1920, 1408) (0.0338 ms at 3.35 TB/s), 454 MB at the
// "t" level 0 (3, 2816, 3840). The first design (one 32 x 64 tile with an
// 8-deep ring, synchronous loads, e read from device memory per point, every
// staged point swept) took 0.16 ms at level 1: staging u 0.04, the
// correction 0.04, staging g and the sweeps 0.09 (PERF.md section 6).
// Design (mg_level.cuh: UpTile): the ring is as deep as the sweeps (4 for
// nu2 <= 2, else 8); u, g and the tile's rows of e are staged with
// asynchronous copies (16-byte ones where the rows allow, zero-filled off
// the slab) and one wait; the
// correction reads e from shared memory; half-sweep k of 2 nu2 updates only
// the owned tile widened by 2 nu2 - k (its points are the only ones whose
// values still reach the owned tile); the diagonal's four quotients are
// computed once a block, not divided per point. Level 1 now takes 0.083 ms:
// staging u, g, e and storing u 0.054 of it (1.6x the bound), the
// correction 0.002, the 4 dense red-black half-sweeps 0.027 (stride-2
// shared accesses, one point a thread). One tile size serves every level:
// 16-row tiles that gave the smallest level (3, 512, 384) more blocks than
// the card has slots measured slower there (0.0173 ms against 0.0148).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include "mg_level.cuh"

namespace {

using namespace mg;

// One block per (channel, tile): stage, correct, 2 nu2 half-sweeps over a
// shrinking band, store the owned tile.
template <class T>
__global__ void __launch_bounds__(kThreads)
mg_up_kernel(const float* __restrict__ u, const float* __restrict__ g,
             const float* __restrict__ e, float* __restrict__ u_out, int hp, int wp,
             int e_rows, int nu2, Level L, float c3, float c4, bool vec) {
  __shared__ __align__(16) float su[T::kRows * T::kCols];
  __shared__ __align__(16) float sg[T::kRows * T::kCols];
  __shared__ __align__(16) float se[T::kERows * T::kCols];

  const int c = blockIdx.z;
  const int r0 = blockIdx.y * T::kTH, c0 = blockIdx.x * T::kTW;
  const int gr0 = r0 - T::kR, gc0 = c0 - T::kR;  // both even
  const size_t plane = (size_t)hp * wp;
  const int hc = (L.h - 1) / 2;
  const int krows = hc < e_rows ? hc : e_rows;
  const int qa = gr0 / 2 - 1;  // se row 0 holds E(qa); E(q) = 0 off [0, krows)
  stage_async<T::kRows, T::kCols, kThreads>(su, u + c * plane, hp, wp, wp, gr0, gc0, vec);
  stage_async<T::kRows, T::kCols, kThreads>(sg, g + c * plane, hp, wp, wp, gr0, gc0, vec);
  stage_async<T::kERows, T::kCols, kThreads>(se, e + (size_t)c * e_rows * wp, krows, wp, wp,
                                              qa, gc0, vec);
  acp::commit();
  acp::wait<0>();
  __syncthreads();

  // the correction, over the owned tile widened by the 2 nu2 half-sweeps
  int d = 2 * nu2;
  const int rlo = max(max(r0 - d, 0) - gr0, 0);
  const int rhi = min(min(r0 + T::kTH + d, L.h) - gr0, T::kRows);
  const int clo = max(max(c0 - d, 0) - gc0, 0);
  const int chi = min(min(c0 + T::kTW + d, L.w) - gc0, T::kCols);
  const bool h_even = L.h % 2 == 0;
  for (int i = threadIdx.x; i < (rhi - rlo) * T::kCols; i += kThreads) {
    const int lr = rlo + i / T::kCols, lc = i % T::kCols;
    if (lc < clo || lc >= chi) continue;
    const int gr = gr0 + lr;
    const int q = gr >> 1;
    const float eq = se[(q - qa) * T::kCols + lc];
    float corr;
    if (gr & 1) {
      corr = eq;
    } else {
      const float ep = se[(q - 1 - qa) * T::kCols + lc];
      corr = 0.5f * (ep + eq);
    }
    if (h_even && gr >= L.h - 2) {  // q == hc on both rows
      const float eh = se[(hc - 1 - qa) * T::kCols + lc];
      const float mid = 0.5f * (eh + 0.0f);
      corr = gr == L.h - 2 ? mid * c3 : mid * c4;
    }
    su[lr * T::kCols + lc] = su[lr * T::kCols + lc] + corr;
  }
  __syncthreads();
  const InvDiag inv(L);
  for (int s = 0; s < nu2; ++s) {
    half_sweep_band<T, kThreads>(su, sg, L, inv, r0, c0, 0, --d);
    half_sweep_band<T, kThreads>(su, sg, L, inv, r0, c0, 1, --d);
  }
  float* out = u_out + c * plane;
  for (int i = threadIdx.x; i < T::kTH * T::kTW; i += kThreads) {
    const int rr = i / T::kTW, cc = i % T::kTW;
    const int gr = r0 + rr, gc = c0 + cc;
    if (gr < hp && gc < wp) out[(size_t)gr * wp + gc] = su[(T::kR + rr) * T::kCols + T::kR + cc];
  }
}

// The (wp / kTW, hp / kTH, c) grid, rounded up.
template <int kRing>
int launch_ring(const float* u, const float* g, const float* e, float* u_out, int c, int hp,
                int wp, int e_rows, int nu2, const Level& L, float c3, float c4, bool vec,
                cudaStream_t stream) {
  using T = UpTile<kRing>;
  const dim3 grid((wp + T::kTW - 1) / T::kTW, (hp + T::kTH - 1) / T::kTH, c);
  mg_up_kernel<T><<<grid, kThreads, 0, stream>>>(u, g, e, u_out, hp, wp, e_rows, nu2, L, c3,
                                                 c4, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u, g, u_out: (c, hp, wp) f32 contiguous; e: (c, e_rows, wp) f32
// contiguous, e_rows >= hp/2. (h, w): the true domain; nu2 <= 4; uniform:
// bh == bw == 1; cuh, cuw, dh, dw: the level constants (mg_level.cuh); c3,
// c4: the even-h edge weights.
extern "C" int mg_up_launch(const void* u, const void* g, const void* e, void* u_out,
                            int c, int hp, int wp, int e_rows, int h, int w, int nu2,
                            int uniform, float cuh, float cuw, float dh, float dw,
                            float c3, float c4, void* stream) {
  if (c <= 0 || hp <= 0 || wp <= 0) return 0;
  if (nu2 < 0 || nu2 > 4) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = wp % 4 == 0 &&
      ((reinterpret_cast<size_t>(u) | reinterpret_cast<size_t>(g) |
        reinterpret_cast<size_t>(e)) & 15) == 0;
  const Level L{h, w, uniform, cuh, cuw, dh, dw};
  const auto* uf = static_cast<const float*>(u);
  const auto* gf = static_cast<const float*>(g);
  const auto* ef = static_cast<const float*>(e);
  auto* of = static_cast<float*>(u_out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (nu2 <= 2)
    return launch_ring<4>(uf, gf, ef, of, c, hp, wp, e_rows, nu2, L, c3, c4, vec, st);
  return launch_ring<8>(uf, gf, ef, of, c, hp, wp, e_rows, nu2, L, c3, c4, vec, st);
}
