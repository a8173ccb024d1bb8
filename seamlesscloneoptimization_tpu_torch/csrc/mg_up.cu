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
// The fused form, mg_up_t (vcycle_t's ascent): the lane prolongation of
// mg_prolong_t (Replaces: pallas_kernels.py: mg_prolong_t_pallas, body
// _prolong_t_kernel) folded in front of the same tile, so e never leaves
// the block. In: ec_t (C, hp_c, lanes), the transposed coarse correction
// (wc, hc) at the origin. Bit-equal to mg_up(u, g, mg_prolong_t(ec_t, w,
// out_rows = hp/2 or more, wp)): the block stages the window of ec_t its
// kERows rows of e come from, coarse rows k in [gc0/2 - 1, gc0/2 + 32)
// and lanes l in [gr0/2 - 1, gr0/2 - 1 + kERows) (4-byte copies, a warp a
// row: rows of 21 or 25 floats at any offset), zeros for k outside
// [0, hp_c) and for l >= hc (the rows of e that mg_up takes as zero), and
// computes the tile's e from it in mg_prolong_t's arithmetic: E(k) at
// x = 2k + 1, 0.5 (E(k-1) + E(k)) at x = 2k, for even w E(wc-1) c7 and
// E(wc-1) c8 on columns w-2 and w-1, zeros at x >= w. A thread computes a
// column pair (one load of E(k) for both; a tile inside the domain and off
// the even-w edge takes no test), a warp 32 coarse rows of one lane: the
// window's row stride is odd, so they fall in distinct banks. The window
// is its own copy group, issued first, so e's rows are computed while u
// and g land. The correction, the sweeps and the store are mg_up's. Bound on this card:
// bytes. u and g read once, the window of ec_t in use read once, u written
// once: at the 8K "q" chain's coarse level 1 (3, 1920, 1408), 105 MB
// (0.031 ms at 3.35 TB/s) against 0.0415 ms for mg_prolong_t + mg_up
// apart. Like mg_down_t it is bound by issue: there (H100 80GB HBM3, 700 W,
// back to back) a first design (a thread a column of e, the window's
// copies indexed by a division) took 0.0867, of it e's pass 0.0077 and
// the window 0.0055; the column pairs take it to 0.0827 against 0.0931 for
// the pair apart, the early window to 0.0822.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include "mg_level.cuh"

namespace {

using namespace mg;

// The correction from the staged rows of e (se: row q - qa holds E(q),
// qa = gr0/2 - 1), over the owned tile widened by the 2 nu2 half-sweeps,
// then the sweeps over a shrinking band and the store of the owned tile.
template <class T>
__device__ __forceinline__ void correct_sweep_store(float* su, const float* sg, const float* se,
                                                    float* __restrict__ out, int hp, int wp,
                                                    int r0, int c0, int nu2, const Level& L,
                                                    float c3, float c4) {
  const int gr0 = r0 - T::kR, gc0 = c0 - T::kR;  // both even
  const int hc = (L.h - 1) / 2;
  const int qa = gr0 / 2 - 1;
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
  for (int i = threadIdx.x; i < T::kTH * T::kTW; i += kThreads) {
    const int rr = i / T::kTW, cc = i % T::kTW;
    const int gr = r0 + rr, gc = c0 + cc;
    if (gr < hp && gc < wp) out[(size_t)gr * wp + gc] = su[(T::kR + rr) * T::kCols + T::kR + cc];
  }
}

// The fused form: e at column x of window lane qq, as mg_prolong_t writes
// it (sw row kk holds coarse row kb + kk).
__device__ __forceinline__ float e_at(const float* sw, int ks, int qq, int kb, int x,
                                      const Level& L, float c7, float c8) {
  if (x < 0 || x >= L.w) return 0.0f;
  if (L.w % 2 == 0 && x >= L.w - 2) {
    const float last = sw[((L.w - 1) / 2 - 1 - kb) * ks + qq];
    return x == L.w - 2 ? last * c7 : last * c8;
  }
  const int kk = x / 2 - kb;
  return x % 2 == 0 ? 0.5f * (sw[(kk - 1) * ks + qq] + sw[kk * ks + qq]) : sw[kk * ks + qq];
}

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
  correct_sweep_store<T>(su, sg, se, u_out + c * plane, hp, wp, r0, c0, nu2, L, c3, c4);
}

// The fused form: the window of ec_t, then the tile's rows of e from it,
// then mg_up_kernel's correction, sweeps and store.
template <class T>
__global__ void __launch_bounds__(kThreads)
mg_up_t_kernel(const float* __restrict__ u, const float* __restrict__ g,
               const float* __restrict__ ec, float* __restrict__ u_out, int hp, int wp,
               int hp_c, int lanes, int nu2, Level L, float c3, float c4, float c7, float c8,
               bool vec) {
  constexpr int kK = T::kCols / 2 + 1;  // coarse rows of the window
  constexpr int kS = T::kERows | 1;     // the window's row stride: odd
  __shared__ __align__(16) float su[T::kRows * T::kCols];
  __shared__ __align__(16) float sg[T::kRows * T::kCols];
  __shared__ __align__(16) float se[T::kERows * T::kCols];
  __shared__ float sw[kK * kS];

  const int c = blockIdx.z;
  const int r0 = blockIdx.y * T::kTH, c0 = blockIdx.x * T::kTW;
  const int gr0 = r0 - T::kR, gc0 = c0 - T::kR;  // both even
  const size_t plane = (size_t)hp * wp;
  const int hc = (L.h - 1) / 2;
  const int qa = gr0 / 2 - 1;  // se row 0 holds lane qa
  const int kb = gc0 / 2 - 1;  // sw row 0 holds coarse row kb
  {  // the window first, its own copy group: a warp a row, a lane a lane
    const float* ecc = ec + (size_t)c * hp_c * lanes;
    const int lane = threadIdx.x % 32, l = qa + lane;
    const bool l_ok = l >= 0 && l < (hc < lanes ? hc : lanes);
    if (lane < T::kERows)
      for (int kk = threadIdx.x / 32; kk < kK; kk += kThreads / 32) {
        const int k = kb + kk;
        const bool ok = l_ok && k >= 0 && k < hp_c;
        acp::copy4(sw + kk * kS + lane, ok ? ecc + (size_t)k * lanes + l : ecc, ok);
      }
  }
  acp::commit();
  stage_async<T::kRows, T::kCols, kThreads>(su, u + c * plane, hp, wp, wp, gr0, gc0, vec);
  stage_async<T::kRows, T::kCols, kThreads>(sg, g + c * plane, hp, wp, wp, gr0, gc0, vec);
  acp::commit();
  acp::wait<1>();  // e's rows are computed while u and g land
  __syncthreads();

  // e at the staged columns x = gc0 + lc, lanes qa + qq: a thread the pair
  // x = gc0 + 2m, x + 1 (E(k) and the mid of E(k-1), E(k) share a load);
  // a tile wholly inside the domain and off the even-w edge takes no test
  const bool inner = gc0 >= 0 && gc0 + T::kCols <= L.w - (L.w % 2 == 0 ? 2 : 0);
  constexpr int kPairs = T::kCols / 2;
  for (int i = threadIdx.x; i < T::kERows * kPairs; i += kThreads) {
    const int qq = i / kPairs, m = i % kPairs;
    float2 v;
    if (inner) {
      const float ek = sw[(m + 1) * kS + qq];  // x / 2 - kb = m + 1
      v = make_float2(0.5f * (sw[m * kS + qq] + ek), ek);
    } else {
      const int x = gc0 + 2 * m;
      v = make_float2(e_at(sw, kS, qq, kb, x, L, c7, c8), e_at(sw, kS, qq, kb, x + 1, L, c7, c8));
    }
    *reinterpret_cast<float2*>(se + qq * T::kCols + 2 * m) = v;
  }
  acp::wait<0>();
  __syncthreads();
  correct_sweep_store<T>(su, sg, se, u_out + c * plane, hp, wp, r0, c0, nu2, L, c3, c4);
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

template <int kRing>
int launch_ring_t(const float* u, const float* g, const float* ec, float* u_out, int c, int hp,
                  int wp, int hp_c, int lanes, int nu2, const Level& L, float c3, float c4,
                  float c7, float c8, bool vec, cudaStream_t stream) {
  using T = UpTile<kRing>;
  const dim3 grid((wp + T::kTW - 1) / T::kTW, (hp + T::kTH - 1) / T::kTH, c);
  mg_up_t_kernel<T><<<grid, kThreads, 0, stream>>>(u, g, ec, u_out, hp, wp, hp_c, lanes, nu2,
                                                   L, c3, c4, c7, c8, vec);
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

// The fused form. u, g, u_out as for mg_up_launch; ec: (c, hp_c, lanes) f32
// contiguous, hp_c >= wc, lanes >= hc; c7, c8: the even-w edge weights.
extern "C" int mg_up_t_launch(const void* u, const void* g, const void* ec, void* u_out,
                              int c, int hp, int wp, int hp_c, int lanes, int h, int w,
                              int nu2, int uniform, float cuh, float cuw, float dh, float dw,
                              float c3, float c4, float c7, float c8, void* stream) {
  if (c <= 0 || hp <= 0 || wp <= 0) return 0;
  if (nu2 < 0 || nu2 > 4) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = wp % 4 == 0 &&
      ((reinterpret_cast<size_t>(u) | reinterpret_cast<size_t>(g)) & 15) == 0;
  const Level L{h, w, uniform, cuh, cuw, dh, dw};
  const auto* uf = static_cast<const float*>(u);
  const auto* gf = static_cast<const float*>(g);
  const auto* ef = static_cast<const float*>(ec);
  auto* of = static_cast<float*>(u_out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (nu2 <= 2)
    return launch_ring_t<4>(uf, gf, ef, of, c, hp, wp, hp_c, lanes, nu2, L, c3, c4, c7, c8, vec,
                            st);
  return launch_ring_t<8>(uf, gf, ef, of, c, hp, wp, hp_c, lanes, nu2, L, c3, c4, c7, c8, vec,
                          st);
}
