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
// u written once: 14 bytes per fine point, 454 MB with the 8K level-0
// slab 3 x 2816 x 3840 and its (3, 1408, 3840) e (0.14 ms at 3.35 TB/s).
// Design: as mg_down, one block of 256 threads per (channel, 32 x 64
// tile) with u and g staged with an 8-deep ring; the correction is added
// to every staged point, reading e from device memory (each e value serves
// up to three fine rows and stays in L1/L2), then the sweeps run in shared
// memory and the block writes its u tile.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include "mg_level.cuh"

namespace {

using namespace mg;

__global__ void __launch_bounds__(kThreads)
mg_up_kernel(const float* __restrict__ u, const float* __restrict__ g,
             const float* __restrict__ e, float* __restrict__ u_out, int hp,
             int wp, int e_rows, int nu2, Level L, float c3, float c4) {
  __shared__ Tile su;
  __shared__ Tile sg;

  const int c = blockIdx.z;
  const int r0 = blockIdx.y * kTH, c0 = blockIdx.x * kTW;
  const int gr0 = r0 - kHalo, gc0 = c0 - kHalo;
  const size_t plane = (size_t)hp * wp;
  stage(su, u + c * plane, hp, wp, gr0, gc0);
  stage(sg, g + c * plane, hp, wp, gr0, gc0);
  __syncthreads();

  const float* ec = e + (size_t)c * e_rows * wp;
  const int hc = (L.h - 1) / 2;
  const int krows = hc < e_rows ? hc : e_rows;
  const bool h_even = L.h % 2 == 0;
  for (int i = threadIdx.x; i < kRows * kCols; i += kThreads) {
    const int lr = i / kCols, lc = i % kCols;
    const int gr = gr0 + lr, gc = gc0 + lc;
    if (!in_domain(L, gr, gc)) continue;
    const int q = gr >> 1;
    const float eq = q < krows ? ec[(size_t)q * wp + gc] : 0.0f;
    float corr;
    if (gr & 1) {
      corr = eq;
    } else {
      const float ep = q >= 1 && q - 1 < krows ? ec[(size_t)(q - 1) * wp + gc] : 0.0f;
      corr = 0.5f * (ep + eq);
    }
    if (h_even && gr >= L.h - 2) {  // q == hc on both rows
      const float eh = hc - 1 < krows ? ec[(size_t)(hc - 1) * wp + gc] : 0.0f;
      const float mid = 0.5f * (eh + 0.0f);
      corr = gr == L.h - 2 ? mid * c3 : mid * c4;
    }
    su[lr][lc] = su[lr][lc] + corr;
  }
  __syncthreads();
  sweeps(su, sg, L, gr0, gc0, nu2, false);
  store(su, u_out + c * plane, hp, wp, r0, c0);
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
  const dim3 grid((wp + kTW - 1) / kTW, (hp + kTH - 1) / kTH, c);
  mg_up_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(g),
      static_cast<const float*>(e), static_cast<float*>(u_out), hp, wp, e_rows, nu2,
      Level{h, w, uniform, cuh, cuw, dh, dw}, c3, c4);
  return static_cast<int>(cudaGetLastError());
}
