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
// Bound on this card: bytes. g and u read once, u and rh written once:
// 18 bytes per fine point, 454 MB for the 8K level-0 slab 3 x 2816 x 3840
// (0.14 ms at 3.35 TB/s); ~25 flops per point and sweep. Design: one block
// of 256 threads per (channel, 32 x 64 tile); u and g are staged in shared
// memory with an 8-deep ring (48 x 80 each), the sweeps run there, the
// residual of the tile's 34 x 64 rows goes to a third shared array, and the
// block writes its u tile and its 16 rows of rh. The ring costs 1.9x the
// owned points in staging reads and sweep work: simple and right first.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include "mg_level.cuh"

namespace {

using namespace mg;

__global__ void __launch_bounds__(kThreads)
mg_down_kernel(const float* __restrict__ u, const float* __restrict__ g,
               float* __restrict__ u_out, float* __restrict__ rh, int hp,
               int wp, int rh_rows, int nu1, Level L, float c1, float c2) {
  __shared__ Tile su;
  __shared__ Tile sg;
  __shared__ float sr[kTH + 2][kTW];  // r at global rows r0 .. r0 + kTH + 1

  const int c = blockIdx.z;
  const int r0 = blockIdx.y * kTH, c0 = blockIdx.x * kTW;
  const size_t plane = (size_t)hp * wp;
  float* rhc = rh + (size_t)c * rh_rows * wp;
  if (r0 >= hp) {  // a tile below the slab: only zero rows of rh to write
    for (int i = threadIdx.x; i < (kTH / 2) * kTW; i += kThreads) {
      const int j = r0 / 2 + i / kTW, gc = c0 + i % kTW;
      if (j < rh_rows && gc < wp) rhc[(size_t)j * wp + gc] = 0.0f;
    }
    return;
  }
  const int gr0 = r0 - kHalo, gc0 = c0 - kHalo;
  stage(su, u == nullptr ? nullptr : u + c * plane, hp, wp, gr0, gc0);
  stage(sg, g + c * plane, hp, wp, gr0, gc0);
  __syncthreads();
  sweeps(su, sg, L, gr0, gc0, nu1, u == nullptr);

  for (int i = threadIdx.x; i < (kTH + 2) * kTW; i += kThreads) {
    const int rr = i / kTW, cc = i % kTW;
    const int lr = kHalo + rr, lc = kHalo + cc;
    const int gr = r0 + rr, gc = c0 + cc;
    float r = 0.0f;
    if (in_domain(L, gr, gc)) {
      const float uu = su[lr][lc];
      r = sg[lr][lc] - (nsum(su, L, lr, lc, gr, gc) - diag(L, gr, gc) * uu);
    }
    sr[rr][cc] = r;
  }
  __syncthreads();

  store(su, u_out + c * plane, hp, wp, r0, c0);
  const int hc = (L.h - 1) / 2;
  const bool h_even = L.h % 2 == 0;
  for (int i = threadIdx.x; i < (kTH / 2) * kTW; i += kThreads) {
    const int k = i / kTW, cc = i % kTW;
    const int j = r0 / 2 + k, gc = c0 + cc;
    if (j >= rh_rows || gc >= wp) continue;
    float v = 0.0f;
    if (j < hp / 2) {
      v = (0.25f * sr[2 * k][cc] + 0.5f * sr[2 * k + 1][cc]) + 0.25f * sr[2 * k + 2][cc];
      if (h_even && j == hc - 1)
        v = (v + c1 * sr[2 * k + 2][cc]) + c2 * sr[2 * k + 3][cc];
    }
    rhc[(size_t)j * wp + gc] = v;
  }
}

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
  const int rows = hp > 2 * rh_rows ? hp : 2 * rh_rows;
  const dim3 grid((wp + kTW - 1) / kTW, (rows + kTH - 1) / kTH, c);
  mg_down_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(g),
      static_cast<float*>(u_out), static_cast<float*>(rh), hp, wp, rh_rows, nu1,
      Level{h, w, uniform, cuh, cuw, dh, dw}, c1, c2);
  return static_cast<int>(cudaGetLastError());
}
