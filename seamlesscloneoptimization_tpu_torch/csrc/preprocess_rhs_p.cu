// preprocess_rhs_p: u8 destination and patch + eroded mask -> the Poisson
// right-hand side, natural orientation, at the origin of a zero-padded f32
// slab of any size (HPo, WPo) >= (h-2, w-2).
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:
// preprocess_rhs_padded_pallas (_pre_strip_kernel_p), and with
// (HPo, WPo) = (h-2, w-2) the exact-size preprocess_rhs_pallas, whose
// multigrid serve tail pads the result to the level geometry right after.
//
// The RHS arithmetic is rhs_tile.cuh's (exact, integer-valued):
// out[c, y-1, x-1] = lap(y, x) for interior pixels; every other element of
// the (C, HPo, WPo) slab is written as an exact zero (the multigrid's
// padded levels rely on it).
//
// Bound on this card: bytes. u8 destination, patch and mask read once,
// f32 slab written once (130 MB at the 8K level-0 slab 3 x 2816 x 3840),
// ~30 flops per pixel. Design: one block per (channel, 32x32 output tile);
// rhs::lap_tile leaves the tile in shared memory as lap[x][y] (rows padded
// to 33 floats), and the store walks it along x, so the global writes run
// along the slab's rows: reads and writes are both coalesced.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include "rhs_tile.cuh"

namespace {

using rhs::kTile;

__global__ void preprocess_rhs_p_kernel(
    const uint8_t* __restrict__ dest, rhs::Strides ds,
    const uint8_t* __restrict__ patch, rhs::Strides ps,
    const uint8_t* __restrict__ me, float* __restrict__ out, int h, int w,
    int hpo, int wpo, int mixed, int norm_rule) {
  __shared__ rhs::Smem s;
  const int c = blockIdx.z;
  const int j0 = blockIdx.x * kTile;  // output minor index j = x - 1
  const int r0 = blockIdx.y * kTile;  // output major index r = y - 1
  rhs::lap_tile(s, dest, ds, patch, ps, me, c, h, w, r0, j0, mixed, norm_rule);

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  float* oc = out + (size_t)c * hpo * wpo;
  for (int i = tid; i < kTile * kTile; i += nt) {
    const int rr = i / kTile, jj = i % kTile;
    const int r = r0 + rr, j = j0 + jj;
    if (r < hpo && j < wpo) oc[(size_t)r * wpo + j] = s.lap[jj][rr];
  }
}

}  // namespace

// dest/patch: u8 (C, h, w) views given by element strides (dsc, dsh, dsw),
// (psc, psh, psw); me: (h, w) u8 {0,1} contiguous; out: (c, hpo, wpo) f32
// contiguous with hpo >= h-2, wpo >= w-2. flags: 1 NORMAL, 2 MIXED;
// norm_rule: 0 "opencv", 1 "norm".
extern "C" int preprocess_rhs_p_launch(
    const void* dest, long long dsc, long long dsh, long long dsw,
    const void* patch, long long psc, long long psh, long long psw,
    const void* me, void* out, int c, int h, int w, int hpo, int wpo,
    int flags, int norm_rule, void* stream) {
  if (c <= 0 || wpo <= 0 || hpo <= 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((wpo + kTile - 1) / kTile, (hpo + kTile - 1) / kTile, c);
  preprocess_rhs_p_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(dest), rhs::Strides{dsc, dsh, dsw},
      static_cast<const uint8_t*>(patch), rhs::Strides{psc, psh, psw},
      static_cast<const uint8_t*>(me), static_cast<float*>(out), h, w, hpo, wpo,
      flags == 2 ? 1 : 0, norm_rule);
  return static_cast<int>(cudaGetLastError());
}
