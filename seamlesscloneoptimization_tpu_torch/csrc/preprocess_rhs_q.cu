// preprocess_rhs_q: u8 destination and patch + eroded mask -> the Poisson
// right-hand side born as the four quarter planes of the multigrid's finest
// level, (C, 4, HPo/2, WPo/2) f32.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:
// preprocess_rhs_quarters_pallas (_pre_strip_kernel_pq).
//
// The RHS arithmetic is rhs_tile.cuh's (exact, integer-valued), shared with
// preprocess_rhs_t and preprocess_rhs_p; only the store differs: the dense
// (HPo, WPo) slab of preprocess_rhs_p (interior RHS at the origin, exact
// zeros elsewhere) goes to plane 2 (r & 1) + (j & 1) at (r >> 1, j >> 1).
// Every element of the output is written.
//
// Bound on this card: bytes. u8 destination, patch and mask read once, f32
// planes written once: 204 MB at 8K (ROI 3 x 2800 x 3800 -> 3 x 4 x 1408 x
// 1920; 0.061 ms at 3.35 TB/s), ~30 flops per pixel. Design: one block per
// (channel, 32 x 32 dense output tile), as preprocess_rhs_p; the tile's
// even and odd columns go to two planes, so a warp's 32 stores are two runs
// of 16 contiguous floats.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns the launch's cudaError_t.

#include "rhs_tile.cuh"

namespace {

using rhs::kTile;

__global__ void preprocess_rhs_q_kernel(
    const uint8_t* __restrict__ dest, rhs::Strides ds,
    const uint8_t* __restrict__ patch, rhs::Strides ps,
    const uint8_t* __restrict__ me, float* __restrict__ out, int h, int w,
    int hpo, int wpo, int mixed, int norm_rule) {
  __shared__ rhs::Smem s;
  const int c = blockIdx.z;
  const int j0 = blockIdx.x * kTile;  // dense minor index j = x - 1
  const int r0 = blockIdx.y * kTile;  // dense major index r = y - 1
  rhs::lap_tile(s, dest, ds, patch, ps, me, c, h, w, r0, j0, mixed, norm_rule);

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  const int hq = hpo / 2, wq = wpo / 2;
  float* oc = out + (size_t)c * 4 * hq * wq;
  for (int i = tid; i < kTile * kTile; i += nt) {
    const int rr = i / kTile, jj = i % kTile;
    const int r = r0 + rr, j = j0 + jj;
    if (r < hpo && j < wpo) {
      const int p = ((r & 1) << 1) | (j & 1);
      oc[((size_t)p * hq + (r >> 1)) * wq + (j >> 1)] = s.lap[jj][rr];
    }
  }
}

}  // namespace

// dest/patch: u8 (C, h, w) views given by element strides (dsc, dsh, dsw),
// (psc, psh, psw); me: (h, w) u8 {0,1} contiguous; out: (c, 4, hpo/2,
// wpo/2) f32 contiguous with hpo >= h-2, wpo >= w-2, both even. flags: 1
// NORMAL, 2 MIXED; norm_rule: 0 "opencv", 1 "norm".
extern "C" int preprocess_rhs_q_launch(
    const void* dest, long long dsc, long long dsh, long long dsw,
    const void* patch, long long psc, long long psh, long long psw,
    const void* me, void* out, int c, int h, int w, int hpo, int wpo,
    int flags, int norm_rule, void* stream) {
  if (c <= 0 || wpo <= 0 || hpo <= 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((wpo + kTile - 1) / kTile, (hpo + kTile - 1) / kTile, c);
  preprocess_rhs_q_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(dest), rhs::Strides{dsc, dsh, dsw},
      static_cast<const uint8_t*>(patch), rhs::Strides{psc, psh, psw},
      static_cast<const uint8_t*>(me), static_cast<float*>(out), h, w, hpo, wpo,
      flags == 2 ? 1 : 0, norm_rule);
  return static_cast<int>(cudaGetLastError());
}
