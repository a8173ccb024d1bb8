// mg_prolong_tq: the lane prolongation of the transposed coarse correction,
// written back in natural orientation as the even / odd dense-column planes
// that the quarter-plane ascent adds.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_mg_quarter.py:
// mg_prolong_tq_pallas (_prolong_tq_kernel).
//
// In: ec_t (C, hp_c, lanes) f32, the coarse level's solution in transposed
// orientation (coarse column j along rows, coarse row l along lanes; zeros
// outside the (wc, hc) domain). With E(j) = ec_t[j, l] for 0 <= j < hp_c and
// 0 elsewhere, out (C, out_rows, wq2) x 2 at [l, j]:
//   even planes: 0.5 (E(j-1) + E(j)) for j < wc (odd w: j <= wc),
//   odd planes:  E(j) for j < wc,
//   even w, j = wc: E(wc-1) * a1 and E(wc-1) * a2 (the beta-gap weights),
//   0 elsewhere: every element is written.
// Arithmetic in the twin's order (ops/kernels.py: mg_prolong_tq_plain),
// bit-equal to it.
//
// Bound on this card: bytes. ec_t's (out_rows) lanes read once, both planes
// written once: 3 x 1920 x 1408 x 4 B + 2 x 3 x 1408 x 1920 x 4 B = 97 MB
// at the 8K level (0.029 ms at 3.35 TB/s). Design: one block per (channel,
// 32 x 32 output tile); the 33 x 32 input window (one row of halo for
// E(j-1)) is staged in shared memory along lanes, so reads run along ec_t's
// rows and writes along the planes' rows, both coalesced; rows padded to 33
// floats keep the transposed reads free of bank conflicts.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns the launch's cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kT = 32;

__global__ void mg_prolong_tq_kernel(const float* __restrict__ ec,
                                     float* __restrict__ out_e,
                                     float* __restrict__ out_o, int hp_c, int lanes,
                                     int out_rows, int wq2, int w, float a1, float a2) {
  __shared__ float s[kT + 1][kT + 1];  // s[jj][ll] = E(j0 - 1 + jj) at lane l0 + ll
  const int c = blockIdx.z;
  const int j0 = blockIdx.x * kT, l0 = blockIdx.y * kT;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  const float* ecc = ec + (size_t)c * hp_c * lanes;
  for (int i = tid; i < (kT + 1) * kT; i += nt) {
    const int jj = i / kT, ll = i % kT;
    const int j = j0 - 1 + jj, l = l0 + ll;
    s[jj][ll] = (j >= 0 && j < hp_c && l < out_rows) ? ecc[(size_t)j * lanes + l] : 0.0f;
  }
  __syncthreads();

  const int wc = (w - 1) / 2;
  const bool w_even = w % 2 == 0;
  const size_t plane = (size_t)out_rows * wq2;
  for (int i = tid; i < kT * kT; i += nt) {
    const int ll = i / kT, jj = i % kT;
    const int j = j0 + jj, l = l0 + ll;
    if (l >= out_rows || j >= wq2) continue;
    const float em = s[jj][ll], e0 = s[jj + 1][ll];  // E(j-1), E(j)
    float ev = 0.0f, od = 0.0f;
    if (j < wc) {
      ev = 0.5f * (em + e0);
      od = e0;
    } else if (j == wc) {
      if (w_even) {
        ev = em * a1;
        od = em * a2;
      } else {
        ev = 0.5f * (em + e0);
      }
    }
    const size_t k = c * plane + (size_t)l * wq2 + j;
    out_e[k] = ev;
    out_o[k] = od;
  }
}

}  // namespace

// ec_t: (c, hp_c, lanes) f32 contiguous; out_e, out_o: (c, out_rows, wq2) f32
// contiguous, out_rows <= lanes. w: the fine level's true width; a1, a2: the
// even-w edge weights (1+1)/3 and 1/3, rounded once to f32.
extern "C" int mg_prolong_tq_launch(const void* ec, void* out_e, void* out_o, int c,
                                    int hp_c, int lanes, int out_rows, int wq2, int w,
                                    float a1, float a2, void* stream) {
  if (c <= 0 || out_rows <= 0 || wq2 <= 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((wq2 + kT - 1) / kT, (out_rows + kT - 1) / kT, c);
  mg_prolong_tq_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ec), static_cast<float*>(out_e),
      static_cast<float*>(out_o), hp_c, lanes, out_rows, wq2, w, a1, a2);
  return static_cast<int>(cudaGetLastError());
}
