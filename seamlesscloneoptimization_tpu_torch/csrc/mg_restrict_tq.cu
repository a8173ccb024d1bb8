// mg_restrict_tq: the x4 lane-direction restriction of the split row-restricted
// residual (the even / odd dense-column planes that the split mg_down_q
// writes), emitted TRANSPOSED: the RHS of the first coarse level.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_mg_quarter.py:
// mg_restrict_tq_pallas (_restrict_tq_kernel).
//
// In: rh_e, rh_o (C, hp2, wq2) f32, rows [0, hc) valid (hc = (h-1)/2); other
// rows may hold anything, NaN included: they are never read into the result.
// Out: (C, out_rows, hp2) with, for jw < wc = (w-1)/2 and l < hc,
//   out[c, jw, l] = (e + 2 o) + e1,  e = rh_e[l, jw], o = rh_o[l, jw],
//                                    e1 = rh_e[l, jw+1]
// (the x4 coarse-RHS scale folded into the (1, 2, 1) weights); for even w the
// last row jw = wc-1 takes ((e + 2 o) + c5 e1) + c6 rh_o[l, jw+1], the
// beta-gap edge. Every other element is an exact 0. Arithmetic in the twin's
// order (ops/kernels.py: mg_restrict_tq_plain), bit-equal to it; against the
// fused restriction of mg_down_q it is bit-equal too, as both run the twin's
// expressions (the TPU's fused form differs by ~1 ulp at the edge row).
//
// Bound on this card: bytes. Both planes read once, the quarter-size result
// written once: 2 x 3 x 1408 x 1920 x 4 B + 3 x 1920 x 1408 x 4 B = 97 MB
// at the 8K level (0.029 ms at 3.35 TB/s). Design: mg_restrict_t's, for two
// inputs: one block per (channel, 32 lanes l x 32 coarse rows jw); it stages
// the 32 x 33 windows of both planes (rows l, columns jw0 .. jw0 + 32) in
// shared memory, reading along the planes' rows, and writes along l, so
// reads and writes are coalesced; rows padded to 33 floats keep the
// transposed reads free of bank conflicts.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kL = 32;        // lanes (rh rows) per block
constexpr int kJ = 32;        // coarse rows (rh columns) per block
constexpr int kIn = kJ + 1;   // rh columns staged: jw0 .. jw0 + 32

__global__ void mg_restrict_tq_kernel(const float* __restrict__ rh_e,
                                      const float* __restrict__ rh_o,
                                      float* __restrict__ out, int hp2, int wq2,
                                      int out_rows, int hc, int wc, int w_even, float c5,
                                      float c6) {
  __shared__ float se[kL][kIn];
  __shared__ float so[kL][kIn];
  const int c = blockIdx.z;
  const int l0 = blockIdx.x * kL, j0 = blockIdx.y * kJ;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  const size_t chan = (size_t)c * hp2 * wq2;
  for (int i = tid; i < kL * kIn; i += nt) {
    const int ll = i / kIn, cc = i % kIn;
    const int l = l0 + ll, col = j0 + cc;
    const bool in = l < hp2 && col < wq2;
    const size_t k = chan + (size_t)l * wq2 + col;
    se[ll][cc] = in ? rh_e[k] : 0.0f;
    so[ll][cc] = in ? rh_o[k] : 0.0f;
  }
  __syncthreads();

  float* oc = out + (size_t)c * out_rows * hp2;
  for (int i = tid; i < kL * kJ; i += nt) {
    const int jj = i / kL, ll = i % kL;
    const int j = j0 + jj, l = l0 + ll;
    if (j >= out_rows || l >= hp2) continue;
    float v = 0.0f;
    if (j < wc && l < hc) {
      const float eo = se[ll][jj] + 2.0f * so[ll][jj];
      if (w_even && j == wc - 1)
        v = (eo + c5 * se[ll][jj + 1]) + c6 * so[ll][jj + 1];
      else
        v = eo + se[ll][jj + 1];
    }
    oc[(size_t)j * hp2 + l] = v;
  }
}

}  // namespace

// rh_e, rh_o: (c, hp2, wq2) f32 contiguous, wq2 >= wc + 1; out: (c, out_rows,
// hp2) f32 contiguous, out_rows >= wc. (h, w): the fine level's true size;
// c5, c6: the even-w edge weights 2(1+1)/3 and 2/3, rounded once to f32.
extern "C" int mg_restrict_tq_launch(const void* rh_e, const void* rh_o, void* out, int c,
                                     int hp2, int wq2, int out_rows, int h, int w, float c5,
                                     float c6, void* stream) {
  if (c <= 0 || hp2 <= 0 || out_rows <= 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((hp2 + kL - 1) / kL, (out_rows + kJ - 1) / kJ, c);
  mg_restrict_tq_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rh_e), static_cast<const float*>(rh_o),
      static_cast<float*>(out), hp2, wq2, out_rows, (h - 1) / 2, (w - 1) / 2,
      w % 2 == 0 ? 1 : 0, c5, c6);
  return static_cast<int>(cudaGetLastError());
}
