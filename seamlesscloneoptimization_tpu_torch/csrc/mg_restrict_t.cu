// mg_restrict_t: the x4 lane-direction restriction of the row-restricted
// residual, emitted TRANSPOSED: the RHS of the next (transposed) level.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:
// mg_restrict_t_pallas (body _restrict_t_kernel).
//
// In: rh (C, hp2, wp) f32 from mg_down, rows [0, hc) valid. Out: (C,
// out_rows, hp2) with, for j < wc and l < hc (hc = (h-1)/2, wc = (w-1)/2),
//   out[c, j, l] = (a + 2 b) + a1,  a = rh[l, 2j], b = rh[l, 2j+1],
//                                   a1 = rh[l, 2j+2]
// (the x4 coarse-RHS scale folded into the (1, 2, 1) weights, exact since
// a power of two commutes with rounding); for even w the last column
// j = wc-1 takes ((a + 2 b) + c5 a1) + c6 rh[l, 2j+3], the beta-gap edge
// (c5, c6 from bw). Every other element is an exact 0: lanes l >= hc hold
// rh leftovers, which are never read into the result. Bit-equal to the
// plain twin.
//
// Bound on this card: bytes. rh read once, the quarter-size result written
// once: 97 MB for the 8K level-0 rh (3, 1408, 3840) (0.029 ms at
// 3.35 TB/s). Design: one block per (channel, 32 lanes l x 32 coarse
// columns j); it stages the 32 x 66 input window (rows l, columns 2j0 ..
// 2j0 + 65) in shared memory with rows padded to 67 floats, reading along
// rh's rows, and writes along l, so reads and writes are both coalesced and
// the strided shared reads are free of bank conflicts.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kL = 32;             // lanes (rh rows) per block
constexpr int kJ = 32;             // coarse columns per block
constexpr int kIn = 2 * kJ + 2;    // rh columns staged: 2j0 .. 2j0 + 65

__global__ void mg_restrict_t_kernel(const float* __restrict__ rh,
                                     float* __restrict__ out, int hp2, int wp,
                                     int out_rows, int hc, int wc, int w_even,
                                     float c5, float c6) {
  __shared__ float s[kL][kIn + 1];
  const int c = blockIdx.z;
  const int l0 = blockIdx.x * kL, j0 = blockIdx.y * kJ;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  const float* rc = rh + (size_t)c * hp2 * wp;
  for (int i = tid; i < kL * kIn; i += nt) {
    const int ll = i / kIn, cc = i % kIn;
    const int l = l0 + ll, col = 2 * j0 + cc;
    s[ll][cc] = l < hp2 && col < wp ? rc[(size_t)l * wp + col] : 0.0f;
  }
  __syncthreads();

  float* oc = out + (size_t)c * out_rows * hp2;
  for (int i = tid; i < kL * kJ; i += nt) {
    const int jj = i / kL, ll = i % kL;
    const int j = j0 + jj, l = l0 + ll;
    if (j >= out_rows || l >= hp2) continue;
    float v = 0.0f;
    if (j < wc && l < hc) {
      const float* sl = s[ll];
      const float ab = sl[2 * jj] + 2.0f * sl[2 * jj + 1];
      v = ab + sl[2 * jj + 2];
      if (w_even && j == wc - 1) v = (ab + c5 * sl[2 * jj + 2]) + c6 * sl[2 * jj + 3];
    }
    oc[(size_t)j * hp2 + l] = v;
  }
}

}  // namespace

// rh: (c, hp2, wp) f32 contiguous, wp >= 2 wc + 2; out: (c, out_rows, hp2)
// f32 contiguous, out_rows >= wc. (h, w): the fine level's true size; c5,
// c6: the even-w edge weights.
extern "C" int mg_restrict_t_launch(const void* rh, void* out, int c, int hp2, int wp,
                                    int out_rows, int h, int w, float c5, float c6,
                                    void* stream) {
  if (c <= 0 || hp2 <= 0 || out_rows <= 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((hp2 + kL - 1) / kL, (out_rows + kJ - 1) / kJ, c);
  mg_restrict_t_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rh), static_cast<float*>(out), hp2, wp, out_rows,
      (h - 1) / 2, (w - 1) / 2, w % 2 == 0 ? 1 : 0, c5, c6);
  return static_cast<int>(cudaGetLastError());
}
