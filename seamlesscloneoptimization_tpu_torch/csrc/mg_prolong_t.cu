// mg_prolong_t: the lane-direction prolongation of the TRANSPOSED coarse
// correction, landed back in natural orientation: mg_up's e operand.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:
// mg_prolong_t_pallas (body _prolong_t_kernel).
//
// In: ec (C, hp_c, lanes) f32, the coarse solution (wc, hc) at the origin
// (wc = (w-1)/2), zeros elsewhere. With E(k) = ec[c, k, l] for
// 0 <= k < hp_c and 0 otherwise, out (C, out_rows, wp) is, for l < out_rows:
//   x = 2k     (k < wc):  0.5 (E(k-1) + E(k))
//   x = 2k+1   (k < wc):  E(k)
//   odd w,  x = w-1:      0.5 (E(wc-1) + E(wc))
//   even w, x = w-2, w-1: E(wc-1) c7, E(wc-1) c8  (the beta gap, from bw)
//   x >= w:               0
// Bit-equal to the plain twin.
//
// Bound on this card: bytes. ec read once (the part in use), the result
// written once: 97 MB for the 8K level-0 e (3, 1408, 3840) (0.029 ms at
// 3.35 TB/s). Design: one block per (channel, 32 output rows l x 64 output
// columns x); it stages the 34 x 32 window of ec it needs (coarse rows
// x0/2 - 1 .. x0/2 + 32, lanes l0 .. l0 + 31) in shared memory, reading
// along lanes, and writes along x, so reads and writes are coalesced; the
// shared rows are padded to 33 floats, so the transposed reads are free of
// bank conflicts.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include <cuda_runtime.h>

namespace {

constexpr int kL = 32;            // output rows (coarse lanes) per block
constexpr int kX = 64;            // output columns per block
constexpr int kK = kX / 2 + 2;    // coarse rows staged

__global__ void mg_prolong_t_kernel(const float* __restrict__ ec,
                                    float* __restrict__ out, int hp_c, int lanes,
                                    int out_rows, int wp, int w, float c7, float c8) {
  __shared__ float s[kK][kL + 1];  // [k - kbase][l - l0]
  const int c = blockIdx.z;
  const int x0 = blockIdx.x * kX, l0 = blockIdx.y * kL;
  const int kbase = x0 / 2 - 1;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  const float* ecc = ec + (size_t)c * hp_c * lanes;
  for (int i = tid; i < kK * kL; i += nt) {
    const int kk = i / kL, ll = i % kL;
    const int k = kbase + kk, l = l0 + ll;
    s[kk][ll] = k >= 0 && k < hp_c && l < lanes ? ecc[(size_t)k * lanes + l] : 0.0f;
  }
  __syncthreads();

  const int wc = (w - 1) / 2;
  const bool w_even = w % 2 == 0;
  float* oc = out + (size_t)c * out_rows * wp;
  for (int i = tid; i < kL * kX; i += nt) {
    const int ll = i / kX, xx = i % kX;
    const int l = l0 + ll, x = x0 + xx;
    if (l >= out_rows || x >= wp) continue;
    float v = 0.0f;
    if (x < w) {
      const int k = x / 2;
      if (w_even && x >= w - 2) {
        const float last = s[wc - 1 - kbase][ll];
        v = x == w - 2 ? last * c7 : last * c8;
      } else if (x % 2 == 0) {
        v = 0.5f * (s[k - 1 - kbase][ll] + s[k - kbase][ll]);
      } else {
        v = s[k - kbase][ll];
      }
    }
    oc[(size_t)l * wp + x] = v;
  }
}

}  // namespace

// ec: (c, hp_c, lanes) f32 contiguous, hp_c >= wc; out: (c, out_rows, wp) f32
// contiguous, out_rows <= lanes, wp >= w. w: the fine level's true width;
// c7, c8: the even-w edge weights.
extern "C" int mg_prolong_t_launch(const void* ec, void* out, int c, int hp_c, int lanes,
                                   int out_rows, int wp, int w, float c7, float c8,
                                   void* stream) {
  if (c <= 0 || out_rows <= 0 || wp <= 0) return 0;
  const dim3 block(64, 4);
  const dim3 grid((wp + kX - 1) / kX, (out_rows + kL - 1) / kL, c);
  mg_prolong_t_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ec), static_cast<float*>(out), hp_c, lanes, out_rows, wp,
      w, c7, c8);
  return static_cast<int>(cudaGetLastError());
}
