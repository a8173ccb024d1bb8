// transpose_pair: transpose of the lane concat [a | b] over a row window,
// optionally fused with the spectral divide.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:
// transpose_pair_pallas (bodies _tp_pair_kernel, _tp_pair_div_kernel). The
// pair chain runs it three times a frame: once after the forward-h
// half-GEMMs, and twice with the divide (the even and the odd window of the
// grouped h spectrum) after the forward-w half-GEMMs. Reading the two GEMM
// outputs as a pair and writing each window whole keeps every concat and
// slice out of memory.
//
// x = [a | b] is (C, M, P) with P = PA + PB; out (C, P, rc):
//   out[c, p, r] = x[c, row_start + r, p]
//                  (/ (lam_p[p] + lam_r[row_start + r]) with the divide).
//
// Bound on this card: bytes. One f32 read and one f32 write per element of
// the window (52 MB each way for the headline (3, 2432, 896) pair); the divide
// adds two flops per 8 bytes. Design: transpose.cu's shared-memory tile, a
// 32 x 32 tile read along p and written along r, rows padded to 33 floats;
// a tile column picks a or b by its p. The eigenvalue sum is taken first
// and the divide is IEEE (no fast math), so the result is bit-equal to the
// plain PyTorch twin on the card.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // blockDim.y

template <bool kDiv>
__global__ void transpose_pair_kernel(const float* __restrict__ a,
                                      const float* __restrict__ b,
                                      float* __restrict__ out,
                                      const float* __restrict__ lam_p,
                                      const float* __restrict__ lam_r, int m,
                                      int pa, int pb, int row_start, int rc) {
  __shared__ float tile[kTile][kTile + 1];
  const int p_all = pa + pb;
  const int ci = blockIdx.z;
  const float* ac = a + (size_t)ci * m * pa;
  const float* bc = b + (size_t)ci * m * pb;
  float* oc = out + (size_t)ci * p_all * rc;
  const int r0 = blockIdx.y * kTile;
  const int p0 = blockIdx.x * kTile;

  const int p = p0 + threadIdx.x;
  for (int i = threadIdx.y; i < kTile; i += kRows) {
    const int r = r0 + i;
    if (r < rc && p < p_all) {
      const size_t row = (size_t)(row_start + r);
      tile[i][threadIdx.x] = p < pa ? ac[row * pa + p] : bc[row * pb + (p - pa)];
    }
  }
  __syncthreads();

  const int r = r0 + threadIdx.x;
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    const int pj = p0 + j;
    if (pj < p_all && r < rc) {
      float v = tile[threadIdx.x][j];
      if (kDiv) v = v / (lam_p[pj] + lam_r[row_start + r]);
      oc[(size_t)pj * rc + r] = v;
    }
  }
}

}  // namespace

// a: (c, m, pa), b: (c, m, pb) f32 contiguous; out: (c, pa + pb, rc).
// lam_p (len pa + pb) and lam_r (len m) are both null or both set.
extern "C" int transpose_pair_launch(const void* a, const void* b, void* out,
                                     const void* lam_p, const void* lam_r, int c,
                                     int m, int pa, int pb, int row_start,
                                     int rc, void* stream) {
  if (c <= 0 || rc <= 0 || pa + pb <= 0) return 0;
  const dim3 block(kTile, kRows);
  const dim3 grid((pa + pb + kTile - 1) / kTile, (rc + kTile - 1) / kTile, c);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  float* op = static_cast<float*>(out);
  if (lam_p != nullptr) {
    transpose_pair_kernel<true><<<grid, block, 0, s>>>(
        ap, bp, op, static_cast<const float*>(lam_p),
        static_cast<const float*>(lam_r), m, pa, pb, row_start, rc);
  } else {
    transpose_pair_kernel<false><<<grid, block, 0, s>>>(
        ap, bp, op, nullptr, nullptr, m, pa, pb, row_start, rc);
  }
  return static_cast<int>(cudaGetLastError());
}
