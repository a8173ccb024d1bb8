// transpose: (C, A, B) f32 -> (C, B, A), optionally fused with the DST
// spectral divide out[c, b, a] = x[c, a, b] / (lam_b[b] + lam_a[a]).
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:transpose_pallas
// (bodies _transpose_kernel, _transpose_div_kernel). The DST-GEMM chain runs
// it three times a frame between its four GEMMs; the middle launch divides.
//
// Bound on this card: bytes. One f32 read and one f32 write per element
// (97 MB a launch on the (3, 2432, 1664) headline slab); the divide adds two
// flops per 8 bytes. Design: the classic shared-memory tiled transpose. A
// 32x32 tile is read with threads along B (coalesced), written with threads
// along A (coalesced); the tile row is padded to 33 floats so the column
// reads of shared memory hit 32 different banks. The eigenvalue sum is taken
// first and the divide is IEEE (no fast math), so the result is bit-equal to
// the plain PyTorch twin on the card.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // blockDim.y: each thread moves kTile / kRows elements

template <bool kDiv>
__global__ void transpose_kernel(const float* __restrict__ x,
                                 float* __restrict__ out,
                                 const float* __restrict__ lam_a,
                                 const float* __restrict__ lam_b, int a, int b) {
  __shared__ float tile[kTile][kTile + 1];
  const size_t plane = (size_t)a * b;
  const float* xc = x + blockIdx.z * plane;
  float* oc = out + blockIdx.z * plane;
  const int a0 = blockIdx.y * kTile;
  const int b0 = blockIdx.x * kTile;

  const int bi = b0 + threadIdx.x;
  for (int i = threadIdx.y; i < kTile; i += kRows) {
    const int ai = a0 + i;
    if (ai < a && bi < b) tile[i][threadIdx.x] = xc[(size_t)ai * b + bi];
  }
  __syncthreads();

  const int ai = a0 + threadIdx.x;
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    const int bj = b0 + j;
    if (bj < b && ai < a) {
      float v = tile[threadIdx.x][j];
      if (kDiv) v = v / (lam_b[bj] + lam_a[ai]);
      oc[(size_t)bj * a + ai] = v;
    }
  }
}

}  // namespace

// lam_a (len a) and lam_b (len b) are both null (plain transpose) or both
// set (fused divide).
extern "C" int transpose_launch(const void* x, void* out, const void* lam_a,
                                const void* lam_b, int c, int a, int b,
                                void* stream) {
  if (c <= 0 || a <= 0 || b <= 0) return 0;
  const dim3 block(kTile, kRows);
  const dim3 grid((b + kTile - 1) / kTile, (a + kTile - 1) / kTile, c);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  if (lam_a != nullptr) {
    transpose_kernel<true><<<grid, block, 0, s>>>(
        xp, op, static_cast<const float*>(lam_a),
        static_cast<const float*>(lam_b), a, b);
  } else {
    transpose_kernel<false><<<grid, block, 0, s>>>(xp, op, nullptr, nullptr, a, b);
  }
  return static_cast<int>(cudaGetLastError());
}
