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
// adds two flops per 8 bytes. The eigenvalue sum is taken first and the
// divide is IEEE (no fast math), so the result is bit-equal to the plain
// PyTorch twin on the card.
//
// Design (whole tiles: PA, PB and rc multiples of kT, row_start of 4, every
// pointer 16-byte aligned, as on the chain, where every dimension is a
// multiple of 128): one block of 256 threads a kT x kT tile (64 window rows
// x 64 columns), which lies wholly in a or in b. Each thread issues its four
// float4 loads along p before its first store into the shared tile; the
// tile's float4 unit (row, q) sits at column q ^ ((row >> 2) & 7), an XOR
// swizzle on 16-byte units, so the row-wise float4 writes and the 4-row
// float4 reads of the transposed pass are both free of bank conflicts. A
// thread then owns a 4 x 4 block: four float4 reads, a transpose in
// registers, and four float4 stores along r (16 lanes a 256-byte run). The
// divide reads the block's 4 lam_p and 4 lam_r values as two float4 loads,
// once a tile per thread, not once an element. The first design (a 32 x 32
// tile of 4-byte accesses, a global lam_p load an element) took 0.0608 ms
// for the headline plain pair and 0.0483 for a divide window, cold.
// Other shapes (ragged P, windows of any length) take that design, kept as
// transpose_pair_ragged.
//
// The divide on a strip (the per-axis route's 2 x (3, 128, 1280) -> (3,
// 2560, 128): 240 tiles, fewer than two blocks an SM) is latency-bound:
// there an IEEE divide of 0, which takes the divide's slow path, costs the
// block its time. The chain's padding rows and lanes make about a tenth
// of the dividends 0, and on an H100 80GB HBM3 at 700 W they took the
// launch from 0.0040 to 0.0061 ms back to back (chip_smoke.py, PERF.md
// section 6). So the strip's divide (kZeros) takes 0 / x as 0 x x: the
// same signed zero for a finite nonzero x, without the divide.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;           // tile: kT window rows x kT columns
constexpr int kQ = kT / 4;       // float4 units a tile row
constexpr int kThreads = 256;    // kQ x 16 threads
constexpr int kPass = kThreads / kQ;  // tile rows a load pass (16)

__device__ __forceinline__ int swizzle(int row, int q) { return q ^ ((row >> 2) & 7); }

__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 0 / den as the product 0 x den, the IEEE quotient's signed zero for a
// finite nonzero den; any other v / den as the IEEE divide.
__device__ __forceinline__ float quotient(float v, float den) {
  return v == 0.0f && den != 0.0f && fabsf(den) <= 3.402823466e38f ? v * den : v / den;
}

template <bool kDiv, bool kZeros = false>
__global__ void __launch_bounds__(kThreads)
transpose_pair_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ out, const float* __restrict__ lam_p,
                      const float* __restrict__ lam_r, int m, int pa, int pb, int row_start,
                      int rc) {
  __shared__ float4 tile[kT][kQ];
  const int p_all = pa + pb;
  const int ci = blockIdx.z;
  const int p0 = blockIdx.x * kT, r0 = blockIdx.y * kT;
  const int t = threadIdx.x;
  const bool in_a = p0 < pa;
  const int ld = in_a ? pa : pb;
  const float* src = (in_a ? a : b) +
                     ((size_t)ci * m + row_start + r0) * ld + (in_a ? p0 : p0 - pa);

  // load: thread (row t / kQ + kPass i, unit t % kQ) of the tile
  const int q = t % kQ, rr = t / kQ;
  float4 v[kT / kPass];
#pragma unroll
  for (int i = 0; i < kT / kPass; ++i)
    v[i] = __ldg(reinterpret_cast<const float4*>(src + (size_t)(rr + kPass * i) * ld) + q);
#pragma unroll
  for (int i = 0; i < kT / kPass; ++i) {
    const int row = rr + kPass * i;
    tile[row][swizzle(row, q)] = v[i];
  }
  __syncthreads();

  // store: thread (r4 = t % 16, p4 = t / 16) owns tile rows 4 r4 .. 4 r4 + 3
  // and columns 4 p4 .. 4 p4 + 3: out[p0 + 4 p4 + i][r0 + 4 r4 + j]
  const int r4 = t % 16, p4 = t / 16;
  float4 s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = tile[4 * r4 + j][swizzle(4 * r4 + j, p4)];
  float4 lp = make_float4(0.f, 0.f, 0.f, 0.f), lr = lp;
  if (kDiv) {
    lp = __ldg(reinterpret_cast<const float4*>(lam_p + p0 + 4 * p4));
    lr = __ldg(reinterpret_cast<const float4*>(lam_r + row_start + r0 + 4 * r4));
  }
  float* dst = out + ((size_t)ci * p_all + p0 + 4 * p4) * rc + r0 + 4 * r4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o[j] = at(s[j], i);
      if (kDiv && kZeros) o[j] = quotient(o[j], at(lp, i) + at(lr, j));
      else if (kDiv) o[j] = o[j] / (at(lp, i) + at(lr, j));
    }
    *reinterpret_cast<float4*>(dst + (size_t)i * rc) = make_float4(o[0], o[1], o[2], o[3]);
  }
}

// Any shape: a 32 x 32 tile of 4-byte accesses, rows padded to 33 floats; a
// tile column picks a or b by its p.
constexpr int kRagged = 32;
constexpr int kRaggedRows = 8;  // blockDim.y

template <bool kDiv>
__global__ void transpose_pair_ragged(const float* __restrict__ a,
                                      const float* __restrict__ b,
                                      float* __restrict__ out,
                                      const float* __restrict__ lam_p,
                                      const float* __restrict__ lam_r, int m,
                                      int pa, int pb, int row_start, int rc) {
  __shared__ float tile[kRagged][kRagged + 1];
  const int p_all = pa + pb;
  const int ci = blockIdx.z;
  const float* ac = a + (size_t)ci * m * pa;
  const float* bc = b + (size_t)ci * m * pb;
  float* oc = out + (size_t)ci * p_all * rc;
  const int r0 = blockIdx.y * kRagged;
  const int p0 = blockIdx.x * kRagged;

  const int p = p0 + threadIdx.x;
  for (int i = threadIdx.y; i < kRagged; i += kRaggedRows) {
    const int r = r0 + i;
    if (r < rc && p < p_all) {
      const size_t row = (size_t)(row_start + r);
      tile[i][threadIdx.x] = p < pa ? ac[row * pa + p] : bc[row * pb + (p - pa)];
    }
  }
  __syncthreads();

  const int r = r0 + threadIdx.x;
  for (int j = threadIdx.y; j < kRagged; j += kRaggedRows) {
    const int pj = p0 + j;
    if (pj < p_all && r < rc) {
      float v = tile[threadIdx.x][j];
      if (kDiv) v = v / (lam_p[pj] + lam_r[row_start + r]);
      oc[(size_t)pj * rc + r] = v;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <bool kDiv>
void launch(const float* a, const float* b, float* out, const float* lam_p,
            const float* lam_r, int c, int m, int pa, int pb, int row_start, int rc,
            int sms, cudaStream_t s) {
  const bool whole = pa % kT == 0 && pb % kT == 0 && rc % kT == 0 && row_start % 4 == 0 &&
                     aligned16(a) && aligned16(b) && aligned16(out) &&
                     (!kDiv || (aligned16(lam_p) && aligned16(lam_r)));
  if (whole) {
    const dim3 grid((pa + pb) / kT, rc / kT, c);
    if constexpr (kDiv) {
      if ((long long)grid.x * grid.y * c < 2LL * sms) {  // a strip
        transpose_pair_kernel<true, true><<<grid, kThreads, 0, s>>>(a, b, out, lam_p, lam_r, m,
                                                                    pa, pb, row_start, rc);
        return;
      }
    }
    transpose_pair_kernel<kDiv><<<grid, kThreads, 0, s>>>(a, b, out, lam_p, lam_r, m, pa, pb,
                                                          row_start, rc);
  } else {
    const dim3 grid((pa + pb + kRagged - 1) / kRagged, (rc + kRagged - 1) / kRagged, c);
    transpose_pair_ragged<kDiv><<<grid, dim3(kRagged, kRaggedRows), 0, s>>>(
        a, b, out, lam_p, lam_r, m, pa, pb, row_start, rc);
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
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(a);
  const float* bp = static_cast<const float*>(b);
  float* op = static_cast<float*>(out);
  if (lam_p != nullptr)
    launch<true>(ap, bp, op, static_cast<const float*>(lam_p),
                 static_cast<const float*>(lam_r), c, m, pa, pb, row_start, rc, sms, s);
  else
    launch<false>(ap, bp, op, nullptr, nullptr, c, m, pa, pb, row_start, rc, sms, s);
  return static_cast<int>(cudaGetLastError());
}
