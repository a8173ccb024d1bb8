// preprocess_rhs_q: u8 destination and patch + eroded mask -> the Poisson
// right-hand side born as the four quarter planes of the multigrid's finest
// level, (C, 4, HPo/2, WPo/2) f32.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:
// preprocess_rhs_quarters_pallas (_pre_strip_kernel_pq).
//
// The dense (HPo, WPo) slab of preprocess_rhs_p (the interior RHS at the
// origin, exact zeros elsewhere) goes to plane 2 (r & 1) + (j & 1) at
// (r >> 1, j >> 1). Every element of the output is written. The RHS is
// rhs_wide.cuh's (integer arithmetic, exact).
//
// Bound on this card: bytes. u8 destination, patch and mask read once, f32
// planes written once: 204 MB at 8K (ROI 3 x 2800 x 3800 -> 3 x 4 x 1408 x
// 1920; 0.061 ms at 3.35 TB/s), ~30 integer operations per pixel. The first
// design (one block per channel and 32 x 32 tile, byte loads through 64-bit
// strides, the mask read again per channel, the guidance and the divergence
// as two float passes through shared memory, stores in 64-byte runs) took
// 0.290 ms: the loads and the store 0.225, the guidance 0.044, the
// divergence 0.021 (PERF.md section 6). Design (rhs_wide.cuh): one block
// of 64 x 4 threads for all channels (up to 3) of a 16 x 256 dense tile, in
// two row passes; the window rows of the three inputs land as asynchronous
// 16-byte copies from the aligned chunk below each row's first pixel (byte
// loads for an interleaved destination), the mask once, the second pass's
// rows while the first pass computes; a thread owns a 2 x 4 dense patch:
// it reads its two words of a window row across the row's byte shift,
// keeps the guidance in registers (a NORMAL patch inside the interior two
// columns at a time in 16-bit lanes, any other one pixel at a time with
// every edge test) and writes one float2 to each of the four planes, so a
// warp writes whole 128-byte lines. It takes 0.120 ms at 8K: the staging
// alone 0.065, which runs the reads at about half the card's rate (short
// row segments from seven arrays); the NORMAL kernel is capped at 64
// registers (4 blocks an SM), 10% faster than uncapped at 90.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns the launch's cudaError_t.

#include "rhs_wide.cuh"

namespace {

using namespace rhsw;

// NORMAL's resident blocks an SM: registers capped at 65536 / (256 x 4).
constexpr int kNormalBlocks = 4;

// Row pass q of the tile at dense (r0, j0): every channel's RHS of the
// thread's 2 x 4 dense patch at window rows kPassR q + 2 ty .., written to
// the quarter planes.
template <int kMode>
__device__ __forceinline__ void rhs_pass(const Window& s, const Inputs& in,
                                         float* __restrict__ out, int c_lo, int h, int w,
                                         int hpo, int wpo, int r0, int j0, int q, bool vec) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int wr = kPassR * q + 2 * ty;        // the patch's first window row
  const int y0 = r0 + wr, x0 = j0 + 4 * tx;  // its image (y, x)
  const int r = y0, j = x0;                  // the patch's first dense output
  if (r >= hpo || j >= wpo) return;
  const bool packed = kMode == 0 &&
                      y0 >= 1 && y0 + 2 < h - 2 && x0 >= 1 && x0 + 4 < w - 2;
  uint32_t M[3][2], mm[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    row_words(s, 0, wr + a, tx, M[a]);
#pragma unroll
    for (int f = 0; f < 3; ++f) mm[a][f] = lane_mask(lanes(M[a], f));
  }
  const int hq = hpo / 2, wq = wpo / 2;
  const size_t pl = (size_t)hq * wq;
  const size_t at = (size_t)(r >> 1) * wq + (j >> 1);
  const bool full = j + 4 <= wpo;  // else only columns j, j + 1 (wpo is even)
  for (int k = 0; k < in.nc; ++k) {
    uint32_t D[4][2], P[4][2];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      row_words(s, 1 + k, wr + a, tx, D[a]);
      row_words(s, 1 + in.nc + k, wr + a, tx, P[a]);
    }
    float lap[2][4];
    if (packed)
      rhs_patch_packed(D, P, mm, lap);
    else
      rhs_patch<kMode>(D, P, M, y0, x0, h, w, lap);
    // plane p = 2 i + (k & 1) takes columns k = p & 1, (p & 1) + 2 of row i
    float* oc = out + (size_t)(c_lo + k) * 4 * pl + at;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int i = p >> 1, kk = p & 1;
      if (vec && full) {
        *reinterpret_cast<float2*>(oc + p * pl) = make_float2(lap[i][kk], lap[i][kk + 2]);
      } else {
        oc[p * pl] = lap[i][kk];
        if (full) oc[p * pl + 1] = lap[i][kk + 2];
      }
    }
  }
}

// One block per (channel group, 32 x 128 dense tile): two row passes, the
// second one's window rows copied while the block computes the first.
template <int kMode>
__global__ void __launch_bounds__(kThreads, kMode == 0 ? kNormalBlocks : 1)
preprocess_rhs_q_kernel(const uint8_t* __restrict__ dest, long long dsc, long long dsh,
                        long long dsw, const uint8_t* __restrict__ patch, long long psc,
                        long long psh, long long psw, const uint8_t* __restrict__ me,
                        float* __restrict__ out, int c, int h, int w, int hpo, int wpo,
                        bool vec) {
  __shared__ __align__(16) Window s;
  const int j0 = blockIdx.x * kTileC;  // dense minor index j = x - 1
  const int r0 = blockIdx.y * kTileR;  // dense major index r = y - 1
  const int c_lo = blockIdx.z * kMaxC;
  const int nc = min(kMaxC, c - c_lo);
  const Inputs in{Src{me, w, 1}, Src{dest + c_lo * dsc, dsh, dsw},
                  Src{patch + c_lo * psc, psh, psw}, dsc, psc, nc};
  static_assert(kPasses == 2, "the staging below is written for two row passes");
  constexpr int kFirst = kPassR + 2;  // window rows of the first pass
  stage_rows<kFirst>(s, in, h, w, r0, j0, 0);
  acp::commit();
  stage_rows<kWinR - kFirst>(s, in, h, w, r0, j0, kFirst);
  acp::commit();
  acp::wait<1>();
  __syncthreads();
  rhs_pass<kMode>(s, in, out, c_lo, h, w, hpo, wpo, r0, j0, 0, vec);
  acp::wait<0>();
  __syncthreads();
  rhs_pass<kMode>(s, in, out, c_lo, h, w, hpo, wpo, r0, j0, 1, vec);
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
  const dim3 block(kTX, kTY);
  const dim3 grid((wpo + kTileC - 1) / kTileC, (hpo + kTileR - 1) / kTileR,
                  (c + kMaxC - 1) / kMaxC);
  const bool vec = (wpo / 2) % 2 == 0 && (reinterpret_cast<size_t>(out) & 7) == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const uint8_t*>(dest);
  const auto* p = static_cast<const uint8_t*>(patch);
  const auto* m = static_cast<const uint8_t*>(me);
  auto* o = static_cast<float*>(out);
  if (flags != 2)
    preprocess_rhs_q_kernel<0><<<grid, block, 0, st>>>(d, dsc, dsh, dsw, p, psc, psh, psw, m,
                                                       o, c, h, w, hpo, wpo, vec);
  else if (norm_rule == 0)
    preprocess_rhs_q_kernel<1><<<grid, block, 0, st>>>(d, dsc, dsh, dsw, p, psc, psh, psw, m,
                                                       o, c, h, w, hpo, wpo, vec);
  else
    preprocess_rhs_q_kernel<2><<<grid, block, 0, st>>>(d, dsc, dsh, dsw, p, psc, psh, psw, m,
                                                       o, c, h, w, hpo, wpo, vec);
  return static_cast<int>(cudaGetLastError());
}
