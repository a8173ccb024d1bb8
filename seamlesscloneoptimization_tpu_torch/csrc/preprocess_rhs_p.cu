// preprocess_rhs_p: u8 destination and patch + eroded mask -> the Poisson
// right-hand side, natural orientation, at the origin of a zero-padded f32
// slab of any size (HPo, WPo) >= (h-2, w-2).
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:
// preprocess_rhs_padded_pallas (_pre_strip_kernel_p), and with
// (HPo, WPo) = (h-2, w-2) the exact-size preprocess_rhs_pallas
// (_pre_strip_kernel, tile function _fused_lap_tile), whose multigrid serve
// tail pads the result to the level geometry right after.
//
// out[c, y-1, x-1] = lap(y, x) for interior pixels, rhs_wide.cuh's integer
// arithmetic (exact); every other element of the (C, HPo, WPo) slab is
// written as an exact zero (the multigrid's padded levels rely on it).
//
// Bound on this card: bytes. u8 destination, patch and mask read once, f32
// slab written once: 204 MB at the 8K level-0 slab (ROI 3 x 2800 x 3800 ->
// 3 x 2816 x 3840; 0.061 ms at 3.35 TB/s), 70.5 MB at the headline's exact
// size (3 x 1550 x 2398 -> 3 x 1548 x 2396; 0.021 ms); ~30 integer
// operations per pixel. The first design (one block per channel and 32 x 32
// tile staging 34 x 34 windows of the three inputs byte by byte as floats,
// the mask read again per channel, the guidance and the divergence as float
// passes through shared memory behind three barriers) took 0.280-0.391 ms
// at 8K and 0.105-0.127 at the headline (PERF.md section 6). Design: that
// of preprocess_rhs_q.cu on rhs_wide.cuh, which reads the same u8 inputs
// and writes the same 8K bytes: one block of 64 x 4 threads for all
// channels (up to 3) of a 16 x 256 dense tile, in two row passes; stage_rows
// copies the window rows of the mask once and of every channel's
// destination and patch as asynchronous 16-byte chunks from the aligned
// chunk below each row's first pixel (byte loads for an interleaved
// destination; the stride-0 gray patch as any contiguous row), the second
// pass's rows landing while the first pass computes; a thread computes the
// RHS of a 2 x 4 dense patch (rhs_patch_packed, two columns at a time in
// 16-bit lanes, for a NORMAL patch inside the interior; rhs_patch, one
// pixel at a time with every edge test, otherwise) and writes it in the
// natural orientation: two float4 stores, one a row, where WPo % 4 == 0 and
// the slab is 16-byte aligned (a warp writes 512 contiguous bytes a row),
// else eight scalar stores cut at the slab's edge. Blocks wholly in the
// slab's zero padding (first dense row >= h-2 or first column >= w-2)
// stage nothing and write zeros the same way. Every element is written
// exactly once. It takes 0.118 ms at the 8K slab (preprocess_rhs_q 0.120
// in the same run) and 0.053 at the headline's exact size, where its 970
// blocks fill the card's 528 slots twice (PERF.md section 6, H100 80GB
// HBM3 at 700 W).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns the launch's cudaError_t.

#include "rhs_wide.cuh"

namespace {

using namespace rhsw;

// NORMAL's resident blocks an SM: registers capped at 65536 / (256 x 4).
constexpr int kNormalBlocks = 4;

// The thread's 2 x 4 dense patch at (r, j) of channel plane oc: two float4
// rows where vec (then j + 4 <= wpo), else scalars cut at the slab's edge.
__device__ __forceinline__ void store_patch(float* __restrict__ oc, const float (&lap)[2][4],
                                            int r, int j, int hpo, int wpo, bool vec) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (r + i >= hpo) break;
    float* row = oc + (size_t)(r + i) * wpo + j;
    if (vec) {
      *reinterpret_cast<float4*>(row) = make_float4(lap[i][0], lap[i][1], lap[i][2], lap[i][3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (j + k < wpo) row[k] = lap[i][k];
    }
  }
}

// Row pass q of the tile at dense (r0, j0): every channel's RHS of the
// thread's 2 x 4 dense patch at window rows kPassR q + 2 ty .., written to
// the slab (zeros only where `zero`: the block lies in the padding).
template <int kMode>
__device__ __forceinline__ void rhs_pass(const Window& s, const Inputs& in,
                                         float* __restrict__ out, int c_lo, int h, int w,
                                         int hpo, int wpo, int r0, int j0, int q, bool vec,
                                         bool zero) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int wr = kPassR * q + 2 * ty;        // the patch's first window row
  const int y0 = r0 + wr, x0 = j0 + 4 * tx;  // its image (y, x)
  const int r = y0, j = x0;                  // the patch's first dense output
  if (r >= hpo || j >= wpo) return;
  const size_t pl = (size_t)hpo * wpo;
  float lap[2][4];
  if (zero) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k) lap[i][k] = 0.0f;
    for (int k = 0; k < in.nc; ++k)
      store_patch(out + (size_t)(c_lo + k) * pl, lap, r, j, hpo, wpo, vec);
    return;
  }
  const bool packed = kMode == 0 &&
                      y0 >= 1 && y0 + 2 < h - 2 && x0 >= 1 && x0 + 4 < w - 2;
  uint32_t M[3][2], mm[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    row_words(s, 0, wr + a, tx, M[a]);
#pragma unroll
    for (int f = 0; f < 3; ++f) mm[a][f] = lane_mask(lanes(M[a], f));
  }
  for (int k = 0; k < in.nc; ++k) {
    uint32_t D[4][2], P[4][2];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      row_words(s, 1 + k, wr + a, tx, D[a]);
      row_words(s, 1 + in.nc + k, wr + a, tx, P[a]);
    }
    if (packed)
      rhs_patch_packed(D, P, mm, lap);
    else
      rhs_patch<kMode>(D, P, M, y0, x0, h, w, lap);
    store_patch(out + (size_t)(c_lo + k) * pl, lap, r, j, hpo, wpo, vec);
  }
}

// One block per (channel group, 16 x 256 dense tile): two row passes, the
// second one's window rows copied while the block computes the first.
template <int kMode>
__global__ void __launch_bounds__(kThreads, kMode == 0 ? kNormalBlocks : 1)
preprocess_rhs_p_kernel(const uint8_t* __restrict__ dest, long long dsc, long long dsh,
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
  if (r0 >= h - 2 || j0 >= w - 2) {  // the padding: zeros only
    for (int q = 0; q < kPasses; ++q)
      rhs_pass<kMode>(s, in, out, c_lo, h, w, hpo, wpo, r0, j0, q, vec, true);
    return;
  }
  static_assert(kPasses == 2, "the staging below is written for two row passes");
  constexpr int kFirst = kPassR + 2;  // window rows of the first pass
  stage_rows<kFirst>(s, in, h, w, r0, j0, 0);
  acp::commit();
  stage_rows<kWinR - kFirst>(s, in, h, w, r0, j0, kFirst);
  acp::commit();
  acp::wait<1>();
  __syncthreads();
  rhs_pass<kMode>(s, in, out, c_lo, h, w, hpo, wpo, r0, j0, 0, vec, false);
  acp::wait<0>();
  __syncthreads();
  rhs_pass<kMode>(s, in, out, c_lo, h, w, hpo, wpo, r0, j0, 1, vec, false);
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
  const dim3 block(kTX, kTY);
  const dim3 grid((wpo + kTileC - 1) / kTileC, (hpo + kTileR - 1) / kTileR,
                  (c + kMaxC - 1) / kMaxC);
  const bool vec = wpo % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const uint8_t*>(dest);
  const auto* p = static_cast<const uint8_t*>(patch);
  const auto* m = static_cast<const uint8_t*>(me);
  auto* o = static_cast<float*>(out);
  if (flags != 2)
    preprocess_rhs_p_kernel<0><<<grid, block, 0, st>>>(d, dsc, dsh, dsw, p, psc, psh, psw, m,
                                                       o, c, h, w, hpo, wpo, vec);
  else if (norm_rule == 0)
    preprocess_rhs_p_kernel<1><<<grid, block, 0, st>>>(d, dsc, dsh, dsw, p, psc, psh, psw, m,
                                                       o, c, h, w, hpo, wpo, vec);
  else
    preprocess_rhs_p_kernel<2><<<grid, block, 0, st>>>(d, dsc, dsh, dsw, p, psc, psh, psw, m,
                                                       o, c, h, w, hpo, wpo, vec);
  return static_cast<int>(cudaGetLastError());
}
