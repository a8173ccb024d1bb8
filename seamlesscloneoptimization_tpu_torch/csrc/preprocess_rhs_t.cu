// preprocess_rhs_t: u8 destination and patch + eroded mask -> the Poisson
// right-hand side, transposed, at the origin of a zero-padded f32 slab.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_kernels.py:
// preprocess_rhs_transposed_pallas (bodies _fused_lap_tile, _pre_strip_kernel_t).
//
// For the (h, w) ROI and its interior pixel (y, x), 1 <= y <= h-2,
// 1 <= x <= w-2:
//   gx(img)[y][x] = img[y][x+1] - img[y][x]   (0 in the last column)
//   gy(img)[y][x] = img[y+1][x] - img[y][x]   (0 in the last row)
//   MIXED (flags 2): where take_d, the patch gradient is replaced by the
//     destination's; take_d = |gx_p - gy_p| <= |gx_d - gy_d| ("opencv") or
//     gx_p^2 + gy_p^2 < gx_d^2 + gy_d^2 ("norm")
//   gx = me ? gx_p : gx_d (likewise gy), me the eroded {0,1} mask
//   lap = (gx[y][x] - gx[y][x-1]) + (gy[y][x] - gy[y-1][x]), minus the
//     destination's Dirichlet border pixel on the rows/cols next to it
//   out[c, x-1, y-1] = lap; every other element of the (C, WPo, HPo) slab
//     is written as an exact zero (the padded GEMM chain relies on it).
// Every value is an integer of magnitude < 2^11 in f32, so the result is
// exact: bit-equal to the plain PyTorch twin and to the TPU kernel.
//
// Bound on this card: bytes. u8 destination, patch and mask read once,
// f32 slab written once (74 MB at the headline ROI), ~30 flops per pixel.
// Design: one block per (channel, 32x32 output tile). It stages the 34x34
// input window (the tile and its 1-px halo) of all three inputs in shared
// memory, computes the blended guidance on a 33x33 grid there, then the
// divergence, and stores the tile transposed in shared memory (row padded to
// 33 floats) so that the global writes run along the slab's minor axis:
// reads and writes are both coalesced. The destination and the patch are
// read through element strides, so the planar serve buffer, an interleaved
// image and a stride-0 broadcast gray patch (MONOCHROME) need no copy.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// and returns the launch's cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kG = kTile + 1;    // guidance grid: y-1 .. y+31 relative
constexpr int kWin = kTile + 2;  // input window: y-1 .. y+32 relative

struct Strides {
  long long c, h, w;
};

__device__ __forceinline__ void gradients(const float (*img)[kWin], int ty,
                                          int tx, int y, int x, int h, int w,
                                          float* gx, float* gy) {
  *gx = (x < w - 1) ? img[ty][tx + 1] - img[ty][tx] : 0.0f;
  *gy = (y < h - 1) ? img[ty + 1][tx] - img[ty][tx] : 0.0f;
}

__global__ void preprocess_rhs_t_kernel(
    const uint8_t* __restrict__ dest, Strides ds,
    const uint8_t* __restrict__ patch, Strides ps,
    const uint8_t* __restrict__ me, float* __restrict__ out, int h, int w,
    int wpo, int hpo, int mixed, int norm_rule) {
  __shared__ float sd[kWin][kWin];
  __shared__ float sp[kWin][kWin];
  __shared__ float sm[kWin][kWin];
  __shared__ float sgx[kG][kG];
  __shared__ float sgy[kG][kG];
  __shared__ float slap[kTile][kTile + 1];  // [x - x0][y - y0]

  const int c = blockIdx.z;
  const int r0 = blockIdx.x * kTile;  // output minor index r = y - 1
  const int j0 = blockIdx.y * kTile;  // output major index j = x - 1
  // window origin in image coordinates: (y, x) = (r0, j0) is window (0, 0),
  // so interior pixel y = r0 + 1 + rr sits at window row 1 + rr.
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;

  const uint8_t* dc = dest + c * ds.c;
  const uint8_t* pc = patch + c * ps.c;
  for (int i = tid; i < kWin * kWin; i += nt) {
    const int ty = i / kWin, tx = i % kWin;
    const int y = r0 + ty, x = j0 + tx;
    float vd = 0.0f, vp = 0.0f, vm = 0.0f;
    if (y < h && x < w) {
      vd = static_cast<float>(dc[y * ds.h + x * ds.w]);
      vp = static_cast<float>(pc[y * ps.h + x * ps.w]);
      vm = static_cast<float>(me[(size_t)y * w + x]);
    }
    sd[ty][tx] = vd;
    sp[ty][tx] = vp;
    sm[ty][tx] = vm;
  }
  __syncthreads();

  for (int i = tid; i < kG * kG; i += nt) {
    const int ty = i / kG, tx = i % kG;
    const int y = r0 + ty, x = j0 + tx;
    float gxd, gyd, gxp, gyp;
    gradients(sd, ty, tx, y, x, h, w, &gxd, &gyd);
    gradients(sp, ty, tx, y, x, h, w, &gxp, &gyp);
    if (mixed) {
      const bool take_d =
          norm_rule ? (gxp * gxp + gyp * gyp) < (gxd * gxd + gyd * gyd)
                    : fabsf(gxp - gyp) <= fabsf(gxd - gyd);
      if (take_d) {
        gxp = gxd;
        gyp = gyd;
      }
    }
    const bool in_mask = sm[ty][tx] != 0.0f;
    sgx[ty][tx] = in_mask ? gxp : gxd;
    sgy[ty][tx] = in_mask ? gyp : gyd;
  }
  __syncthreads();

  for (int i = tid; i < kTile * kTile; i += nt) {
    const int jj = i / kTile, rr = i % kTile;
    const int ty = rr + 1, tx = jj + 1;
    const int y = r0 + ty, x = j0 + tx;
    float lap = 0.0f;
    if (y <= h - 2 && x <= w - 2) {
      lap = (sgx[ty][tx] - sgx[ty][tx - 1]) + (sgy[ty][tx] - sgy[ty - 1][tx]);
      if (y == 1) lap -= sd[ty - 1][tx];
      if (y == h - 2) lap -= sd[ty + 1][tx];
      if (x == 1) lap -= sd[ty][tx - 1];
      if (x == w - 2) lap -= sd[ty][tx + 1];
    }
    slap[jj][rr] = lap;
  }
  __syncthreads();

  float* oc = out + (size_t)c * wpo * hpo;
  for (int i = tid; i < kTile * kTile; i += nt) {
    const int jj = i / kTile, rr = i % kTile;
    const int j = j0 + jj, r = r0 + rr;
    if (j < wpo && r < hpo) oc[(size_t)j * hpo + r] = slap[jj][rr];
  }
}

}  // namespace

// dest/patch: u8 (C, h, w) views given by element strides (dsc, dsh, dsw),
// (psc, psh, psw); me: (h, w) u8 {0,1} contiguous; out: (c, wpo, hpo) f32
// contiguous with wpo >= w-2, hpo >= h-2. flags: 1 NORMAL, 2 MIXED;
// norm_rule: 0 "opencv", 1 "norm".
extern "C" int preprocess_rhs_t_launch(
    const void* dest, long long dsc, long long dsh, long long dsw,
    const void* patch, long long psc, long long psh, long long psw,
    const void* me, void* out, int c, int h, int w, int wpo, int hpo,
    int flags, int norm_rule, void* stream) {
  if (c <= 0 || wpo <= 0 || hpo <= 0) return 0;
  const dim3 block(32, 8);
  const dim3 grid((hpo + kTile - 1) / kTile, (wpo + kTile - 1) / kTile, c);
  preprocess_rhs_t_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(dest), Strides{dsc, dsh, dsw},
      static_cast<const uint8_t*>(patch), Strides{psc, psh, psw},
      static_cast<const uint8_t*>(me), static_cast<float*>(out), h, w, wpo, hpo,
      flags == 2 ? 1 : 0, norm_rule);
  return static_cast<int>(cudaGetLastError());
}
