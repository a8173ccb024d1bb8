// rhs_tile.cuh: the Poisson right-hand side of one 32x32 interior tile, for
// preprocess_rhs_p.cu (natural store), the only source that includes it
// (preprocess_rhs_t.cu and preprocess_rhs_q.cu are on rhs_wide.cuh). The TPU
// kernels share the function the same way (pallas_kernels.py:_fused_lap_tile).
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
//     destination's Dirichlet border pixel on the rows/cols next to it.
// Every value is an integer of magnitude < 2^11 in f32, so the result is
// exact: bit-equal to the plain PyTorch twin and to the TPU kernels.
//
// A block stages the 34x34 input window (the tile and its 1-px halo) of the
// three u8 inputs in shared memory, computes the blended guidance on a
// 33x33 grid there, then the divergence into lap[x - x0][y - y0] (rows
// padded to 33 floats, so both a transposed and a natural store read it
// without bank conflicts). Outside the interior lap is an exact 0. The
// destination and the patch are read through element strides: the planar
// serve buffer, an interleaved image and a stride-0 broadcast gray patch
// (MONOCHROME) need no copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rhs {

constexpr int kTile = 32;
constexpr int kG = kTile + 1;    // guidance grid: y-1 .. y+31 relative
constexpr int kWin = kTile + 2;  // input window: y-1 .. y+32 relative

struct Strides {
  long long c, h, w;
};

struct Smem {
  float d[kWin][kWin];
  float p[kWin][kWin];
  float m[kWin][kWin];
  float gx[kG][kG];
  float gy[kG][kG];
  float lap[kTile][kTile + 1];  // [x - x0][y - y0]
};

__device__ __forceinline__ void gradients(const float (*img)[kWin], int ty,
                                          int tx, int y, int x, int h, int w,
                                          float* gx, float* gy) {
  *gx = (x < w - 1) ? img[ty][tx + 1] - img[ty][tx] : 0.0f;
  *gy = (y < h - 1) ? img[ty + 1][tx] - img[ty][tx] : 0.0f;
}

// Fills s.lap for the interior tile whose first pixel is (y, x) =
// (r0 + 1, j0 + 1), i.e. lap[jj][rr] = RHS at output (r0 + rr, j0 + jj).
// Ends with __syncthreads(): s.lap is ready for the caller's store.
__device__ __forceinline__ void lap_tile(
    Smem& s, const uint8_t* __restrict__ dest, Strides ds,
    const uint8_t* __restrict__ patch, Strides ps,
    const uint8_t* __restrict__ me, int c, int h, int w, int r0, int j0,
    int mixed, int norm_rule) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  // window origin in image coordinates: (y, x) = (r0, j0) is window (0, 0)
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
    s.d[ty][tx] = vd;
    s.p[ty][tx] = vp;
    s.m[ty][tx] = vm;
  }
  __syncthreads();

  for (int i = tid; i < kG * kG; i += nt) {
    const int ty = i / kG, tx = i % kG;
    const int y = r0 + ty, x = j0 + tx;
    float gxd, gyd, gxp, gyp;
    gradients(s.d, ty, tx, y, x, h, w, &gxd, &gyd);
    gradients(s.p, ty, tx, y, x, h, w, &gxp, &gyp);
    if (mixed) {
      const bool take_d =
          norm_rule ? (gxp * gxp + gyp * gyp) < (gxd * gxd + gyd * gyd)
                    : fabsf(gxp - gyp) <= fabsf(gxd - gyd);
      if (take_d) {
        gxp = gxd;
        gyp = gyd;
      }
    }
    const bool in_mask = s.m[ty][tx] != 0.0f;
    s.gx[ty][tx] = in_mask ? gxp : gxd;
    s.gy[ty][tx] = in_mask ? gyp : gyd;
  }
  __syncthreads();

  for (int i = tid; i < kTile * kTile; i += nt) {
    const int jj = i / kTile, rr = i % kTile;
    const int ty = rr + 1, tx = jj + 1;
    const int y = r0 + ty, x = j0 + tx;
    float lap = 0.0f;
    if (y <= h - 2 && x <= w - 2) {
      lap = (s.gx[ty][tx] - s.gx[ty][tx - 1]) + (s.gy[ty][tx] - s.gy[ty - 1][tx]);
      if (y == 1) lap -= s.d[ty - 1][tx];
      if (y == h - 2) lap -= s.d[ty + 1][tx];
      if (x == 1) lap -= s.d[ty][tx - 1];
      if (x == w - 2) lap -= s.d[ty][tx + 1];
    }
    s.lap[jj][rr] = lap;
  }
  __syncthreads();
}

}  // namespace rhs
