// fold.cuh: the unfold arithmetic shared by unfold_minor.cu,
// unfold_transpose.cu and unfold_clamp_paste.cu.
//
// The inverse folded DST produces, per row, E (the even half-GEMM output)
// and O (the odd one), both valid on lanes [0, he) with he = ceil(n/2). The
// natural-order row is
//   out[x] = E[x] + O[x]              for x < he,
//   out[x] = E[n-1-x] - O[n-1-x]      for he <= x < n   (n-1-x < ho),
//   out[x] = 0                        for x >= n.
// On the TPU the reversal is an anti-identity matmul per 128-lane block plus
// a roll (pallas_kernels.py:_rev_lanes); here it is index arithmetic, and a
// warp reading lanes n-1-x for 32 neighbouring x still reads one contiguous
// run of memory.

#pragma once

__device__ __forceinline__ float unfold_at(const float* __restrict__ e,
                                           const float* __restrict__ o, int n,
                                           int x) {
  const int he = n - n / 2;
  if (x < he) return e[x] + o[x];
  if (x < n) {
    const int k = n - 1 - x;
    return e[k] - o[k];
  }
  return 0.0f;
}
