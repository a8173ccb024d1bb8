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

// Lanes k .. k + 3 (k a multiple of 4) of one row of e and of o as the
// unfold's two halves, s = e + o (output lanes k ..) and d = e - o (output
// lanes n - 1 - k ..). Lanes from he on read as 0: the GEMM's padding lanes
// never reach a result, and the caller writes no output of a lane >= he
// (d: >= n / 2). kVec: one float4 load each (the row 16-byte aligned, a
// whole float4 below the row's end wherever k < he).
template <bool kVec>
__device__ __forceinline__ void unfold_lanes4(const float* __restrict__ e,
                                              const float* __restrict__ o, int k, int he,
                                              float4& s, float4& d) {
  float a[4], b[4];
  if (kVec) {
    float4 va = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vb = va;
    if (k < he) {
      va = __ldg(reinterpret_cast<const float4*>(e + k));
      vb = __ldg(reinterpret_cast<const float4*>(o + k));
    }
    a[0] = va.x, a[1] = va.y, a[2] = va.z, a[3] = va.w;
    b[0] = vb.x, b[1] = vb.y, b[2] = vb.z, b[3] = vb.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = k + i < he ? __ldg(e + k + i) : 0.0f;
      b[i] = k + i < he ? __ldg(o + k + i) : 0.0f;
    }
  }
  s = make_float4(a[0] + b[0], a[1] + b[1], a[2] + b[2], a[3] + b[3]);
  d = make_float4(a[0] - b[0], a[1] - b[1], a[2] - b[2], a[3] - b[3]);
}
