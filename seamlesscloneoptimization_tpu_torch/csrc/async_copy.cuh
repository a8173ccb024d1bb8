// async_copy.cuh: asynchronous copies from device memory into shared memory
// (cp.async, sm_80 and later), shared by the level kernels (mg_level.cuh's
// UpTile, mg_level_q.cuh). A copy with ok == false reads nothing and fills
// its destination with zeros, which stages the Dirichlet frame around a
// tile that reaches past its array.

#pragma once

namespace acp {

// 16 bytes: dst and src 16-byte aligned.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes: one float.
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

// Close the copies this thread issued since the last commit into a group.
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's groups are still in flight
// (then a barrier makes every thread's copies visible).
template <int pending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

}  // namespace acp
