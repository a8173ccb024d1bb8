// prep_mask: a request's mask prep on the card. Any nonzero byte of the
// (H, W) u8 mask is inside; the 1-px border is zeroed; the mask is written
// as {0, 255}; and the bbox (x0, y0, bw, bh) of what is inside is written
// as four int32, all 0 for an empty mask. Equal to native.prep_mask.
//
// No TPU counterpart: the JAX package preps the mask on the host
// (native.prep_mask; the reference's setMaskBoundaryToConstant and
// calBoundingBox, seamlessClone_imp.cpp:927-1012). The serve engine did
// too, with the card idle through it; the ROI's shapes need only the
// four ints on the host.
//
// Bound on this card: bytes. One u8 read and one u8 write a pixel
// (7.45 MB at the 1552x2400 headline mask, 0.0022 ms at 3.35 TB/s; 21.3 MB
// at the 2802x3802 8K patch, 0.0064 ms).
//
// Design: the mask as one run of H * W bytes cut into aligned 16-byte
// chunks; a block of kThreads threads owns kPer * kThreads consecutive
// chunks, thread t chunks t, t + kThreads, .. (each load of a warp one
// 512-byte run), all kPer loads issued before any is used.
//  - A chunk's 16 bytes packed to 16 bits, bit j = (byte j != 0). The
//    chunk starts at row r0 = off / W, column c0; it walks the row
//    segments it holds (at most two for W >= 16): of a segment of an
//    interior row, the bits of the interior columns [1, W - 2] are kept,
//    and the first and last kept bit give the segment's columns.
//  - The kept bits spread back to bytes of 0xff: one 16-byte store. A
//    chunk is read and written by one thread only, so the output may be
//    the input (in place).
//  - The bbox: per thread the largest of H - y, y, W - x and x over the
//    kept pixels (0 when none, so 0 is every quantity's identity and each
//    one a max), reduced over the block (warp reduces, then shared), then
//    one integer atomicMax per quantity per block into a zeroed scratch.
//    Integer max does not depend on order: the result is the same bits on
//    every run. The last block to finish (a ticket counter after a
//    fence) turns the four maxima into the bbox.
//  - The chunk past the run's end (H * W % 16 != 0) is read and written a
//    byte at a time.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream
// (a memset of the scratch, then the kernel) and returns the launch's
// cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads a block
constexpr int kPer = 4;        // chunks a thread
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// The 16 bytes of a chunk as 16 bits, bit j = (byte j != 0) (erode3.cu's
// pack16: a byte's 0x80 = (b != 0), then a word's four 0x80 bits gathered
// by a multiply whose partial products land on distinct bits).
__device__ __forceinline__ uint32_t pack16(uint4 c) {
  const uint32_t x[4] = {c.x, c.y, c.z, c.w};
  uint32_t n[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t m = (((x[i] & 0x7f7f7f7fu) + 0x7f7f7f7fu) | x[i]) & 0x80808080u;
    n[i] = (m * 0x00204081u) >> 28;
  }
  return (n[0] | (n[1] << 4)) | ((n[2] | (n[3] << 4)) << 8);
}

// Bits at .. at + 3 -> 4 bytes of {0, 0xff}, bit j to byte j.
__device__ __forceinline__ uint32_t spread4(uint32_t bits, int at) {
  return ((((bits >> at) & 0xfu) * 0x00204081u) & 0x01010101u) * 0xffu;
}

// The quantities a thread or block keeps: H - y, y, W - x, x at their max.
struct Box {
  int a[4];
};

__device__ __forceinline__ void reduce_block(Box& b, int (*shared)[4]) {
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 4; ++q) b.a[q] = __reduce_max_sync(kFull, b.a[q]);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) shared[wi][q] = b.a[q];
  }
  __syncthreads();
  if (wi == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      b.a[q] = __reduce_max_sync(kFull, lane < kWarps ? shared[lane][q] : 0);
    }
  }
}

// Keeps the interior pixels of one chunk (16 bytes from byte off of the
// run, packed to bits) and adds them to b. Returns the kept bits.
__device__ __forceinline__ uint32_t keep_chunk(uint32_t bits, uint32_t off, int h, int w,
                                               Box& b) {
  uint32_t keep = 0;
  int r = static_cast<int>(off / static_cast<uint32_t>(w));
  int c = static_cast<int>(off - static_cast<uint32_t>(r) * static_cast<uint32_t>(w));
  for (int j = 0; j < 16; ++r, c = 0) {
    const int n = min(16 - j, w - c);  // bytes of row r from byte j
    if (r >= 1 && r <= h - 2) {
      // interior columns [1, w - 2]: bytes [lo, hi) of the chunk
      const int lo = j + max(0, 1 - c), hi = j + min(n, w - 1 - c);
      if (lo < hi) {
        const uint32_t hit = bits & ((1u << hi) - 1u) & ~((1u << lo) - 1u);
        if (hit) {
          keep |= hit;
          const int x0 = c - j + __ffs(hit) - 1, x1 = c - j + 31 - __clz(hit);
          b.a[0] = max(b.a[0], h - r);
          b.a[1] = max(b.a[1], r);
          b.a[2] = max(b.a[2], w - x0);
          b.a[3] = max(b.a[3], x1);
        }
      }
    }
    j += n;
  }
  return keep;
}

__global__ void __launch_bounds__(kThreads)
prep_mask_kernel(const uint8_t* in, uint8_t* out, int* acc, int* bbox, int h, int w,
                 uint32_t total) {
  __shared__ int shared[kWarps][4];
  __shared__ bool last;
  const uint32_t nfull = total / 16;  // whole chunks
  const uint32_t base = blockIdx.x * (kPer * kThreads) + threadIdx.x;
  Box b = {{0, 0, 0, 0}};
  uint4 v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const uint32_t k = base + i * kThreads;
    v[i] = k < nfull ? reinterpret_cast<const uint4*>(in)[k] : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const uint32_t k = base + i * kThreads;
    if (k < nfull) {
      const uint32_t keep = keep_chunk(pack16(v[i]), 16 * k, h, w, b);
      reinterpret_cast<uint4*>(out)[k] =
          make_uint4(spread4(keep, 0), spread4(keep, 4), spread4(keep, 8), spread4(keep, 12));
    } else if (k == nfull && 16 * k < total) {  // the run's last, partial chunk
      const int nb = static_cast<int>(total - 16 * k);
      uint32_t bits = 0;
      for (int j = 0; j < nb; ++j) bits |= static_cast<uint32_t>(in[16 * k + j] != 0) << j;
      const uint32_t keep = keep_chunk(bits, 16 * k, h, w, b);
      for (int j = 0; j < nb; ++j) out[16 * k + j] = ((keep >> j) & 1u) ? 0xff : 0;
    }
  }
  reduce_block(b, shared);
  if (threadIdx.x == 0) {
    if (b.a[1] > 0) {  // the block kept a pixel (every kept row is >= 1)
#pragma unroll
      for (int q = 0; q < 4; ++q) atomicMax(acc + q, b.a[q]);
    }
    __threadfence();
    last = atomicAdd(reinterpret_cast<unsigned*>(acc + 4), 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    int m[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) m[q] = atomicOr(acc + q, 0);  // L2's value
    if (m[1] == 0) {
      bbox[0] = bbox[1] = bbox[2] = bbox[3] = 0;
    } else {
      const int y0 = h - m[0], x0 = w - m[2];
      bbox[0] = x0;
      bbox[1] = y0;
      bbox[2] = m[3] - x0 + 1;
      bbox[3] = m[1] - y0 + 1;
    }
  }
}

}  // namespace

// mask and out: (h, w) u8, contiguous, 16-byte aligned (out may be mask);
// buf: 9 int32, bbox in [0, 4), the kernel's scratch in [4, 9).
extern "C" int prep_mask_launch(const void* mask, void* out, void* buf, int h, int w,
                                void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  int* bbox = static_cast<int*>(buf);
  if ((reinterpret_cast<uintptr_t>(mask) | reinterpret_cast<uintptr_t>(out)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const long long total = static_cast<long long>(h) * w;
  if (h < 0 || w < 0 || total >= (1ll << 31) - 16) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaMemsetAsync(bbox + (total == 0 ? 0 : 4), 0,
                                   (total == 0 ? 9 : 5) * sizeof(int), s);
  if (rc != cudaSuccess || total == 0) return static_cast<int>(rc);
  const long long chunks = (total + 15) / 16;
  const int blocks = static_cast<int>((chunks + kPer * kThreads - 1) / (kPer * kThreads));
  prep_mask_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const uint8_t*>(mask),
                                               static_cast<uint8_t*>(out), bbox + 4, bbox, h, w,
                                               static_cast<uint32_t>(total));
  return static_cast<int>(cudaGetLastError());
}
