// Block-level helpers of the port's stable radix sorts, shared by
// `sti_megakernel.cu` (its rank phase: one block a row) and `rank_sort.cu`
// (the rank stage's segmented sort of every row at once): a block's
// exclusive prefix sum, and cp.async staging of a run of 32-bit words
// into shared memory through the aligned 16-byte chunks that hold them.
// Each including file is its own library, so everything here is internal
// to it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace radix {

// Exclusive prefix sum of one value a thread, in thread order. Holds one
// barrier; `wsum` must not be written again before the next barrier.
__device__ __forceinline__ unsigned int block_exclusive_scan(
    unsigned int v, unsigned int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  unsigned int before = 0;
  for (int w = 0; w < warp; ++w) before += wsum[w];
  return before + x - v;
}

// the word offset of `p` within its 16-byte chunk
__device__ __forceinline__ int head_of(const void* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3u);
}

// Stage words [j0, j0 + m) of `src` into `buf` by a block of THREADS
// threads: the 16-byte chunks that hold them, so word j0 lands at
// buf[head_of(src + j0)]. A chunk that holds a word of an array lies
// inside that array's allocation (device allocations start 256-byte
// aligned and span whole 16-byte chunks), so reading up to 12 bytes past
// either end is safe; the words outside [j0, j0 + m) are never used.
template <int THREADS>
__device__ __forceinline__ void stage_words(uint32_t* buf, const void* src,
                                            size_t j0, int m) {
  const uint32_t* p = static_cast<const uint32_t*>(src) + j0;
  const char* a = reinterpret_cast<const char*>(p) - 4 * head_of(p);
  const int chunks = (head_of(p) + m + 3) >> 2;
  for (int c = threadIdx.x; c < chunks; c += THREADS)
    sm90::cp_async16(sm90::smem_u32(buf + 4 * c), a + 16 * c);
}

}  // namespace radix
