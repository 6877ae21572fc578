// Segment ids in the flash kernels (csrc/flash_attention.cu,
// csrc/flash_attention_bwd.cu): the id interval of a run of rows, whether
// two intervals meet, and the float32 kernels' tile sequence over them. A
// (query tile, key tile) pair whose intervals do not meet has no equal
// pair for any order of the ids, so the kernels skip it whole. Header
// only: no entry points.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ptseg {

// (min, max) of ids[r0 .. min(r0 + count, limit)), or (INT_MAX, INT_MIN)
// for none. Every warp computes it and gets the same answer, so the block
// agrees without a barrier.
__device__ __forceinline__ int2 id_range(const int32_t* __restrict__ ids,
                                         int r0, int limit, int count = 64) {
  int lo = 0x7fffffff, hi = -0x7fffffff - 1;
  for (int r = r0 + (threadIdx.x & 31); r < min(r0 + count, limit);
       r += 32) {
    lo = min(lo, ids[r]);
    hi = max(hi, ids[r]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  return make_int2(lo, hi);
}

__device__ __forceinline__ bool ranges_meet(int2 x, int2 y) {
  return !(x.y < y.x || x.x > y.y);
}

// A float32 flash CTA's tile sequence: the first tile of BN rows at or
// after r0 and before end whose ids can meet the CTA's (ids), or end if
// none; without ids (sb == nullptr) r0 itself.
template <int BN>
__device__ __forceinline__ int next_tile(int r0, int end,
                                         const int32_t* __restrict__ sb,
                                         int limit, int2 ids) {
  if (sb != nullptr)
    while (r0 < end && !ranges_meet(id_range(sb, r0, limit, BN), ids))
      r0 += BN;
  return r0;
}

}  // namespace ptseg
