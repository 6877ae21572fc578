// Float32 tiles of the CUDA-core kernels in csrc/flash_attention.cu and
// csrc/flash_attention_bwd.cu: rows of a [.., D] operand copied into
// shared memory by cp.async in 16-byte chunks, or in 4-byte copies where
// the host finds an operand's rows not 16-byte aligned (rows_aligned).
// With SWZ a row's chunks are XOR-swizzled by row % 8, so a quarter warp
// reading 8 consecutive rows at one column, or 8 chunks of one row, hits
// 8 different bank groups. Header only: no entry points.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ptf32 {

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + rows) of a [.., D] operand with row stride ld into a
// [rows][D] tile, copied by the block's THREADS threads; rows at or past
// `limit` are zero-filled
template <int D, bool SWZ, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long ld, int r0, int rows,
                                          int limit, int vec) {
  constexpr int C = D / 4;
  for (int e = threadIdx.x; e < rows * C; e += THREADS) {
    const int r = e / C, c = e % C;
    const bool ok = r0 + r < limit;
    const float* g = ok ? src + (r0 + r) * ld + 4 * c : src;
    float* d = dst + r * D + ((SWZ ? c ^ (r & 7) : c) << 2);
    if (vec) {
      cp_async16(d, g, ok);
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) cp_async4(d + t, g + t, ok);
    }
  }
}

// entries [r0, r0 + count) of a vector of 4-byte values into dst; entries
// at or past `limit` are zero-filled
template <int THREADS>
__device__ __forceinline__ void load_vec(void* dst, const void* src, int r0,
                                         int count, int limit) {
  for (int t = threadIdx.x; t < count; t += THREADS) {
    const bool ok = r0 + t < limit;
    cp_async4(static_cast<char*>(dst) + 4 * t,
              static_cast<const char*>(src) + 4 * (ok ? r0 + t : 0), ok);
  }
}

// the query rows a CTA of the float32 flash forward and dq kernels, and
// the token rows of the fused CE's float32 dh kernel (batch_heads: its
// column tiles): 128 where a grid of 128-row tiles gives every SM a CTA,
// else 64, twice the CTAs for a short sequence (flash_timing.py's serving
// rows and fce_timing.py's fp32 and train32 rows time both sides)
inline cudaError_t query_tile_rows(long long batch_heads, int n, int* rows) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *rows = batch_heads * ((n + 127) / 128) >= sms ? 128 : 64;
  return cudaSuccess;
}

// whether float32 rows can be copied in 16-byte chunks: the address and
// every stride of an axis longer than 1, in multiples of 4 floats
inline bool rows_aligned(const void* p, int len0, long long s0, int len1,
                         long long s1, int len2, long long s2) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (len0 == 1 || s0 % 4 == 0) && (len1 == 1 || s1 % 4 == 0) &&
         (len2 == 1 || s2 % 4 == 0);
}

}  // namespace ptf32
