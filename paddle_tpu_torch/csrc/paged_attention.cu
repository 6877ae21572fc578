// Paged decode attention for Hopper (sm_90a): one query token per slot over
// that slot's history, which lives scattered across fixed-size pool pages.
//
// Replaces: paddle_tpu/serving/kernels/paged_attention.py,
// paged_attention_kernel -> _pa_kernel (the pallas_call at line 167), in its
// float32/bfloat16 form: walk the block table page by page, fold GQA as
// [Hkv, rep, D], skip pages at or past the slot's length, keep an fp32
// online softmax, emit exact zeros for idle slots (length 0).
//
// What bounds it on this card: each K/V element it reads takes part in
// 2*rep multiply-adds, far below the card's operations-per-byte line, so it
// is bound by the bytes of K/V history it must read: sum over slots of
// len * Hkv * D * 2 elements, at 3.35 TB/s.
//
// What the design does about it:
//  * one CTA per (kv head, slot), handling that kv head's rep query heads,
//    so each K/V element is read from device memory exactly once;
//  * the CTA reads its page ids from the block table itself (in place of
//    the TPU's scalar prefetch) and loops over ceil(len / bs) pages only,
//    loading only the valid tokens of the last page;
//  * each page's K/V slice is staged in shared memory with coalesced loads
//    (a token's D elements are contiguous in the pool);
//  * the running max and denominator live in shared memory, the output
//    accumulator in registers, all fp32.
// This first version stages one page at a time; splitting long histories
// across CTAs (flash-decoding) and overlapping the next page's load are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ACC = 16;   // output elements per thread: rep * D <= 2048
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    int heads, int kv_heads, int block_size, int max_blocks,
                    float scale) {
  const int kvh = blockIdx.x, slot = blockIdx.y;
  const int rep = heads / kv_heads;
  const int len = seq_lens[slot];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_out = rep * D;
  T* ob = out + (int64_t(slot) * heads + kvh * rep) * D;
  if (len <= 0) {
    for (int e = tid; e < n_out; e += THREADS) store(ob + e, 0.f);
    return;
  }

  extern __shared__ float smem[];
  float* qs = smem;                      // [rep][D]
  float* ks = qs + n_out;                // [bs][D]
  float* vs = ks + block_size * D;       // [bs][D]
  float* ps = vs + block_size * D;       // [rep][bs] scores, then p
  float* m_s = ps + rep * block_size;    // [rep] running max
  float* l_s = m_s + rep;                // [rep] running denominator
  float* a_s = l_s + rep;                // [rep] this page's rescale

  const T* qb = q + (int64_t(slot) * heads + kvh * rep) * D;
  for (int e = tid; e < n_out; e += THREADS) qs[e] = to_f32(qb[e]);
  if (tid < rep) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[MAX_ACC];
#pragma unroll
  for (int i = 0; i < MAX_ACC; ++i) acc[i] = 0.f;

  const int* table = block_tables + int64_t(slot) * max_blocks;
  const int pages = (len + block_size - 1) / block_size;
  const int64_t tok_stride = int64_t(kv_heads) * D;
  for (int p = 0; p < pages; ++p) {
    const int nt = min(block_size, len - p * block_size);
    const int64_t base = (int64_t(table[p]) * block_size * kv_heads + kvh) * D;
    __syncthreads();   // the previous page's ks/vs/ps reads are done
    for (int e = tid; e < nt * D; e += THREADS) {
      const int t = e / D, d = e % D;
      ks[e] = to_f32(k_pool[base + t * tok_stride + d]);
      vs[e] = to_f32(v_pool[base + t * tok_stride + d]);
    }
    __syncthreads();
    for (int pr = warp; pr < rep * nt; pr += WARPS) {
      const int r = pr / nt, t = pr % nt;
      float part = 0.f;
#pragma unroll
      for (int d = lane; d < D; d += 32)
        part = fmaf(qs[r * D + d], ks[t * D + d], part);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) ps[r * block_size + t] = part * scale;
    }
    __syncthreads();
    if (tid < rep) {
      float* row = ps + tid * block_size;
      float mx = NEG_INF;
      for (int t = 0; t < nt; ++t) mx = fmaxf(mx, row[t]);
      const float m_new = fmaxf(m_s[tid], mx);
      float sum = 0.f;
      for (int t = 0; t < nt; ++t) {
        row[t] = expf(row[t] - m_new);
        sum += row[t];
      }
      const float alpha = expf(m_s[tid] - m_new);
      l_s[tid] = alpha * l_s[tid] + sum;
      m_s[tid] = m_new;
      a_s[tid] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < MAX_ACC; ++i) {
      const int e = tid + i * THREADS;
      if (e < n_out) {
        const int r = e / D, d = e % D;
        const float* prow = ps + r * block_size;
        float upd = 0.f;
        for (int t = 0; t < nt; ++t) upd = fmaf(prow[t], vs[t * D + d], upd);
        acc[i] = acc[i] * a_s[r] + upd;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < MAX_ACC; ++i) {
    const int e = tid + i * THREADS;
    if (e < n_out) store(ob + e, acc[i] / fmaxf(l_s[e / D], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* block_tables, const void* seq_lens, void* out,
                   int slots, int heads, int kv_heads, int block_size,
                   int max_blocks, float scale, cudaStream_t stream) {
  const int rep = heads / kv_heads;
  const size_t smem = size_t(rep * D + 2 * block_size * D +
                             rep * block_size + 3 * rep) * sizeof(float);
  auto kernel = paged_decode_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(kv_heads, slots);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_tables),
      static_cast<const int*>(seq_lens), static_cast<T*>(out), heads,
      kv_heads, block_size, max_blocks, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q [S, H, D]; k/v pools [NB, bs, Hkv, D]; block_tables [S, MB] int32;
// seq_lens [S] int32; out [S, H, D]; all contiguous. dtype: 0 = float32,
// 1 = bfloat16. Requires H % Hkv == 0 and (H / Hkv) * D <= 2048. Returns
// the launch's cudaError_t.
int pt_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                       const void* block_tables, const void* seq_lens,
                       void* out, int slots, int heads, int kv_heads,
                       int head_dim, int block_size, int max_blocks,
                       float scale, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((heads / kv_heads) * head_dim > MAX_ACC * THREADS)
    return cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k_pool, v_pool, block_tables, seq_lens, out,
                              slots, heads, kv_heads, block_size, max_blocks,
                              scale, s);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k_pool, v_pool, block_tables, seq_lens, out,
                             slots, heads, kv_heads, block_size, max_blocks,
                             scale, s);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k_pool, v_pool, block_tables,
                                      seq_lens, out, slots, heads, kv_heads,
                                      block_size, max_blocks, scale, s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k_pool, v_pool, block_tables,
                                     seq_lens, out, slots, heads, kv_heads,
                                     block_size, max_blocks, scale, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
