// Paged attention for Hopper (sm_90a): queries over a history that lives
// scattered across fixed-size pool pages [NB, bs, Hkv, D], in float32,
// bfloat16 or int8 (with fp32 scale planes [NB, bs, Hkv]).
//
// Two kernels share the page walk (the CTA reads its own block-table row,
// in place of the TPU's scalar prefetch) and the page staging
// (`stage_page`: one kv head's tokens of one page into shared memory as
// fp32, int8 pages multiplied by their per-vector scale on the way in,
// exactly as dequantize_int8_block does: q * scale in fp32, one rounding).
//
// 1. paged_decode_kernel replaces paddle_tpu/serving/kernels/
//    paged_attention.py, paged_attention_kernel -> _pa_kernel (the
//    pallas_call at line 167), in all its modes (fp32/bf16 pools, and
//    int8 pools + scales, its `quantized` branch): one query token per
//    slot, GQA folded as [Hkv, rep, D], pages at or past the slot's length
//    skipped, fp32 online softmax, exact zeros for idle slots (length 0).
//    Bound by the bytes of K/V history it reads (each element takes part
//    in 2*rep multiply-adds). One CTA per (kv head, slot), so each K/V
//    element is read once; one page staged at a time; the running max and
//    denominator in shared memory, the rep*D output accumulators in
//    registers.
//
// 2. mixed_paged_kernel replaces paged_attention.py,
//    mixed_paged_attention_kernel -> _mixed_kernel (the pallas_call at
//    line 345), in the same three modes: ragged [S, C] query rows, row s
//    holding q_lens[s] new tokens at positions hist..hist+q_len-1, causal
//    rule key position <= hist + ci. It carries chunked prefill (C = the
//    chunk, decode rows q_len 1) and the prefix-cache suffix prefill
//    (S = 1, C = the bucket, up to 2048). The TPU kernel keeps all H*C rows
//    of a slot in VMEM over one sequential grid; here the slot's rep*C rows
//    of one kv head are flattened chunk-index-major (row j = ci*rep + r)
//    and cut into tiles of ROWS rows, one CTA per (tile, kv head, slot):
//    the suffix prefill's 1024 rows x 16 heads give 512 CTAs for 132 SMs
//    and the accumulators fit in registers. A CTA walks pages only up to
//    its own tile's causal horizon (hist + last ci in the tile + 1), and
//    valid rows (ci < q_len) are a prefix of the tile, so a decode row
//    costs one row of work. Rows past q_len and idle rows emit exact zeros.
//    What bounds it: operations, 4*H*D per visible (query, key) pair, at
//    the fp32 CUDA-core rate for the long suffix prefill; the bytes of the
//    history for the decode-heavy mixed step. The design against that:
//    register-blocked products from shared memory with 16-byte loads
//    (4 rows x 1 key per thread for Q.K^T, 8 rows x 4 dims for P.V).
//    Tensor cores (wgmma), split histories and overlapped page loads are
//    later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ACC = 16;   // kernel 1: output elements per thread, rep*D <= 2048
constexpr int ROWS = 32;      // kernel 2: query rows per CTA
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Stage tokens [0, nt) of kv head `kvh` of pool page `page` into ks/vs as
// fp32 rows of stride `ld`; int8 pages are dequantized with their scales.
template <typename TKV, int D>
__device__ __forceinline__ void stage_page(
    const TKV* __restrict__ k_pool, const TKV* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    int page, int nt, int block_size, int kv_heads, int kvh, float* ks,
    float* vs, int ld) {
  const int64_t tok0 = int64_t(page) * block_size;
  for (int e = threadIdx.x; e < nt * D; e += THREADS) {
    const int t = e / D, d = e % D;
    const int64_t vec = (tok0 + t) * kv_heads + kvh;   // (page, t, kvh)
    float kx = to_f32(k_pool[vec * D + d]);
    float vx = to_f32(v_pool[vec * D + d]);
    if constexpr (std::is_same<TKV, int8_t>::value) {
      kx *= k_scale[vec];
      vx *= v_scale[vec];
    }
    ks[t * ld + d] = kx;
    vs[t * ld + d] = vx;
  }
}

// -- kernel 1: one query token per slot ---------------------------------

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                    const TKV* __restrict__ v_pool,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens, TQ* __restrict__ out,
                    int heads, int kv_heads, int block_size, int max_blocks,
                    float scale) {
  const int kvh = blockIdx.x, slot = blockIdx.y;
  const int rep = heads / kv_heads;
  const int len = seq_lens[slot];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_out = rep * D;
  TQ* ob = out + (int64_t(slot) * heads + kvh * rep) * D;
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

  const TQ* qb = q + (int64_t(slot) * heads + kvh * rep) * D;
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
  for (int p = 0; p < pages; ++p) {
    const int nt = min(block_size, len - p * block_size);
    __syncthreads();   // the previous page's ks/vs/ps reads are done
    stage_page<TKV, D>(k_pool, v_pool, k_scale, v_scale, table[p], nt,
                       block_size, kv_heads, kvh, ks, vs, D);
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

// -- kernel 2: ragged [S, C] query rows ----------------------------------

__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, c))));
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(THREADS)
mixed_paged_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k_pool,
                   const TKV* __restrict__ v_pool,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int* __restrict__ block_tables,
                   const int* __restrict__ hist_lens,
                   const int* __restrict__ q_lens, TQ* __restrict__ out,
                   int chunk, int heads, int kv_heads, int block_size,
                   int max_blocks, float scale) {
  constexpr int LD = D + 4;           // fp32 row stride: 16-byte aligned,
  constexpr int LD4 = LD / 4;         // no bank conflicts across 8 rows
  constexpr int COLS4 = D / 4;        // P.V: float4 columns per row
  constexpr int VGROUPS = THREADS / COLS4;
  constexpr int VROWS = ROWS / VGROUPS;   // P.V rows per thread
  const int tile = blockIdx.x, kvh = blockIdx.y, slot = blockIdx.z;
  const int rep = heads / kv_heads;
  const int hist = hist_lens[slot], q_len = q_lens[slot];
  const int tid = threadIdx.x;
  const int j0 = tile * ROWS;                       // row j = ci * rep + r
  const int n_rows = min(ROWS, rep * chunk - j0);
  const int n_valid = max(0, min(n_rows, q_len * rep - j0));

  // row j of this tile -> its [S, C, H, D] offset
  auto row_off = [&](int r) {
    const int j = j0 + r, ci = j / rep;
    return ((int64_t(slot) * chunk + ci) * heads + kvh * rep + j % rep) * D;
  };
  for (int e = n_valid * D + tid; e < n_rows * D; e += THREADS)
    store(out + row_off(e / D) + e % D, 0.f);
  if (n_valid == 0) return;

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [ROWS][LD]
  float* ks = qs + ROWS * LD;                    // [bs][LD]
  float* vs = ks + block_size * LD;              // [bs][LD]
  float* ps = vs + block_size * LD;              // [ROWS][bs]
  float* m_s = ps + ROWS * block_size;           // [ROWS]
  float* l_s = m_s + ROWS;
  float* a_s = l_s + ROWS;
  const float4* qs4 = reinterpret_cast<const float4*>(qs);
  const float4* ks4 = reinterpret_cast<const float4*>(ks);
  const float4* vs4 = reinterpret_cast<const float4*>(vs);

  for (int e = tid; e < n_valid * D; e += THREADS)
    qs[(e / D) * LD + e % D] = to_f32(q[row_off(e / D) + e % D]);
  if (tid < ROWS) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  // P.V accumulators: rows vg + VGROUPS*i, dims 4*c4 .. 4*c4+3
  const int c4 = tid % COLS4, vg = tid / COLS4;
  float4 acc[VROWS];
#pragma unroll
  for (int i = 0; i < VROWS; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // the tile's causal horizon: keys 0 .. hist + (last valid ci)
  const int n_keys = hist + (j0 + n_valid - 1) / rep + 1;
  const int pages = min((n_keys + block_size - 1) / block_size, max_blocks);
  const int* table = block_tables + int64_t(slot) * max_blocks;
  // Q.K^T: 16 key lanes x 8 row groups, rows rg + 8*i
  const int kl = tid & 15, rg = tid >> 4;
  const int n_ri = min(4, max(0, (n_valid - rg + 7) / 8));
  for (int p = 0; p < pages; ++p) {
    const int nt = min(block_size, n_keys - p * block_size);
    __syncthreads();   // the previous page's ks/vs/ps reads are done
    stage_page<TKV, D>(k_pool, v_pool, k_scale, v_scale, table[p], nt,
                       block_size, kv_heads, kvh, ks, vs, LD);
    __syncthreads();
    for (int t = kl; t < nt; t += 16) {
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int d4 = 0; d4 < COLS4; ++d4) {
        const float4 kx = ks4[t * LD4 + d4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (i < n_ri) sc[i] = dot4(qs4[(rg + 8 * i) * LD4 + d4], kx, sc[i]);
      }
      const int kpos = p * block_size + t;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < n_ri) {
          const int r = rg + 8 * i;
          const bool seen = kpos <= hist + (j0 + r) / rep;
          ps[r * block_size + t] = seen ? sc[i] * scale : NEG_INF;
        }
      }
    }
    __syncthreads();
    if (tid < n_valid) {
      float* row = ps + tid * block_size;
      float mx = NEG_INF;
      for (int t = 0; t < nt; ++t) mx = fmaxf(mx, row[t]);
      // every valid row sees key 0 on page 0, so m_new is finite from
      // there on and a masked score's exp is exactly 0
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
    for (int i = 0; i < VROWS; ++i) {
      const int r = vg + VGROUPS * i;
      if (r < n_valid) {
        const float* prow = ps + r * block_size;
        const float a = a_s[r];
        float4 u = make_float4(acc[i].x * a, acc[i].y * a, acc[i].z * a,
                               acc[i].w * a);
        for (int t = 0; t < nt; ++t) {
          const float pt = prow[t];
          const float4 vx = vs4[t * LD4 + c4];
          u.x = fmaf(pt, vx.x, u.x);
          u.y = fmaf(pt, vx.y, u.y);
          u.z = fmaf(pt, vx.z, u.z);
          u.w = fmaf(pt, vx.w, u.w);
        }
        acc[i] = u;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < VROWS; ++i) {
    const int r = vg + VGROUPS * i;
    if (r < n_valid) {
      const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
      TQ* o = out + row_off(r) + 4 * c4;
      store(o + 0, acc[i].x * inv);
      store(o + 1, acc[i].y * inv);
      store(o + 2, acc[i].z * inv);
      store(o + 3, acc[i].w * inv);
    }
  }
}

// -- launchers -------------------------------------------------------------

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  return cudaSuccess;
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_decode(const void* q, const void* k_pool,
                          const void* v_pool, const void* k_scale,
                          const void* v_scale, const void* block_tables,
                          const void* seq_lens, void* out, int slots,
                          int heads, int kv_heads, int block_size,
                          int max_blocks, float scale, cudaStream_t stream) {
  const int rep = heads / kv_heads;
  const size_t smem = size_t(rep * D + 2 * block_size * D +
                             rep * block_size + 3 * rep) * sizeof(float);
  auto kernel = paged_decode_kernel<TQ, TKV, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(kv_heads, slots), THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(seq_lens), static_cast<TQ*>(out), heads,
      kv_heads, block_size, max_blocks, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_mixed(const void* q, const void* k_pool,
                         const void* v_pool, const void* k_scale,
                         const void* v_scale, const void* block_tables,
                         const void* hist_lens, const void* q_lens, void* out,
                         int slots, int chunk, int heads, int kv_heads,
                         int block_size, int max_blocks, float scale,
                         cudaStream_t stream) {
  const size_t smem = (size_t(ROWS + 2 * block_size) * (D + 4) +
                       size_t(ROWS) * block_size + 3 * ROWS) * sizeof(float);
  auto kernel = mixed_paged_kernel<TQ, TKV, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const int rows = heads / kv_heads * chunk;
  const dim3 grid((rows + ROWS - 1) / ROWS, kv_heads, slots);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k_pool),
      static_cast<const TKV*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(hist_lens), static_cast<const int*>(q_lens),
      static_cast<TQ*>(out), chunk, heads, kv_heads, block_size, max_blocks,
      scale);
  return cudaGetLastError();
}

// Calls f(TQ{}, TKV{}, std::integral_constant<int, D>{}) for the element
// types named by the codes (0 float32, 1 bfloat16; pools also 2 int8) and
// head_dim; invalid combinations return cudaErrorInvalidValue.
template <typename F>
cudaError_t dispatch(int dtype, int kv_dtype, int head_dim, F&& f) {
  using D64 = std::integral_constant<int, 64>;
  using D128 = std::integral_constant<int, 128>;
  if (head_dim != 64 && head_dim != 128) return cudaErrorInvalidValue;
  const bool wide = head_dim == 128;
  if (dtype == 0 && kv_dtype == 0)
    return wide ? f(float{}, float{}, D128{}) : f(float{}, float{}, D64{});
  if (dtype == 1 && kv_dtype == 1)
    return wide ? f(__nv_bfloat16{}, __nv_bfloat16{}, D128{})
                : f(__nv_bfloat16{}, __nv_bfloat16{}, D64{});
  if (dtype == 0 && kv_dtype == 2)
    return wide ? f(float{}, int8_t{}, D128{}) : f(float{}, int8_t{}, D64{});
  if (dtype == 1 && kv_dtype == 2)
    return wide ? f(__nv_bfloat16{}, int8_t{}, D128{})
                : f(__nv_bfloat16{}, int8_t{}, D64{});
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q [S, H, D]; k/v pools [NB, bs, Hkv, D]; k/v scales [NB, bs, Hkv] fp32
// (int8 pools only, else ignored); block_tables [S, MB] int32; seq_lens [S]
// int32; out [S, H, D]; all contiguous. dtype (q, out): 0 = float32,
// 1 = bfloat16; kv_dtype: the same code, or 2 = int8. Requires
// H % Hkv == 0 and (H / Hkv) * D <= 2048. Returns the launch's cudaError_t.
int pt_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                       const void* k_scale, const void* v_scale,
                       const void* block_tables, const void* seq_lens,
                       void* out, int slots, int heads, int kv_heads,
                       int head_dim, int block_size, int max_blocks,
                       float scale, int dtype, int kv_dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((heads / kv_heads) * head_dim > MAX_ACC * THREADS)
    return cudaErrorInvalidValue;
  return dispatch(dtype, kv_dtype, head_dim, [&](auto tq, auto tkv, auto d) {
    return launch_decode<decltype(tq), decltype(tkv), decltype(d)::value>(
        q, k_pool, v_pool, k_scale, v_scale, block_tables, seq_lens, out,
        slots, heads, kv_heads, block_size, max_blocks, scale, s);
  });
}

// q [S, C, H, D]; pools, scales and block_tables as above; hist_lens and
// q_lens [S] int32; out [S, C, H, D]. Row (s, ci) with ci < q_lens[s] sees
// keys 0 .. hist_lens[s] + ci; other rows are written as zeros. Requires
// H % Hkv == 0 and hist + q_len <= MB * bs for every slot.
int pt_mixed_paged_attention(const void* q, const void* k_pool,
                             const void* v_pool, const void* k_scale,
                             const void* v_scale, const void* block_tables,
                             const void* hist_lens, const void* q_lens,
                             void* out, int slots, int chunk, int heads,
                             int kv_heads, int head_dim, int block_size,
                             int max_blocks, float scale, int dtype,
                             int kv_dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, kv_dtype, head_dim, [&](auto tq, auto tkv, auto d) {
    return launch_mixed<decltype(tq), decltype(tkv), decltype(d)::value>(
        q, k_pool, v_pool, k_scale, v_scale, block_tables, hist_lens, q_lens,
        out, slots, chunk, heads, kv_heads, block_size, max_blocks, scale, s);
  });
}

}  // extern "C"
