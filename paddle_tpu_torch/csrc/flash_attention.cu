// Flash attention forward for Hopper (sm_90a), CUDA cores, fp32 statistics.
//
// Replaces: paddle_tpu/kernels/flash_attention.py, _flash_fwd_bhnd ->
// _fa_kernel (the pallas_call at line 161): blocked online-softmax attention
// that never writes the [N, N] score matrix to device memory, start-aligned
// causal mask (query i sees keys j <= i), emitting O and the per-row
// log-sum-exp the backward needs. With segment ids (packed variable-length
// sequences, the reference's `segmented` mode, mask at lines 104-106), a
// query also needs the key's id to equal its own.
//
// What bounds it on this card: at the prefill shapes (N up to 2048, D 128)
// the work is ~4*N*N*D/2 operations per head against ~4*N*D elements moved,
// far above the card's operations-per-byte line, so it is bound by
// arithmetic. float32 inputs must not go through TF32 tensor cores (the
// reference computes at 'highest' precision), so the ceiling is the 67
// TFLOP/s of the fp32 CUDA cores.
//
// What the design does about it:
//  * one CTA per (64-row query tile, batch*head); the causal loop stops at
//    the diagonal, and the heaviest (last) query tiles are scheduled first;
//  * Q and K are stored transposed in shared memory, so each thread's 4x4
//    block of scores costs two 16-byte shared loads per 16 FMAs; P is
//    written transposed over K's buffer for the same reason in P.V;
//  * the running max, denominator and the 4 x D/16 output accumulator stay
//    in registers in fp32; a row's reductions are shuffles within the 16
//    lanes that share it;
//  * inputs are read through their [B, N, H, D] strides (no fold copy), and
//    the ragged edge (N or N_kv not a multiple of 64) is masked in-kernel;
//  * GQA: query head h reads kv head h / (H / H_kv), so K/V are never
//    repeated in memory.
//  * segment ids: one int32 per (batch row, position), shared by the heads;
//    each thread keeps its 4 query rows' ids in registers and reads its 4
//    key columns' ids with each key tile. The segmented kernel does the
//    same tiles as the causal one and only masks more: a key tile that a
//    row sees none of gives that row p = 1 on every masked column (the
//    finite -1e30 minus itself), which the first visible tile's rescale
//    alpha = exp(-1e30 - m) then erases, as in the reference. Every row
//    sees itself, so no row ends with l = 0. A key tile whose id interval
//    [min, max] does not meet the query tile's is skipped whole (for any
//    order of the ids: disjoint intervals mean no equal pair); skipping
//    it gives the same bits as masking it, since a masked tile adds
//    exact zeros after a visible one and is erased before one. Packed
//    sorted documents leave ~2/5 of the causal tile pairs at the
//    training shape; shuffled ids leave all of them.
// bf16 inputs are converted to fp32 on their way into shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // query rows per CTA
constexpr int BN = 64;         // keys per tile
constexpr int THREADS = 256;   // 16 x 16: thread (ty, tx) owns rows ty*4..+3
constexpr int LDT = BM + 4;    // row stride of transposed tiles: keeps float4
                               // alignment and spreads the transposing stores
constexpr float NEG_INF = -1e30f;
static_assert(BM == BN, "id_range spans one 64-row tile of either side");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// (min, max) of ids[r0 .. min(r0 + 64, limit)). Every warp computes it
// and gets the same answer, so the block agrees without a barrier.
__device__ __forceinline__ int2 id_range(const int32_t* __restrict__ ids,
                                         int r0, int limit) {
  int lo = 0x7fffffff, hi = -0x7fffffff - 1;
  for (int r = r0 + (threadIdx.x & 31); r < min(r0 + BN, limit); r += 32) {
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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int n, int n_kv, int heads,
                 int kv_heads, int64_t sqb, int64_t sqn, int64_t sqh,
                 int64_t skb, int64_t skn, int64_t skh, int64_t svb,
                 int64_t svn, int64_t svh, float scale, int causal,
                 const int32_t* __restrict__ segs) {
  constexpr int NC = D / 16;   // output columns per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][LDT]  Q transposed
  float* kt = qt + D * LDT;                      // [D][LDT]  K transposed
  float* vs = kt + D * LDT;                      // [BN][D]
  float* pt = kt;                                // [BN][LDT] P transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh % heads;
  const int kvh = h / (heads / kv_heads);
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + kvh * skh;
  const T* vb = v + b * svb + kvh * svh;
  // segment ids of this batch row ([B, N], q_len == kv_len), or nullptr
  const int32_t* sb = segs != nullptr ? segs + int64_t(b) * n : nullptr;
  int seg_q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    seg_q[i] = sb != nullptr && row < n ? sb[row] : 0;
  }
  const int2 q_ids = sb != nullptr ? id_range(sb, q0, n) : make_int2(0, 0);

  for (int e = tid; e < BM * D; e += THREADS) {
    const int r = e / D, d = e % D, row = q0 + r;
    qt[d * LDT + r] = row < n ? to_f32(qb[row * sqn + d]) : 0.f;
  }

  float acc[4][NC];
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(n_kv, q0 + BM) : n_kv;
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    if (sb != nullptr) {   // the whole block takes the same branch
      const int2 k_ids = id_range(sb, k0, n_kv);
      if (k_ids.y < q_ids.x || k_ids.x > q_ids.y) continue;   // no equal ids
    }
    __syncthreads();   // last tile's reads of pt/vs are done
    for (int e = tid; e < BN * D; e += THREADS) {
      const int r = e / D, d = e % D, col = k0 + r;
      const bool ok = col < n_kv;
      kt[d * LDT + r] = ok ? to_f32(kb[col * skn + d]) : 0.f;
      vs[r * D + d] = ok ? to_f32(vb[col * svn + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * LDT + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(kt + d * LDT + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    int seg_k[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx * 4 + j;
      seg_k[j] = sb != nullptr && col < n_kv ? sb[col] : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool ok = col < n_kv && (!causal || col <= row) &&
                        seg_q[i] == seg_k[j];
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = alpha * l_i[i] + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();   // every thread is done reading kt: it becomes pt
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * LDT + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c0 = 0; c0 < BN; ++c0) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + c0 * LDT + ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int g = 0; g < D / 64; ++g) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(vs + c0 * D + g * 64 + tx * 4);
        const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][g * 4 + c] = fmaf(pv[i], vv[c], acc[i][g * 4 + c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= n) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
    T* orow = o + ((int64_t(b) * n + row) * heads + h) * D;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        store(orow + g * 64 + tx * 4 + c, acc[i][g * 4 + c] / l);
    if (tx == 0) lse[int64_t(bh) * n + row] = m_i[i] + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int n, int n_kv, int heads,
                   int kv_heads, const long long* st, float scale,
                   int causal, const int32_t* segs, cudaStream_t stream) {
  const size_t smem = size_t(2 * D * LDT + BN * D) * sizeof(float);
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + BM - 1) / BM, batch * heads);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      n, n_kv, heads, kv_heads, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale, causal, segs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q [B, N, H, D], k/v [B, N_kv, H_kv, D] with the given element strides for
// the first three axes (the last is contiguous); o [B, N, H, D] contiguous;
// lse [B*H, N] float32. dtype: 0 = float32, 1 = bfloat16. segs: [B, N]
// int32 segment ids (needs n == n_kv), or nullptr for none. Returns the
// launch's cudaError_t.
int pt_flash_attention_fwd(const void* q, const void* k, const void* v,
                           void* o, void* lse, int batch, int n, int n_kv,
                           int heads, int kv_heads, int head_dim,
                           long long sqb, long long sqn, long long sqh,
                           long long skb, long long skn, long long skh,
                           long long svb, long long svn, long long svh,
                           float scale, int causal, int dtype,
                           const void* segs, void* stream) {
  const long long st[9] = {sqb, sqn, sqh, skb, skn, skh, svb, svn, svh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* sg = static_cast<const int32_t*>(segs);
  if (sg != nullptr && n != n_kv) return cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k, v, o, lse, batch, n, n_kv, heads,
                              kv_heads, st, scale, causal, sg, s);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, o, lse, batch, n, n_kv, heads,
                             kv_heads, st, scale, causal, sg, s);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, lse, batch, n, n_kv,
                                      heads, kv_heads, st, scale, causal, sg,
                                      s);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, lse, batch, n, n_kv, heads,
                                     kv_heads, st, scale, causal, sg, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
