// Flash attention backward for Hopper (sm_90a), CUDA cores, fp32 accumulators.
//
// Replaces: paddle_tpu/kernels/flash_attention.py, _flash_bwd_bhnd ->
//   _dq_kernel  (the pallas_call at line 330): dq = scale * dS . K
//   _dkv_kernel (the pallas_call at line 366): dv = P^T . dO,
//                                              dk = scale * dS^T . Q
// with S = scale * Q K^T recomputed, P = exp(S - lse) from the forward's
// per-row log-sum-exp, dP = dO V^T and dS = P * (dP - delta), where
// delta = rowsum(dO * O) comes from the wrapper (one PyTorch reduction, as
// the reference computes it outside its kernels). Start-aligned causal mask
// (query i sees keys j <= i, for any kv length). The reference's bf16
// rounding points are kept: dS is rounded to the input dtype before dS.K
// and dS^T.Q, and P before P^T.dO. With segment ids (packed sequences; the
// reference masks at lines 221-223 and 274-276) a (query, key) pair also
// needs equal ids: P is 0 there, so dS is 0 too.
//
// What bounds them on this card: per causal (query, key) pair and head the
// dq kernel does 3 products of 2*D operations (S, dP, dS.K) and the dk/dv
// kernel 4 (S, dP, P^T.dO, dS^T.Q), against ~4*N*D elements read per head,
// far above the card's operations-per-byte line: both are bound by
// arithmetic. As in the forward, bf16 inputs are widened to fp32 in shared
// memory and multiplied on the fp32 CUDA cores (67 TFLOP/s), not on the
// bf16 tensor cores: a simple first design, right before fast.
//
// What the design does about it:
//  * dq: one CTA per (64-row query tile, batch*head), looping over the key
//    tiles up to the diagonal; the heaviest (last) query tiles go first. Q
//    and dO stay in shared memory (transposed); each key tile is read once
//    into K^T, K and V^T. dq is written once, after the loop: no atomics.
//  * dk/dv: one CTA per (64-key tile, batch*kv_head), looping over the
//    query heads of its GQA group and, for each, over the query tiles at
//    or below the diagonal; the heaviest (first) key tiles go first. K and
//    V are never repeated in memory, each dk/dv tile is written once, and
//    the sum over the group's heads is a loop in a fixed order, so the
//    kernel is deterministic.
//  * every product is a 4 x 4 register block per thread over transposed
//    tiles (two 16-byte shared loads per 16 FMAs); P and dS are written
//    over the Q^T / dO^T (dk/dv) or V^T (dq) buffers once those are read,
//    so the dk/dv kernel fits its six tiles in 200 KB at D = 128.
//  * registers: the dk/dv kernel holds two 4 x D/16 fp32 accumulators (64
//    values at D = 128) beside the 4 x 4 S and dP blocks, the likeliest
//    place for spills. __launch_bounds__(256, 1) lets it use up to 255
//    registers a thread; shared memory already limits it to one CTA (8
//    warps) per SM at D = 128, so the registers cost no occupancy. The
//    build keeps ptxas's report beside the library (chip_smoke.py prints
//    it). For sm_90a, with the segment ids, the eight instantiations use
//    151-189 registers (dk/dv) and 127-139 (dq), up from 145-167 and
//    125-128 before them, and 0 bytes of stack and spills.
//    So the accumulators fit, and what bounds both kernels is the fp32
//    FMA issue rate of one 8-warp CTA per SM, not memory or spills.
//  * inputs are read through their [B, N, H, D] strides and the ragged edge
//    (N or N_kv not a multiple of 64) is masked in-kernel.
//  * segment ids ([B, N] int32, nullptr = off): each thread keeps the ids
//    of the rows or keys fixed for its CTA (dq: its 4 query rows; dk/dv:
//    its 4 keys) in registers and reads the other side's 4 ids with each
//    tile. The ids belong to the batch row, so every query head of a GQA
//    group sees the same mask and the in-register sum over the group is
//    unchanged. A (query tile, key tile) pair whose id intervals
//    [min, max] do not meet has no equal pair and is skipped whole, for
//    any order of the ids; its P and dS would be exact zeros, so the
//    results are the bits of the unskipped kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;       // query rows or keys per tile
constexpr int THREADS = 256;   // 16 x 16: thread (ty, tx) owns rows ty*4..+3
constexpr int LDT = TILE + 4;  // row stride of transposed tiles
constexpr float NEG_INF = -1e30f;

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
  for (int r = r0 + (threadIdx.x & 31); r < min(r0 + TILE, limit);
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

// x rounded to T's precision (the reference's .astype(dtype) points)
template <typename T>
__device__ __forceinline__ float round_as(float x) { return x; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Rows r0..r0+63 of one head of a [.., rows, D] operand (`rs` elements
// between rows), transposed into t[D][LDT] and, where rm is given, also
// row-major into rm[TILE][D]. Rows at or past `limit` read as zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ base,
                                          int64_t rs, int r0, int limit,
                                          float* t, float* rm) {
  for (int e = threadIdx.x; e < TILE * D; e += THREADS) {
    const int r = e / D, d = e % D, row = r0 + r;
    const float x = row < limit ? to_f32(base[row * rs + d]) : 0.f;
    t[d * LDT + r] = x;
    if (rm != nullptr) rm[r * D + d] = x;
  }
}

// acc[i][j] += sum_d a[d][ra + i] * b[d][rb + j] over transposed tiles
template <int D>
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int ra, int rb, float (&acc)[4][4]) {
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    const float4 x = *reinterpret_cast<const float4*>(a + d * LDT + ra);
    const float4 y = *reinterpret_cast<const float4*>(b + d * LDT + rb);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], yv[j], acc[i][j]);
  }
}

// acc[i][g*4 + c] += sum_r p[r][ri + i] * m[r][g*64 + cx*4 + c], where p is
// [TILE][LDT] and m is [TILE][D] row-major
template <int D>
__device__ __forceinline__ void tile_acc(const float* p, const float* m,
                                         int ri, int cx,
                                         float (&acc)[4][D / 16]) {
#pragma unroll 4
  for (int r = 0; r < TILE; ++r) {
    const float4 p4 = *reinterpret_cast<const float4*>(p + r * LDT + ri);
    const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      const float4 m4 =
          *reinterpret_cast<const float4*>(m + r * D + g * 64 + cx * 4);
      const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[i][g * 4 + c] = fmaf(pv[i], mv[c], acc[i][g * 4 + c]);
    }
  }
}

struct Args {
  int n, n_kv, heads, kv_heads;
  int64_t sqb, sqn, sqh, skb, skn, skh, svb, svn, svh, sob, son, soh;
  float scale;
  int causal;
  const int32_t* segs;   // [B, N] segment ids (n == n_kv), or nullptr
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Args a) {
  constexpr int NC = D / 16;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][LDT]  Q^T
  float* ot = qt + D * LDT;                      // [D][LDT]  dO^T
  float* kt = ot + D * LDT;                      // [D][LDT]  K^T
  float* vt = kt + D * LDT;                      // [D][LDT]  V^T
  float* ks = vt + D * LDT;                      // [TILE][D] K
  float* dst = vt;                               // [TILE][LDT] dS^T

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;
  const int bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads;
  const int kvh = h / (a.heads / a.kv_heads);
  const T* kb = k + b * a.skb + kvh * a.skh;
  const T* vb = v + b * a.svb + kvh * a.svh;

  load_tile<T, D>(q + b * a.sqb + h * a.sqh, a.sqn, q0, a.n, qt, nullptr);
  load_tile<T, D>(dout + b * a.sob + h * a.soh, a.son, q0, a.n, ot, nullptr);
  const int32_t* sb =
      a.segs != nullptr ? a.segs + int64_t(b) * a.n : nullptr;
  float lse_r[4], delta_r[4];
  int seg_q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const int64_t at = int64_t(bh) * a.n + row;
    lse_r[i] = row < a.n ? lse[at] : 0.f;
    delta_r[i] = row < a.n ? delta[at] : 0.f;
    seg_q[i] = sb != nullptr && row < a.n ? sb[row] : 0;
  }
  const int2 q_ids = sb != nullptr ? id_range(sb, q0, a.n) : make_int2(0, 0);
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  const int kv_end = a.causal ? min(a.n_kv, q0 + TILE) : a.n_kv;
  for (int k0 = 0; k0 < kv_end; k0 += TILE) {
    if (sb != nullptr) {   // the whole block takes the same branch
      const int2 k_ids = id_range(sb, k0, a.n_kv);
      if (k_ids.y < q_ids.x || k_ids.x > q_ids.y) continue;   // no equal ids
    }
    __syncthreads();   // the last tile's reads of ks and dst are done
    load_tile<T, D>(kb, a.skn, k0, a.n_kv, kt, ks);
    load_tile<T, D>(vb, a.svn, k0, a.n_kv, vt, nullptr);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    tile_dot<D>(qt, kt, ty * 4, tx * 4, s);
    tile_dot<D>(ot, vt, ty * 4, tx * 4, dp);
    int seg_k[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx * 4 + j;
      seg_k[j] = sb != nullptr && col < a.n_kv ? sb[col] : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool ok = row < a.n && col < a.n_kv &&
                        (!a.causal || col <= row) && seg_q[i] == seg_k[j];
        const float p = ok ? expf(s[i][j] * a.scale - lse_r[i]) : 0.f;
        s[i][j] = round_as<T>(p * (dp[i][j] - delta_r[i]));   // dS
      }
    }

    __syncthreads();   // every thread is done reading vt: it becomes dst
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(dst + (tx * 4 + j) * LDT + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();
    tile_acc<D>(dst, ks, ty * 4, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.n) continue;
    T* out = dq + ((int64_t(b) * a.n + row) * a.heads + h) * D;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        store(out + g * 64 + tx * 4 + c, acc[i][g * 4 + c] * a.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Args a) {
  constexpr int NC = D / 16;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);   // [D][LDT]  K^T
  float* vt = kt + D * LDT;                      // [D][LDT]  V^T
  float* qt = vt + D * LDT;                      // [D][LDT]  Q^T
  float* ot = qt + D * LDT;                      // [D][LDT]  dO^T
  float* qs = ot + D * LDT;                      // [TILE][D] Q
  float* os = qs + TILE * D;                     // [TILE][D] dO
  float* pb = qt;                                // [TILE][LDT] P, query-major
  float* db = ot;                                // [TILE][LDT] dS, query-major

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * TILE;
  const int b = blockIdx.y / a.kv_heads, kvh = blockIdx.y % a.kv_heads;
  const int rep = a.heads / a.kv_heads;

  load_tile<T, D>(k + b * a.skb + kvh * a.skh, a.skn, k0, a.n_kv, kt,
                  nullptr);
  load_tile<T, D>(v + b * a.svb + kvh * a.svh, a.svn, k0, a.n_kv, vt,
                  nullptr);
  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[j][c] = acc_v[j][c] = 0.f;
  const int32_t* sb =
      a.segs != nullptr ? a.segs + int64_t(b) * a.n : nullptr;
  int seg_k[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = k0 + ty * 4 + j;
    seg_k[j] = sb != nullptr && col < a.n_kv ? sb[col] : 0;
  }
  const int2 k_ids = sb != nullptr ? id_range(sb, k0, a.n_kv) : make_int2(0, 0);

  // causal: query tiles that end before key k0 see none of this tile
  const int q_begin = a.causal ? (k0 / TILE) * TILE : 0;
  for (int hq = 0; hq < rep; ++hq) {
    const int h = kvh * rep + hq;
    const int64_t bh = int64_t(b) * a.heads + h;
    const T* qb = q + b * a.sqb + h * a.sqh;
    const T* ob = dout + b * a.sob + h * a.soh;
    for (int q0 = q_begin; q0 < a.n; q0 += TILE) {
      if (sb != nullptr) {   // the whole block takes the same branch
        const int2 q_ids = id_range(sb, q0, a.n);
        if (q_ids.y < k_ids.x || q_ids.x > k_ids.y) continue;   // no equal ids
      }
      __syncthreads();   // the last tile's reads of pb, db, qs, os are done
      load_tile<T, D>(qb, a.sqn, q0, a.n, qt, qs);
      load_tile<T, D>(ob, a.son, q0, a.n, ot, os);
      __syncthreads();

      // s[j][i], dp[j][i]: key k0 + ty*4 + j, query q0 + tx*4 + i
      float s[4][4], dp[4][4], pr[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] = dp[j][i] = 0.f;
      tile_dot<D>(kt, qt, ty * 4, tx * 4, s);
      tile_dot<D>(vt, ot, ty * 4, tx * 4, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + tx * 4 + i;
        const float lse_i = row < a.n ? lse[bh * a.n + row] : 0.f;
        const float delta_i = row < a.n ? delta[bh * a.n + row] : 0.f;
        const int seg_i = sb != nullptr && row < a.n ? sb[row] : 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = k0 + ty * 4 + j;
          const bool ok = row < a.n && col < a.n_kv &&
                          (!a.causal || col <= row) && seg_i == seg_k[j];
          const float p = ok ? expf(s[j][i] * a.scale - lse_i) : 0.f;
          pr[j][i] = round_as<T>(p);
          s[j][i] = round_as<T>(p * (dp[j][i] - delta_i));   // dS
        }
      }

      __syncthreads();   // done reading qt and ot: they become pb and db
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        *reinterpret_cast<float4*>(pb + (tx * 4 + i) * LDT + ty * 4) =
            make_float4(pr[0][i], pr[1][i], pr[2][i], pr[3][i]);
        *reinterpret_cast<float4*>(db + (tx * 4 + i) * LDT + ty * 4) =
            make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);
      }
      __syncthreads();
      tile_acc<D>(pb, os, ty * 4, tx, acc_v);
      tile_acc<D>(db, qs, ty * 4, tx, acc_k);
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + ty * 4 + j;
    if (key >= a.n_kv) continue;
    const int64_t at = ((int64_t(b) * a.n_kv + key) * a.kv_heads + kvh) * D;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = g * 64 + tx * 4 + c;
        store(dk + at + d, acc_k[j][g * 4 + c] * a.scale);
        store(dv + at + d, acc_v[j][g * 4 + c]);
      }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int batch, const Args& a,
                      cudaStream_t stream) {
  const size_t smem = size_t(4 * D * LDT + TILE * D) * sizeof(float);
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + TILE - 1) / TILE, batch * a.heads);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int batch, const Args& a,
                       cudaStream_t stream) {
  const size_t smem = size_t(4 * D * LDT + 2 * TILE * D) * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_kv + TILE - 1) / TILE, batch * a.kv_heads);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), a);
  return cudaGetLastError();
}

Args make_args(int n, int n_kv, int heads, int kv_heads, const long long* st,
               float scale, int causal, const void* segs) {
  return Args{n,     n_kv,  heads, kv_heads, st[0], st[1],  st[2],
              st[3], st[4], st[5], st[6],    st[7], st[8],  st[9],
              st[10], st[11], scale, causal,
              static_cast<const int32_t*>(segs)};
}

}  // namespace

extern "C" {

const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, dout [B, N, H, D] and k/v [B, N_kv, H_kv, D] with the given element
// strides for their first three axes (the last is contiguous); lse and
// delta [B*H, N] float32; dq [B, N, H, D] contiguous. dtype: 0 = float32,
// 1 = bfloat16. segs: [B, N] int32 segment ids (needs n == n_kv), or
// nullptr for none. Returns the launch's cudaError_t.
int pt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int batch, int n, int n_kv,
    int heads, int kv_heads, int head_dim, long long sqb, long long sqn,
    long long sqh, long long skb, long long skn, long long skh, long long svb,
    long long svn, long long svh, long long sob, long long son, long long soh,
    float scale, int causal, int dtype, const void* segs, void* stream) {
  const long long st[12] = {sqb, sqn, sqh, skb, skn, skh,
                            svb, svn, svh, sob, son, soh};
  if (segs != nullptr && n != n_kv) return cudaErrorInvalidValue;
  const Args a = make_args(n, n_kv, heads, kv_heads, st, scale, causal, segs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 128)
    return launch_dq<float, 128>(q, k, v, dout, lse, delta, dq, batch, a, s);
  if (dtype == 0 && head_dim == 64)
    return launch_dq<float, 64>(q, k, v, dout, lse, delta, dq, batch, a, s);
  if (dtype == 1 && head_dim == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dq,
                                         batch, a, s);
  if (dtype == 1 && head_dim == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dq,
                                        batch, a, s);
  return cudaErrorInvalidValue;
}

// Same inputs; dk, dv [B, N_kv, H_kv, D] contiguous, each summed over the
// query heads of its kv head's group.
int pt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch, int n,
    int n_kv, int heads, int kv_heads, int head_dim, long long sqb,
    long long sqn, long long sqh, long long skb, long long skn, long long skh,
    long long svb, long long svn, long long svh, long long sob, long long son,
    long long soh, float scale, int causal, int dtype, const void* segs,
    void* stream) {
  const long long st[12] = {sqb, sqn, sqh, skb, skn, skh,
                            svb, svn, svh, sob, son, soh};
  if (segs != nullptr && n != n_kv) return cudaErrorInvalidValue;
  const Args a = make_args(n, n_kv, heads, kv_heads, st, scale, causal, segs);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 128)
    return launch_dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, batch,
                                  a, s);
  if (dtype == 0 && head_dim == 64)
    return launch_dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, batch, a,
                                 s);
  if (dtype == 1 && head_dim == 128)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, delta, dk, dv,
                                          batch, a, s);
  if (dtype == 1 && head_dim == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, delta, dk, dv,
                                         batch, a, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
