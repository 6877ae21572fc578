// Flash attention backward for Hopper (sm_90a): bf16 on the tensor cores
// through wgmma with TMA loads; float32 on the CUDA cores.
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
// arithmetic, on the bf16 tensor cores (989 TFLOP/s) for bf16 and on the
// fp32 CUDA cores (67 TFLOP/s) for float32, which stays off TF32 to match
// the reference's 'highest' matmuls.
//
// bf16 (namespace tc; building blocks in wgmma_bf16.cuh):
//  * warp-specialized CTAs of three warpgroups: two consumers of 64 rows
//    each (the wgmma M) and a producer whose first warp issues TMA loads
//    into a ring of STAGES tiles guarded by mbarriers (full: the producer
//    warp's 32 arrivals plus the tiles' bytes; empty: one arrival per
//    consumer warp). setmaxnreg moves registers from the producer (24) to
//    the consumers (240).
//  * dq: one CTA per (128 query rows, batch*head), heaviest (last) first.
//    Q and dO rows load once; key tiles (K, V and their segment ids) of
//    64 stream up to the causal edge. Per tile S = Q.K^T and dP = dO.V^T
//    are ss products (both operands K-major, D contracted); P and dS are
//    computed on the accumulator fragments, dS packed to bf16 into A
//    fragments and dq += dS.K runs as an rs product with K read MN-major
//    (the transpose bit). dq is written once, after the loop.
//  * dk/dv: one CTA per (128 keys, batch*kv_head), first key tiles first.
//    K and V load once; for each query head of the GQA group, query tiles
//    (Q, dO, and the producer's copies of their lse, delta and ids) of 64
//    stream from the causal edge on. S^T = K.Q^T and dP^T = V.dO^T are ss
//    products (M = keys); P^T and dS^T become A fragments of dv += P^T.dO
//    and dk += dS^T.Q, rs products with dO and Q read MN-major. The group's
//    sum is the loop, in a fixed order: each dk/dv row is written once, no
//    atomics, deterministic.
//  * P and dS never leave registers. An accumulator element's (row,
//    column) follows from the wgmma layout; the causal, ragged and segment
//    masks set P to 0 there, as the float32 kernels do.
//  * TMA reads through rank-4 tensor maps (D, H, N, B) over the caller's
//    strides: rows past N come in as zeros and never reach the next batch
//    row. TMA needs the address and strides in multiples of 16 bytes; the
//    wrapper copies an operand that breaks that (and counts the copy).
//  * segment ids: the producer and the consumers walk the same tile
//    sequence. Both skip a tile whose id interval [min, max] meets none
//    of the CTA's rows (id_range, computed by each warp); a consumer
//    warpgroup that the tile cannot reach (other ids, past its causal edge
//    or past N) still takes it and hands it back without computing, so no
//    side waits for a tile the other skipped. A skipped pair has no equal
//    ids and no visible pair, its P and dS would be exact zeros: the
//    results are the bits of the unskipped kernel.
//  * registers: 384 threads at 168 registers allow one split, the
//    producer warpgroup at 24 and the consumers at 240. The dk/dv
//    consumer holds dk and dv (2 x D/2 fp32) beside S^T and dP^T (2 x
//    32) and the two fragment sets (2 x 16), ~230 at D = 128. ptxas
//    (CUDA 12.9, sm_90a) reports 0 spill bytes for dq and 56 / 112 bytes
//    of spill stores for dk/dv at D = 64 / 128, the D = 64 ones all in
//    the producer warp's lse/delta staging; they cost no measurable
//    time. chip_smoke.py phase 2 prints the report.
//  Where trouble was likely, and what the design does:
//   1. the TMA swizzle and the wgmma descriptor must agree (128-byte
//      swizzle, 1024-aligned boxes, K-major and MN-major): the MMA probe
//      checks each form the kernels use before they rely on it
//      (mma_probe.cu forms 4-6);
//   2. producer and consumers agree on the tile sequence through one
//      predicate (the causal bound and the CTA-wide id ranges), never a
//      consumer-side condition;
//   3. dk/dv registers at D = 128: 240 per consumer thread, see above;
//   4. TMA alignment: the wrapper's check and copy (tma_copies);
//   5. lse and delta are per query, a column of S^T in dk/dv: rows past N
//      get P = 0 from the mask, whatever the producer's zero fill holds.
//
// float32 (SIMT, the first design, kept for float32 only):
//  * dq: one CTA per (64-row query tile, batch*head), looping over the key
//    tiles up to the diagonal; the heaviest (last) query tiles go first. Q
//    and dO stay in shared memory (transposed); each key tile is read once
//    into K^T, K and V^T. dq is written once, after the loop: no atomics.
//  * dk/dv: one CTA per (64-key tile, batch*kv_head), looping over the
//    query heads of its GQA group and, for each, over the query tiles at
//    or below the diagonal; the heaviest (first) key tiles go first.
//  * every product is a 4 x 4 register block per thread over transposed
//    tiles (two 16-byte shared loads per 16 FMAs); P and dS are written
//    over the Q^T / dO^T (dk/dv) or V^T (dq) buffers once those are read,
//    so the dk/dv kernel fits its six tiles in 200 KB at D = 128.
//    __launch_bounds__(256, 1): one 8-warp CTA per SM, up to 255
//    registers a thread, 0 bytes of stack and spills on sm_90a.
//  * inputs are read through their [B, N, H, D] strides and the ragged edge
//    (N or N_kv not a multiple of 64) is masked in-kernel.
//  * segment ids ([B, N] int32, nullptr = off): each thread keeps the ids
//    of the rows or keys fixed for its CTA in registers and reads the
//    other side's ids with each tile; a (query tile, key tile) pair whose
//    id intervals do not meet is skipped whole, bit-exactly, as above.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_ids.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int TILE = 64;       // query rows or keys per tile
constexpr int THREADS = 256;   // 16 x 16: thread (ty, tx) owns rows ty*4..+3
constexpr int LDT = TILE + 4;  // row stride of transposed tiles
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
using ptseg::id_range;
using ptseg::ranges_meet;
static_assert(TILE == 64, "id_range's default run of 64 rows is one tile");

// x rounded to T's precision (the reference's .astype(dtype) points):
// the SIMT kernels run float32 only, where it is x
template <typename T>
__device__ __forceinline__ float round_as(float x) { return x; }

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

// -- bf16: wgmma + TMA --------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int ROWS = 64;                    // wgmma M, and a streamed tile
constexpr int CONSUMERS = 2;                // consumer warpgroups per CTA
constexpr int CTA_ROWS = CONSUMERS * ROWS;  // fixed rows (or keys) of a CTA
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int STAGES = 2;                   // ring of streamed tiles
constexpr int BOX = ROWS * 64;              // elements of one 64 x 64 box
constexpr uint32_t BOX_BYTES = BOX * 2;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct DqSmem {
  bf16 q[CONSUMERS][D / 64][BOX];   // each consumer's 64 query rows
  bf16 o[CONSUMERS][D / 64][BOX];   // and their dO rows
  bf16 k[STAGES][D / 64][BOX];      // streamed key tiles
  bf16 v[STAGES][D / 64][BOX];
  int32_t seg[STAGES][ROWS];        // the key tile's segment ids
  uint64_t full[STAGES], empty[STAGES], loaded;
};

template <int D>
struct DkvSmem {
  bf16 k[CONSUMERS][D / 64][BOX];   // each consumer's 64 keys
  bf16 v[CONSUMERS][D / 64][BOX];
  bf16 q[STAGES][D / 64][BOX];      // streamed query tiles
  bf16 o[STAGES][D / 64][BOX];
  float lse[STAGES][ROWS];          // log2(e) * lse of the tile's queries
  float delta[STAGES][ROWS];
  int32_t seg[STAGES][ROWS];
  uint64_t full[STAGES], empty[STAGES], loaded;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          bf16* __restrict__ dq, Args a) {
  using namespace ptwg;
  DqSmem<D>& s = aligned_smem<DqSmem<D>>();
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * CTA_ROWS;   // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads;
  const int kvh = h / (a.heads / a.kv_heads);
  const int32_t* sb =
      a.segs != nullptr ? a.segs + int64_t(b) * a.n : nullptr;
  const int kv_end = a.causal ? min(a.n_kv, q0 + CTA_ROWS) : a.n_kv;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      bar_init(&s.full[i], 32);               // the producer warp
      bar_init(&s.empty[i], CONSUMERS * 4);   // every consumer warp
    }
    bar_init(&s.loaded, 1);
    bar_init_fence();
  }
  __syncthreads();
  // The tile sequence, the same on both sides: key tiles up to the causal
  // edge, skipping those whose segment ids meet none of the CTA's rows.
  const int2 q_ids =
      sb != nullptr ? id_range(sb, q0, a.n, CTA_ROWS) : make_int2(0, 0);

  if (wg == CONSUMERS) {   // producer warpgroup: one warp issues the TMA
    regs_dealloc<PRODUCER_REGS>();
    if (warp != CONSUMERS * 4) return;
    if (lane == 0) {
      bar_arrive_tx(&s.loaded, 2 * CONSUMERS * (D / 64) * BOX_BYTES);
      for (int c = 0; c < CONSUMERS; ++c)
        for (int j = 0; j < D / 64; ++j) {
          tma_load(s.q[c][j], &tq, &s.loaded, j * 64, h, q0 + c * ROWS, b);
          tma_load(s.o[c][j], &to, &s.loaded, j * 64, h, q0 + c * ROWS, b);
        }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int k0 = 0; k0 < kv_end; k0 += ROWS) {
      if (sb != nullptr && !ranges_meet(id_range(sb, k0, a.n_kv), q_ids))
        continue;
      bar_wait(&s.empty[stage], phase ^ 1);
      if (sb != nullptr)
        for (int r = lane; r < ROWS; r += 32)
          s.seg[stage][r] = k0 + r < a.n_kv ? sb[k0 + r] : 0;
      if (lane == 0) {
        bar_arrive_tx(&s.full[stage], 2 * (D / 64) * BOX_BYTES);
        for (int j = 0; j < D / 64; ++j) {
          tma_load(s.k[stage][j], &tk, &s.full[stage], j * 64, kvh, k0, b);
          tma_load(s.v[stage][j], &tv, &s.full[stage], j * 64, kvh, k0, b);
        }
      } else {
        bar_arrive(&s.full[stage]);
      }
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {   // consumer warpgroup wg: query rows wq0 .. wq0 + 63
    regs_alloc<CONSUMER_REGS>();
    const int wq0 = q0 + wg * ROWS;
    const int r0 = wq0 + (warp & 3) * 16 + (lane >> 2);
    const float scale2 = a.scale * LOG2E;
    float lse2[2], dlt[2];
    int seg_r[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = r0 + 8 * hi;
      const int64_t at = int64_t(bh) * a.n + row;
      lse2[hi] = row < a.n ? lse[at] * LOG2E : 0.f;
      dlt[hi] = row < a.n ? delta[at] : 0.f;
      seg_r[hi] = sb != nullptr && row < a.n ? sb[row] : 0;
    }
    const int2 w_ids =
        sb != nullptr ? id_range(sb, wq0, a.n) : make_int2(0, 0);
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    bar_wait(&s.loaded, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int k0 = 0; k0 < kv_end; k0 += ROWS) {
      bool mine = true;
      if (sb != nullptr) {
        const int2 k_ids = id_range(sb, k0, a.n_kv);
        if (!ranges_meet(k_ids, q_ids)) continue;
        mine = ranges_meet(k_ids, w_ids);
      }
      bar_wait(&s.full[stage], phase);
      // warpgroup-uniform: rows past N, tiles past this warpgroup's
      // causal edge and tiles of other documents give exact zeros
      if (mine && wq0 < a.n && (!a.causal || k0 < wq0 + ROWS)) {
        float sa[32], pa[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)   // S = Q . K^T
          wgmma_ss<0>(sa, desc_kslice(s.q[wg][0], kk, BOX_BYTES),
                      desc_kslice(s.k[stage][0], kk, BOX_BYTES), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)   // dP = dO . V^T
          wgmma_ss<0>(pa, desc_kslice(s.o[wg][0], kk, BOX_BYTES),
                      desc_kslice(s.v[stage][0], kk, BOX_BYTES), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(sa);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hi = (i >> 1) & 1, row = r0 + 8 * hi;
          const int c = acc_col(i, lane), col = k0 + c;
          const bool ok = col < a.n_kv && row < a.n &&
                          (!a.causal || col <= row) &&
                          (sb == nullptr || seg_r[hi] == s.seg[stage][c]);
          sa[i] = ok ? exp2f(sa[i] * scale2 - lse2[hi]) : 0.f;   // P
        }
        wgmma_wait<0>();
        fence_regs(pa);
#pragma unroll
        for (int i = 0; i < 32; ++i)   // dS, rounded to bf16 by the pack
          pa[i] = sa[i] * (pa[i] - dlt[(i >> 1) & 1]);
        uint32_t ds[4][4];
        acc_to_frag(ds, pa);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)   // dq += dS . K, K read MN-major
          wgmma_rs<1>(acc, ds[kk],
                      desc_mnmajor(s.k[stage][0], BOX_BYTES) + kk * 128, 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&s.empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = r0 + 8 * hi;
      if (row >= a.n) continue;
      bf16* out = dq + ((int64_t(b) * a.n + row) * a.heads + h) * D;
#pragma unroll
      for (int i = 2 * hi; i < D / 2; i += 4)
        *reinterpret_cast<__nv_bfloat162*>(out + acc_col(i, lane)) =
            __floats2bfloat162_rn(acc[i] * a.scale, acc[i + 1] * a.scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           Args a) {
  using namespace ptwg;
  DkvSmem<D>& s = aligned_smem<DkvSmem<D>>();
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * CTA_ROWS;   // the first key tiles go first
  const int b = blockIdx.y / a.kv_heads, kvh = blockIdx.y % a.kv_heads;
  const int rep = a.heads / a.kv_heads;
  const int32_t* sb =
      a.segs != nullptr ? a.segs + int64_t(b) * a.n : nullptr;
  // causal: query tiles that end before key k0 see none of these keys
  const int q_begin = a.causal ? k0 : 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      bar_init(&s.full[i], 32);
      bar_init(&s.empty[i], CONSUMERS * 4);
    }
    bar_init(&s.loaded, 1);
    bar_init_fence();
  }
  __syncthreads();
  // The tile sequence, the same on both sides: for each query head of the
  // GQA group, the query tiles from the causal edge on, skipping those
  // whose segment ids meet none of the CTA's keys.
  const int2 k_ids =
      sb != nullptr ? id_range(sb, k0, a.n_kv, CTA_ROWS) : make_int2(0, 0);

  if (wg == CONSUMERS) {   // producer warpgroup
    regs_dealloc<PRODUCER_REGS>();
    if (warp != CONSUMERS * 4) return;
    if (lane == 0) {
      bar_arrive_tx(&s.loaded, 2 * CONSUMERS * (D / 64) * BOX_BYTES);
      for (int c = 0; c < CONSUMERS; ++c)
        for (int j = 0; j < D / 64; ++j) {
          tma_load(s.k[c][j], &tk, &s.loaded, j * 64, kvh, k0 + c * ROWS, b);
          tma_load(s.v[c][j], &tv, &s.loaded, j * 64, kvh, k0 + c * ROWS, b);
        }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int hq = 0; hq < rep; ++hq) {
      const int h = kvh * rep + hq;
      const int64_t bh = int64_t(b) * a.heads + h;
      for (int q0 = q_begin; q0 < a.n; q0 += ROWS) {
        if (sb != nullptr && !ranges_meet(id_range(sb, q0, a.n), k_ids))
          continue;
        bar_wait(&s.empty[stage], phase ^ 1);
        for (int r = lane; r < ROWS; r += 32) {
          const int q = q0 + r;
          const bool in = q < a.n;
          s.lse[stage][r] = in ? lse[bh * a.n + q] * LOG2E : 0.f;
          s.delta[stage][r] = in ? delta[bh * a.n + q] : 0.f;
          s.seg[stage][r] = sb != nullptr && in ? sb[q] : 0;
        }
        if (lane == 0) {
          bar_arrive_tx(&s.full[stage], 2 * (D / 64) * BOX_BYTES);
          for (int j = 0; j < D / 64; ++j) {
            tma_load(s.q[stage][j], &tq, &s.full[stage], j * 64, h, q0, b);
            tma_load(s.o[stage][j], &to, &s.full[stage], j * 64, h, q0, b);
          }
        } else {
          bar_arrive(&s.full[stage]);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {   // consumer warpgroup wg: keys wk0 .. wk0 + 63
    regs_alloc<CONSUMER_REGS>();
    const int wk0 = k0 + wg * ROWS;
    const int r0 = wk0 + (warp & 3) * 16 + (lane >> 2);
    const float scale2 = a.scale * LOG2E;
    int seg_r[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int key = r0 + 8 * hi;
      seg_r[hi] = sb != nullptr && key < a.n_kv ? sb[key] : 0;
    }
    const int2 w_ids =
        sb != nullptr ? id_range(sb, wk0, a.n_kv) : make_int2(0, 0);
    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    bar_wait(&s.loaded, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int hq = 0; hq < rep; ++hq) {
      for (int q0 = q_begin; q0 < a.n; q0 += ROWS) {
        bool mine = true;
        if (sb != nullptr) {
          const int2 q_ids = id_range(sb, q0, a.n);
          if (!ranges_meet(q_ids, k_ids)) continue;
          mine = ranges_meet(q_ids, w_ids);
        }
        bar_wait(&s.full[stage], phase);
        if (mine && wk0 < a.n_kv && (!a.causal || q0 + ROWS > wk0)) {
          float sa[32], pa[32];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)   // S^T = K . Q^T
            wgmma_ss<0>(sa, desc_kslice(s.k[wg][0], kk, BOX_BYTES),
                        desc_kslice(s.q[stage][0], kk, BOX_BYTES), kk > 0);
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)   // dP^T = V . dO^T
            wgmma_ss<0>(pa, desc_kslice(s.v[wg][0], kk, BOX_BYTES),
                        desc_kslice(s.o[stage][0], kk, BOX_BYTES), kk > 0);
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(sa);
#pragma unroll
          for (int i = 0; i < 32; ++i) {   // P^T; a column is a query
            const int key = r0 + 8 * ((i >> 1) & 1);
            const int c = acc_col(i, lane), col = q0 + c;
            const bool ok =
                col < a.n && key < a.n_kv && (!a.causal || key <= col) &&
                (sb == nullptr || seg_r[(i >> 1) & 1] == s.seg[stage][c]);
            sa[i] = ok ? exp2f(sa[i] * scale2 - s.lse[stage][c]) : 0.f;
          }
          uint32_t pf[4][4];   // P^T rounded to bf16
          acc_to_frag(pf, sa);
          wgmma_wait<0>();
          fence_regs(pa);
#pragma unroll
          for (int i = 0; i < 32; ++i)   // dS^T
            pa[i] = sa[i] * (pa[i] - s.delta[stage][acc_col(i, lane)]);
          uint32_t df[4][4];   // dS^T rounded to bf16
          acc_to_frag(df, pa);
          fence_regs(acc_v);
          fence_regs(acc_k);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)   // dv += P^T . dO, dO MN-major
            wgmma_rs<1>(acc_v, pf[kk],
                        desc_mnmajor(s.o[stage][0], BOX_BYTES) + kk * 128, 1);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)   // dk += dS^T . Q, Q MN-major
            wgmma_rs<1>(acc_k, df[kk],
                        desc_mnmajor(s.q[stage][0], BOX_BYTES) + kk * 128, 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc_v);
          fence_regs(acc_k);
        }
        __syncwarp();
        if (lane == 0) bar_arrive(&s.empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int key = r0 + 8 * hi;
      if (key >= a.n_kv) continue;
      const int64_t at =
          ((int64_t(b) * a.n_kv + key) * a.kv_heads + kvh) * D;
#pragma unroll
      for (int i = 2 * hi; i < D / 2; i += 4) {
        const int c = acc_col(i, lane);
        *reinterpret_cast<__nv_bfloat162*>(dk + at + c) =
            __floats2bfloat162_rn(acc_k[i] * a.scale, acc_k[i + 1] * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at + c) =
            __floats2bfloat162_rn(acc_v[i], acc_v[i + 1]);
      }
    }
  }
}

// the four operands' tensor maps: q, dO [B, N, H, D] and k, v [B, N_kv,
// H_kv, D] through their strides, 64-row boxes
template <int D>
cudaError_t operand_maps(CUtensorMap (&m)[4], const void* q, const void* k,
                         const void* v, const void* dout, int batch,
                         const Args& a) {
  cudaError_t err;
  if ((err = ptwg::tile_map(&m[0], q, D, a.heads, a.n, batch, a.sqh, a.sqn,
                            a.sqb, ROWS)) != cudaSuccess ||
      (err = ptwg::tile_map(&m[1], k, D, a.kv_heads, a.n_kv, batch, a.skh,
                            a.skn, a.skb, ROWS)) != cudaSuccess ||
      (err = ptwg::tile_map(&m[2], v, D, a.kv_heads, a.n_kv, batch, a.svh,
                            a.svn, a.svb, ROWS)) != cudaSuccess ||
      (err = ptwg::tile_map(&m[3], dout, D, a.heads, a.n, batch, a.soh,
                            a.son, a.sob, ROWS)) != cudaSuccess)
    return err;
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int batch, const Args& a,
                      cudaStream_t stream) {
  CUtensorMap m[4];
  cudaError_t err = operand_maps<D>(m, q, k, v, dout, batch, a);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(DqSmem<D>) + 1024;
  auto kernel = flash_bwd_dq_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + CTA_ROWS - 1) / CTA_ROWS, batch * a.heads);
  kernel<<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int batch, const Args& a,
                       cudaStream_t stream) {
  CUtensorMap m[4];
  cudaError_t err = operand_maps<D>(m, q, k, v, dout, batch, a);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(DkvSmem<D>) + 1024;
  auto kernel = flash_bwd_dkv_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_kv + CTA_ROWS - 1) / CTA_ROWS, batch * a.kv_heads);
  kernel<<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), a);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, dout [B, N, H, D] and k/v [B, N_kv, H_kv, D] with the given element
// strides for their first three axes (the last is contiguous; bf16 needs
// the addresses and strides in multiples of 16 bytes, as TMA reads
// them); lse and delta [B*H, N] float32; dq [B, N, H, D] contiguous.
// dtype: 0 = float32, 1 = bfloat16. segs: [B, N] int32 segment ids
// (needs n == n_kv), or nullptr for none. Returns the launch's cudaError_t.
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
    return tc::launch_dq<128>(q, k, v, dout, lse, delta, dq, batch, a, s);
  if (dtype == 1 && head_dim == 64)
    return tc::launch_dq<64>(q, k, v, dout, lse, delta, dq, batch, a, s);
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
    return tc::launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, batch, a,
                               s);
  if (dtype == 1 && head_dim == 64)
    return tc::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, batch, a,
                              s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
