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
//  * D = 256: kernels of their own (flash_bwd_dq_wgmma_d256_kernel,
//    flash_bwd_dkv_wgmma_d256_kernel, in the section "head dim 256"):
//    64-row CTAs whose two consumers split the output (dq's two 128-column
//    halves; dv and dk), since the D <= 128 CTAs need 256 KB of shared
//    memory and, for dk/dv, 256 accumulator registers.
//  * float16: the same two kernels with T = __half (`wgmma ...
//    .f32.f16.f16`, float16 tensor maps and fragments), the reference's
//    float16 mode (its `_dot` takes any float operands and sums in
//    float32). The rounding points are bf16's: P and dS rounded to
//    float16 where they become operands, dq/dk/dv once at the end.
//    Nothing is clamped or rescaled: under a large loss scale dP and dS
//    can pass float16's range and round to inf, and that inf reaches the
//    gradients as the plain version's does, for GradScaler to find. The
//    type is a template parameter, so Args does not grow and the bf16
//    instantiations compile as before.
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
// float32 (CUDA cores, TF32 off; the section "-- float32: CUDA cores"):
//  What bounds them: a visible (query, key) pair costs the dq kernel 3
//  products of 2 * D operations (S, dP, dS.K: 768 at D = 128) and the
//  dk/dv kernel 4 (S, dP, P^T.dO, dS^T.Q: 1024), at the fp32 CUDA cores'
//  67 TFLOP/s; the bytes (each operand read once, ~0.34 / 0.40 GB at the
//  llama1b training shape) take a tenth of that time. At B = 8, N = 1024,
//  H = 16, D = 128, causal (67.17 M visible pairs) the bounds are 0.770 ms
//  (dq) and 1.027 ms (dk/dv).
//  What held the first design, and what this one does about it:
//   1. synchronous scalar tile loads, one float at a time with a divide
//      and a modulo each, stored transposed with a 4-way bank conflict,
//      K (dq) and Q, dO (dk/dv) stored twice, nothing in flight while the
//      tile computed. Now: tiles stay row-major as they come from memory,
//      copied once by cp.async in 16-byte chunks (4-byte copies where the
//      host finds an operand's rows not 16-byte aligned: rows_vec), their
//      chunks XOR-swizzled by row % 8, so 8 consecutive rows hit 8
//      different bank groups both when a thread reads along D and when a
//      warp reads one row (csrc/f32_tiles.cuh, the forward's loads); the
//      streamed tiles are double-buffered, tile j + 1 landing while tile
//      j computes.
//   2. 4 x 4 register blocks over transposed tiles, P and dS written over
//      operand tiles, two products walked one after the other. Now thread
//      (ty, tx) of 16 x 16 owns rows ty + 16 i and columns tx + 16 j of S
//      and dP (dot_tiles: RM + RN 16-byte loads per 4 RM RN FMAs, float4
//      along D as the forward), then P and dS go to shared memory once,
//      transposed and swizzled, behind one barrier (store_t), and dq +=
//      dS.K, or dv += P^T.dO and dk += dS^T.Q in one walk over the query
//      tile, run as the forward's P.V loop (acc_tiles: per key or query,
//      RM / 4 loads of P and D / 64 of the operand feed RM * D / 16 FMAs a
//      product). The dq kernel takes 128-row tiles (8 x 2 blocks of S,
//      8 x D/16 of dq) where the grid gives every SM a CTA, else 64-row
//      ones (4 x 4), 1.7-1.9x faster there (ptf32::query_tile_rows, the
//      forward's rule; PERF.md section 6); the dk/dv kernel holds 64 keys (4 x 4 blocks): dk and
//      dv need 2 * D accumulators a key, so 128 keys would be 128
//      registers a thread at D = 128. Larger blocks were tried and kept
//      out (PERF.md section 6): 8 x 4 a thread, each half of the CTA taking
//      one of S and dP, cut the shared loads of the products by a
//      quarter, and skipping the blocks past the causal diagonal cut the
//      FMAs by 4-10 %; neither moved the time.
//   3. lse and delta of each streamed query read from device memory
//      inside the dk/dv tile loop. Now they come in with their query tile
//      (and its segment ids) by cp.async into the ring; the dq kernel's
//      rows keep theirs in registers, and the key tile's ids ride its ring.
//   4. the tile index on blockIdx.x, so "heaviest first" held only within
//      a head. Now it is blockIdx.y, as the forward's: the card hands out
//      every head's heaviest tile (dq: the last query tile; dk/dv: the
//      first key tile) before any head's next (7-13 % of the time at the
//      causal training shape, PERF.md section 6).
//   5. a `T` template parameter and its rounding and store helpers, left
//      from when bf16 ran here: gone; these kernels are float32 only.
//  Kept: one CTA per (query tile, batch*head) for dq and per (key tile,
//  batch*kv_head) for dk/dv, each output row written once, no atomics; the
//  GQA group's query heads summed inside the dk/dv CTA in a fixed order,
//  so repeated launches give the same bits; P = exp2(S * scale * log2 e -
//  lse * log2 e); masked pairs (causal, ragged, other segment) get P = 0,
//  so dS = 0; rows or keys past N or N_kv are zero-filled and masked;
//  segment ids skip a (query tile, key tile) pair whose id intervals do
//  not meet (ptseg::id_range / ranges_meet), which adds exact zeros
//  otherwise: the bits of the unskipped kernel, and all-zero ids give the
//  non-segmented bits. __launch_bounds__(256, 1): one CTA an SM (208-226
//  KB of shared memory at D = 128), up to 255 registers a thread;
//  chip_smoke.py phase 2 prints ptxas's registers and spills. D = 256
//  takes one stage (the next tile loads after this one's products) and
//  narrower streamed tiles: dq 64 rows over 32-key tiles (200 KB), dk/dv
//  64 keys over 32-query tiles (208 KB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_tiles.cuh"
#include "segment_ids.cuh"
#include "wgmma_bf16.cuh"

namespace {

// The bf16 kernels take Args by value: an int added to it (128 -> 136
// bytes) slowed them by ~45 % on the card (PERF.md section 6), so the float32
// kernels' copy flag (rows_vec) is a kernel parameter of its own.
struct Args {
  int n, n_kv, heads, kv_heads;
  int64_t sqb, sqn, sqh, skb, skn, skh, svb, svn, svh, sob, son, soh;
  float scale;
  int causal;
  const int32_t* segs;   // [B, N] segment ids (n == n_kv), or nullptr
};

using ptseg::id_range;
using ptseg::ranges_meet;

// -- float32: CUDA cores ------------------------------------------------

constexpr int THREADS = 256;   // 16 x 16
constexpr float LOG2E = 1.4426950408889634f;

using ptf32::cp_async_commit;
using ptf32::cp_async_wait_all;
using ptf32::load_rows;
using ptf32::load_vec;
using ptseg::next_tile;

// s[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over two swizzled
// [.., D] tiles: per 4 columns of D, RM + RN 16-byte shared loads feed
// 4 * RM * RN FMAs
template <int D, int RM, int RN>
__device__ __forceinline__ void dot_tiles(const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          int ty, int tx,
                                          float (&s)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
  const int asw = ty & 7, bsw = tx & 7;
#pragma unroll 4
  for (int c = 0; c < D / 4; ++c) {
    float4 x[RM], y[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      x[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * D +
                                              ((c ^ asw) << 2));
#pragma unroll
    for (int j = 0; j < RN; ++j)
      y[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * D +
                                              ((c ^ bsw) << 2));
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        float t = fmaf(x[i].x, y[j].x, s[i][j]);
        t = fmaf(x[i].y, y[j].y, t);
        t = fmaf(x[i].z, y[j].z, t);
        s[i][j] = fmaf(x[i].w, y[j].w, t);
      }
  }
}

// v[i][j] (row ty + 16 i, column tx + 16 j) into t[column][slot], a
// transposed tile of 16 * RM slots a column: this thread's rows sit at
// slots RM * ty + i, RM / 4 16-byte chunks swizzled by column % 8
template <int RM, int RN>
__device__ __forceinline__ void store_t(float* t, const float (&v)[RM][RN],
                                        int ty, int tx) {
#pragma unroll
  for (int j = 0; j < RN; ++j) {
    float* col = t + (tx + 16 * j) * (16 * RM);
#pragma unroll
    for (int u = 0; u < RM / 4; ++u)
      *reinterpret_cast<float4*>(col + ((((RM / 4) * ty + u) ^ (tx & 7))
                                        << 2)) =
          make_float4(v[4 * u][j], v[4 * u + 1][j], v[4 * u + 2][j],
                      v[4 * u + 3][j]);
  }
}

// acc[i][4 g + c] += sum_r t[r][slot of row ty + 16 i] * m[r][64 g + 4 tx
// + c] over the R columns of a store_t tile and the R rows of a swizzled
// [R][D] tile; with t2, m2 and acc2 a second such product in the same pass
// (dk/dv: one walk over the query tile for dv and dk)
template <int D, int RM, int R, bool TWO>
__device__ __forceinline__ void acc_tiles(const float* __restrict__ t,
                                          const float* __restrict__ m,
                                          float (&acc)[RM][D / 16],
                                          const float* __restrict__ t2,
                                          const float* __restrict__ m2,
                                          float (&acc2)[RM][D / 16], int ty,
                                          int tx) {
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    const int sw = r & 7;
    float p[RM], p2[RM];
#pragma unroll
    for (int u = 0; u < RM / 4; ++u) {
      const int at = r * (16 * RM) + ((((RM / 4) * ty + u) ^ sw) << 2);
      const float4 p4 = *reinterpret_cast<const float4*>(t + at);
      p[4 * u] = p4.x;
      p[4 * u + 1] = p4.y;
      p[4 * u + 2] = p4.z;
      p[4 * u + 3] = p4.w;
      if (TWO) {
        const float4 q4 = *reinterpret_cast<const float4*>(t2 + at);
        p2[4 * u] = q4.x;
        p2[4 * u + 1] = q4.y;
        p2[4 * u + 2] = q4.z;
        p2[4 * u + 3] = q4.w;
      }
    }
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      const int at = r * D + (((16 * g + tx) ^ sw) << 2);
      const float4 v4 = *reinterpret_cast<const float4*>(m + at);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        acc[i][4 * g] = fmaf(p[i], v4.x, acc[i][4 * g]);
        acc[i][4 * g + 1] = fmaf(p[i], v4.y, acc[i][4 * g + 1]);
        acc[i][4 * g + 2] = fmaf(p[i], v4.z, acc[i][4 * g + 2]);
        acc[i][4 * g + 3] = fmaf(p[i], v4.w, acc[i][4 * g + 3]);
      }
      if (TWO) {
        const float4 w4 = *reinterpret_cast<const float4*>(m2 + at);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          acc2[i][4 * g] = fmaf(p2[i], w4.x, acc2[i][4 * g]);
          acc2[i][4 * g + 1] = fmaf(p2[i], w4.y, acc2[i][4 * g + 1]);
          acc2[i][4 * g + 2] = fmaf(p2[i], w4.z, acc2[i][4 * g + 2]);
          acc2[i][4 * g + 3] = fmaf(p2[i], w4.w, acc2[i][4 * g + 3]);
        }
      }
    }
  }
}

// The dk/dv CTA's tile sequence: from (hq, q0) on, the first query tile of
// the group's head hq, then of the next heads from q_begin, whose ids can
// meet the CTA's keys (k_ids); hq == rep when none is left.
template <int BQ>
__device__ __forceinline__ void next_query_tile(int& hq, int& q0, int rep,
                                                int q_begin,
                                                const int32_t* sb, int n,
                                                int2 k_ids) {
  for (; hq < rep; ++hq, q0 = q_begin) {
    q0 = next_tile<BQ>(q0, n, sb, n, k_ids);
    if (q0 < n) return;
  }
}

// dq for BM query rows (64 or 128) of one (batch, head), streaming BN-key
// tiles of K and V (and their segment ids) through a ring of STAGES: 2, or
// 1 at D = 256 (the next tile then loads after this one's dS.K)
template <int D, int BM, int BN, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, Args a, int vec) {
  constexpr int RM = BM / 16, RN = BN / 16, NC = D / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [BM][D]
  float* os = qs + BM * D;                       // [BM][D] dO
  float* ks = os + BM * D;                       // [STAGES][BN][D]
  float* vs = ks + STAGES * BN * D;              // [STAGES][BN][D]
  float* dst = vs + STAGES * BN * D;             // [BN][BM] dS^T
  int32_t* segk =
      reinterpret_cast<int32_t*>(dst + BN * BM);   // [STAGES][BN]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest first
  const int bh = blockIdx.x;
  const int b = bh / a.heads, h = bh % a.heads;
  const int kvh = h / (a.heads / a.kv_heads);
  const float* kb = k + b * a.skb + kvh * a.skh;
  const float* vb = v + b * a.svb + kvh * a.svh;
  const int32_t* sb =
      a.segs != nullptr ? a.segs + int64_t(b) * a.n : nullptr;
  const float scale2 = a.scale * LOG2E;

  float lse2[RM], dlt[RM];
  int seg_q[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    const int64_t at = int64_t(bh) * a.n + row;
    const bool in = row < a.n;
    lse2[i] = in ? lse[at] * LOG2E : 0.f;
    dlt[i] = in ? delta[at] : 0.f;
    seg_q[i] = sb != nullptr && in ? sb[row] : 0;
  }
  const int2 q_ids =
      sb != nullptr ? id_range(sb, q0, a.n, BM) : make_int2(0, 0);
  const int kv_end = a.causal ? min(a.n_kv, q0 + BM) : a.n_kv;
  float acc[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  auto load_keys = [&](int stage, int k0) {
    load_rows<D, true, THREADS>(ks + stage * BN * D, kb, a.skn, k0, BN,
                                a.n_kv, vec);
    load_rows<D, true, THREADS>(vs + stage * BN * D, vb, a.svn, k0, BN,
                                a.n_kv, vec);
    if (sb != nullptr)
      load_vec<THREADS>(segk + stage * BN, sb, k0, BN, a.n_kv);
  };
  load_rows<D, true, THREADS>(qs, q + b * a.sqb + h * a.sqh, a.sqn, q0, BM,
                              a.n, vec);
  load_rows<D, true, THREADS>(os, dout + b * a.sob + h * a.soh, a.son, q0,
                              BM, a.n, vec);
  int k0 = next_tile<BN>(0, kv_end, sb, a.n_kv, q_ids);
  if (k0 < kv_end) load_keys(0, k0);
  cp_async_commit();
  for (int stage = 0; k0 < kv_end; stage = (stage + 1) % STAGES) {
    cp_async_wait_all();
    // tile k0 has landed for every thread, and every thread is done with
    // the previous tile's dS.K: its buffers and dS^T are free
    __syncthreads();
    const int k1 = next_tile<BN>(k0 + BN, kv_end, sb, a.n_kv, q_ids);
    if (STAGES == 2) {
      if (k1 < kv_end) load_keys(stage ^ 1, k1);
      cp_async_commit();
    }

    const float* kt = ks + stage * BN * D;
    float s[RM][RN], dp[RM][RN];
    dot_tiles<D, RM, RN>(qs, kt, ty, tx, s);                      // S
    dot_tiles<D, RM, RN>(os, vs + stage * BN * D, ty, tx, dp);   // dP
    int seg_k[RN];
#pragma unroll
    for (int j = 0; j < RN; ++j)
      seg_k[j] = sb != nullptr ? segk[stage * BN + tx + 16 * j] : 0;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = row < a.n && col < a.n_kv &&
                        (!a.causal || col <= row) && seg_q[i] == seg_k[j];
        const float p = ok ? exp2f(fmaf(s[i][j], scale2, -lse2[i])) : 0.f;
        s[i][j] = p * (dp[i][j] - dlt[i]);   // dS
      }
    }
    store_t<RM, RN>(dst, s, ty, tx);
    __syncthreads();   // dS^T is complete
    acc_tiles<D, RM, BN, false>(dst, kt, acc, dst, kt, acc, ty,
                                tx);   // dq += dS . K
    if (STAGES == 1) {
      __syncthreads();   // every thread is done with this tile's K and V
      if (k1 < kv_end) load_keys(0, k1);
      cp_async_commit();
    }
    k0 = k1;
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.n) continue;
    float* out = dq + ((int64_t(b) * a.n + row) * a.heads + h) * D;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
      *reinterpret_cast<float4*>(out + 64 * g + 4 * tx) = make_float4(
          acc[i][4 * g] * a.scale, acc[i][4 * g + 1] * a.scale,
          acc[i][4 * g + 2] * a.scale, acc[i][4 * g + 3] * a.scale);
  }
}

// dk and dv for BK keys of one (batch, kv head), streaming BQ-query tiles
// of Q and dO with their lse, delta and segment ids through a ring of
// STAGES (2, or 1 at D = 256), over the query heads of the GQA group in
// order
template <int D, int BK, int BQ, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         Args a, int vec) {
  constexpr int RM = BK / 16, RN = BQ / 16, NC = D / 16;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // [BK][D]
  float* vs = ks + BK * D;                       // [BK][D]
  float* qs = vs + BK * D;                       // [STAGES][BQ][D]
  float* os = qs + STAGES * BQ * D;              // [STAGES][BQ][D] dO
  float* pt = os + STAGES * BQ * D;              // [BQ][BK] P^T
  float* dst = pt + BQ * BK;                     // [BQ][BK] dS^T
  float* rowv = dst + BQ * BK;   // [STAGES][3][BQ]: lse, delta, ids

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.y * BK;   // the first key tiles are the heaviest
  const int b = blockIdx.x / a.kv_heads, kvh = blockIdx.x % a.kv_heads;
  const int rep = a.heads / a.kv_heads;
  const int32_t* sb =
      a.segs != nullptr ? a.segs + int64_t(b) * a.n : nullptr;
  const float scale2 = a.scale * LOG2E;

  int seg_k[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int key = k0 + ty + 16 * i;
    seg_k[i] = sb != nullptr && key < a.n_kv ? sb[key] : 0;
  }
  const int2 k_ids =
      sb != nullptr ? id_range(sb, k0, a.n_kv, BK) : make_int2(0, 0);
  float acc_k[RM][NC], acc_v[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  auto load_queries = [&](int stage, int hq, int q0) {
    const int h = kvh * rep + hq;
    const int64_t bh = int64_t(b) * a.heads + h;
    float* vecs = rowv + stage * 3 * BQ;
    load_rows<D, true, THREADS>(qs + stage * BQ * D,
                                q + b * a.sqb + h * a.sqh, a.sqn, q0, BQ,
                                a.n, vec);
    load_rows<D, true, THREADS>(os + stage * BQ * D,
                                dout + b * a.sob + h * a.soh, a.son, q0, BQ,
                                a.n, vec);
    load_vec<THREADS>(vecs, lse + bh * a.n, q0, BQ, a.n);
    load_vec<THREADS>(vecs + BQ, delta + bh * a.n, q0, BQ, a.n);
    if (sb != nullptr) load_vec<THREADS>(vecs + 2 * BQ, sb, q0, BQ, a.n);
  };
  load_rows<D, true, THREADS>(ks, k + b * a.skb + kvh * a.skh, a.skn, k0, BK,
                              a.n_kv, vec);
  load_rows<D, true, THREADS>(vs, v + b * a.svb + kvh * a.svh, a.svn, k0, BK,
                              a.n_kv, vec);
  // causal: query tiles that end before key k0 see none of these keys
  const int q_begin = a.causal ? (k0 / BQ) * BQ : 0;
  int hq = 0, q0 = q_begin;
  next_query_tile<BQ>(hq, q0, rep, q_begin, sb, a.n, k_ids);
  if (hq < rep) load_queries(0, hq, q0);
  cp_async_commit();
  for (int stage = 0; hq < rep; stage = (stage + 1) % STAGES) {
    cp_async_wait_all();
    // tile (hq, q0) has landed, and every thread is done with the last
    // tile's products: its buffers, P^T and dS^T are free
    __syncthreads();
    int hq1 = hq, q1 = q0 + BQ;
    next_query_tile<BQ>(hq1, q1, rep, q_begin, sb, a.n, k_ids);
    if (STAGES == 2) {
      if (hq1 < rep) load_queries(stage ^ 1, hq1, q1);
      cp_async_commit();
    }

    const float* qt = qs + stage * BQ * D;
    const float* ot = os + stage * BQ * D;
    const float* vecs = rowv + stage * 3 * BQ;
    // s[i][j], dp[i][j]: key k0 + ty + 16 i, query q0 + tx + 16 j
    float s[RM][RN], dp[RM][RN];
    dot_tiles<D, RM, RN>(ks, qt, ty, tx, s);    // S^T = K . Q^T
    dot_tiles<D, RM, RN>(vs, ot, ty, tx, dp);   // dP^T = V . dO^T
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = tx + 16 * j, col = q0 + c;
      const float lse2 = vecs[c] * LOG2E, dlt = vecs[BQ + c];
      const int seg = sb != nullptr
                          ? reinterpret_cast<const int32_t*>(vecs)[2 * BQ + c]
                          : 0;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int key = k0 + ty + 16 * i;
        const bool ok = col < a.n && key < a.n_kv &&
                        (!a.causal || key <= col) && seg_k[i] == seg;
        const float p = ok ? exp2f(fmaf(s[i][j], scale2, -lse2)) : 0.f;
        s[i][j] = p;
        dp[i][j] = p * (dp[i][j] - dlt);   // dS
      }
    }
    store_t<RM, RN>(pt, s, ty, tx);
    store_t<RM, RN>(dst, dp, ty, tx);
    __syncthreads();   // P^T and dS^T are complete
    // dv += P^T . dO and dk += dS^T . Q
    acc_tiles<D, RM, BQ, true>(pt, ot, acc_v, dst, qt, acc_k, ty, tx);
    if (STAGES == 1) {
      __syncthreads();   // every thread is done with this tile's Q and dO
      if (hq1 < rep) load_queries(0, hq1, q1);
      cp_async_commit();
    }
    hq = hq1;
    q0 = q1;
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.n_kv) continue;
    const int64_t at = ((int64_t(b) * a.n_kv + key) * a.kv_heads + kvh) * D;
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      const int d = 64 * g + 4 * tx;
      *reinterpret_cast<float4*>(dk + at + d) = make_float4(
          acc_k[i][4 * g] * a.scale, acc_k[i][4 * g + 1] * a.scale,
          acc_k[i][4 * g + 2] * a.scale, acc_k[i][4 * g + 3] * a.scale);
      *reinterpret_cast<float4*>(dv + at + d) =
          make_float4(acc_v[i][4 * g], acc_v[i][4 * g + 1],
                      acc_v[i][4 * g + 2], acc_v[i][4 * g + 3]);
    }
  }
}

template <int D, int BM, int BN, int STAGES = 2>
cudaError_t launch_dq_f32_tiles(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int batch,
                                const Args& a, int vec, cudaStream_t stream) {
  const size_t smem = size_t(2 * BM * D + 2 * STAGES * BN * D + BN * BM +
                             STAGES * BN) * sizeof(float);
  auto kernel = flash_bwd_dq_f32_kernel<D, BM, BN, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.heads, (a.n + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), a, vec);
  return cudaGetLastError();
}

// 128 query rows or, for a grid that leaves SMs idle, 64
// (ptf32::query_tile_rows); 128-row tiles stream 32-key tiles, so that Q,
// dO and the K/V ring fit. D = 256: 64 rows, 32-key tiles, one K/V buffer
// (200 KB; two would be 264 KB)
template <int D>
cudaError_t launch_dq_f32(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int batch,
                          const Args& a, int vec, cudaStream_t stream) {
  if constexpr (D > 128) {
    return launch_dq_f32_tiles<D, 64, 32, 1>(q, k, v, dout, lse, delta, dq,
                                             batch, a, vec, stream);
  } else {
    int rows = 0;
    const cudaError_t err =
        ptf32::query_tile_rows((long long)batch * a.heads, a.n, &rows);
    if (err != cudaSuccess) return err;
    if (rows == 128)
      return launch_dq_f32_tiles<D, 128, 32>(q, k, v, dout, lse, delta, dq,
                                             batch, a, vec, stream);
    return launch_dq_f32_tiles<D, 64, 64>(q, k, v, dout, lse, delta, dq,
                                          batch, a, vec, stream);
  }
}

// 64 keys a CTA, 64-query tiles double-buffered; D = 256: 32-query tiles,
// one buffer (208 KB; 64-query tiles double-buffered would be 417 KB)
template <int D>
cudaError_t launch_dkv_f32(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int batch,
                           const Args& a, int vec, cudaStream_t stream) {
  constexpr int BK = 64, BQ = D > 128 ? 32 : 64, STAGES = D > 128 ? 1 : 2;
  const size_t smem = size_t(2 * BK * D + 2 * STAGES * BQ * D + 2 * BQ * BK +
                             3 * STAGES * BQ) * sizeof(float);
  auto kernel = flash_bwd_dkv_f32_kernel<D, BK, BQ, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.kv_heads, (a.n_kv + BK - 1) / BK);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), a, vec);
  return cudaGetLastError();
}

// whether the float32 kernels may copy every row of q, k, v and dO in
// 16-byte chunks (st: their strides, as the entry points take them)
int rows_vec(const void* q, const void* k, const void* v, const void* dout,
             int batch, int n, int n_kv, int heads, int kv_heads,
             const long long* st) {
  using ptf32::rows_aligned;
  return rows_aligned(q, batch, st[0], n, st[1], heads, st[2]) &&
         rows_aligned(k, batch, st[3], n_kv, st[4], kv_heads, st[5]) &&
         rows_aligned(v, batch, st[6], n_kv, st[7], kv_heads, st[8]) &&
         rows_aligned(dout, batch, st[9], n, st[10], heads, st[11]);
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

template <int D, typename T>
struct DqSmem {
  T q[CONSUMERS][D / 64][BOX];   // each consumer's 64 query rows
  T o[CONSUMERS][D / 64][BOX];   // and their dO rows
  T k[STAGES][D / 64][BOX];      // streamed key tiles
  T v[STAGES][D / 64][BOX];
  int32_t seg[STAGES][ROWS];        // the key tile's segment ids
  uint64_t full[STAGES], empty[STAGES], loaded;
};

template <int D, typename T>
struct DkvSmem {
  T k[CONSUMERS][D / 64][BOX];   // each consumer's 64 keys
  T v[CONSUMERS][D / 64][BOX];
  T q[STAGES][D / 64][BOX];      // streamed query tiles
  T o[STAGES][D / 64][BOX];
  float lse[STAGES][ROWS];          // log2(e) * lse of the tile's queries
  float delta[STAGES][ROWS];
  int32_t seg[STAGES][ROWS];
  uint64_t full[STAGES], empty[STAGES], loaded;
};

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap to,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dq, Args a) {
  using namespace ptwg;
  DqSmem<D, T>& s = aligned_smem<DqSmem<D, T>>();
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
          wgmma_ss<0, 0, T>(sa, desc_kslice(s.q[wg][0], kk, BOX_BYTES),
                            desc_kslice(s.k[stage][0], kk, BOX_BYTES),
                            kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)   // dP = dO . V^T
          wgmma_ss<0, 0, T>(pa, desc_kslice(s.o[wg][0], kk, BOX_BYTES),
                            desc_kslice(s.v[stage][0], kk, BOX_BYTES),
                            kk > 0);
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
        for (int i = 0; i < 32; ++i)   // dS, rounded to T by the pack
          pa[i] = sa[i] * (pa[i] - dlt[(i >> 1) & 1]);
        uint32_t ds[4][4];
        acc_to_frag<T>(ds, pa);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)   // dq += dS . K, K read MN-major
          wgmma_rs<1, T>(acc, ds[kk],
                         desc_mnmajor(s.k[stage][0], BOX_BYTES) + kk * 128,
                         1);
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
      T* out = dq + ((int64_t(b) * a.n + row) * a.heads + h) * D;
#pragma unroll
      for (int i = 2 * hi; i < D / 2; i += 4)
        store2(out + acc_col(i, lane), acc[i] * a.scale,
               acc[i + 1] * a.scale);
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv,
                           Args a) {
  using namespace ptwg;
  DkvSmem<D, T>& s = aligned_smem<DkvSmem<D, T>>();
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
            wgmma_ss<0, 0, T>(sa, desc_kslice(s.k[wg][0], kk, BOX_BYTES),
                              desc_kslice(s.q[stage][0], kk, BOX_BYTES),
                              kk > 0);
          wgmma_commit();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)   // dP^T = V . dO^T
            wgmma_ss<0, 0, T>(pa, desc_kslice(s.v[wg][0], kk, BOX_BYTES),
                              desc_kslice(s.o[stage][0], kk, BOX_BYTES),
                              kk > 0);
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
          uint32_t pf[4][4];   // P^T rounded to T
          acc_to_frag<T>(pf, sa);
          wgmma_wait<0>();
          fence_regs(pa);
#pragma unroll
          for (int i = 0; i < 32; ++i)   // dS^T
            pa[i] = sa[i] * (pa[i] - s.delta[stage][acc_col(i, lane)]);
          uint32_t df[4][4];   // dS^T rounded to T
          acc_to_frag<T>(df, pa);
          fence_regs(acc_v);
          fence_regs(acc_k);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)   // dv += P^T . dO, dO MN-major
            wgmma_rs<1, T>(acc_v, pf[kk],
                           desc_mnmajor(s.o[stage][0], BOX_BYTES) + kk * 128,
                           1);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)   // dk += dS^T . Q, Q MN-major
            wgmma_rs<1, T>(acc_k, df[kk],
                           desc_mnmajor(s.q[stage][0], BOX_BYTES) + kk * 128,
                           1);
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
        store2(dk + at + c, acc_k[i] * a.scale, acc_k[i + 1] * a.scale);
        store2(dv + at + c, acc_v[i], acc_v[i + 1]);
      }
    }
  }
}

// -- head dim 256 ---------------------------------------------------------
//
// At D = 256 the D <= 128 CTAs do not fit the card: dq's Q and dO for two
// 64-row consumers and two K/V stages come to 256 KB of shared memory, and
// a dk/dv consumer would hold dk and dv as 2 x 128 fp32 accumulators, over
// the 240 registers it gets. So both kernels take 64 rows (or keys) a CTA
// and give the two consumer warpgroups different outputs of them:
//  * dq: both consumers compute S and dP for the same 64 query rows (the
//    same products on the same operands: the same bits) and each keeps one
//    128-column half of dq (64 accumulators), dq[:, 128 wg ..] += dS .
//    K[:, 128 wg ..]. The scores are computed twice; that is the price of
//    a register budget of 64 + 2 x 32 a thread. Q and dO (32 KB each) load
//    once, K/V tiles stream through two 64 KB stages: 192 KB;
//  * dk/dv: one CTA per (64 keys, batch * kv head); consumer 0 computes
//    S^T and dv += P^T . dO, consumer 1 S^T, dP^T and dk += dS^T . Q, each
//    with one m64n256 accumulator (128 registers). K and V load once (32
//    KB each), query tiles stream through two 64 KB stages: 192 KB. 64-key
//    CTAs also double the grid of a GQA model with one kv head (Gemma-2B's
//    widths: 8 x 1 x 1024 / 64 = 128 CTAs on 132 SMs), where 128-key CTAs
//    would leave half the SMs idle. What remains is the causal spread: the
//    first key tile sees every query tile, the last one one.
// Producer, tile sequence, masks, rounding points and the segment-id skip
// are those of the D <= 128 kernels above.

template <typename T>
struct DqSmem256 {
  static constexpr int D = 256, ST = 2;
  T q[D / 64][BOX];          // the CTA's 64 query rows
  T o[D / 64][BOX];          // and their dO rows
  T k[ST][D / 64][BOX];      // streamed key tiles
  T v[ST][D / 64][BOX];
  int32_t seg[ST][ROWS];
  uint64_t full[ST], empty[ST], loaded;
};

template <typename T>
struct DkvSmem256 {
  static constexpr int D = 256, ST = 2;
  T k[D / 64][BOX];          // the CTA's 64 keys
  T v[D / 64][BOX];
  T q[ST][D / 64][BOX];      // streamed query tiles
  T o[ST][D / 64][BOX];
  float lse[ST][ROWS];       // log2(e) * lse of the tile's queries
  float delta[ST][ROWS];
  int32_t seg[ST][ROWS];
  uint64_t full[ST], empty[ST], loaded;
};

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma_d256_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap to,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               T* __restrict__ dq, Args a) {
  using namespace ptwg;
  using Sm = DqSmem256<T>;
  constexpr int D = Sm::D, ST = Sm::ST;
  Sm& s = aligned_smem<Sm>();
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;   // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads;
  const int kvh = h / (a.heads / a.kv_heads);
  const int32_t* sb =
      a.segs != nullptr ? a.segs + int64_t(b) * a.n : nullptr;
  const int kv_end = a.causal ? min(a.n_kv, q0 + ROWS) : a.n_kv;
  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      bar_init(&s.full[i], 32);               // the producer warp
      bar_init(&s.empty[i], CONSUMERS * 4);   // every consumer warp
    }
    bar_init(&s.loaded, 1);
    bar_init_fence();
  }
  __syncthreads();
  const int2 q_ids = sb != nullptr ? id_range(sb, q0, a.n) : make_int2(0, 0);

  if (wg == CONSUMERS) {   // producer warpgroup: one warp issues the TMA
    regs_dealloc<PRODUCER_REGS>();
    if (warp != CONSUMERS * 4) return;
    if (lane == 0) {
      bar_arrive_tx(&s.loaded, 2 * (D / 64) * BOX_BYTES);
      for (int j = 0; j < D / 64; ++j) {
        tma_load(s.q[j], &tq, &s.loaded, j * 64, h, q0, b);
        tma_load(s.o[j], &to, &s.loaded, j * 64, h, q0, b);
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
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {   // consumer warpgroup wg: dq[:, 128 wg .. 128 wg + 127]
    regs_alloc<CONSUMER_REGS>();
    const int r0 = q0 + (warp & 3) * 16 + (lane >> 2);
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
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    bar_wait(&s.loaded, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int k0 = 0; k0 < kv_end; k0 += ROWS) {
      if (sb != nullptr && !ranges_meet(id_range(sb, k0, a.n_kv), q_ids))
        continue;
      bar_wait(&s.full[stage], phase);
      float sa[32], pa[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)   // S = Q . K^T
        wgmma_ss<0, 0, T>(sa, desc_kslice(s.q[0], kk, BOX_BYTES),
                          desc_kslice(s.k[stage][0], kk, BOX_BYTES), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)   // dP = dO . V^T
        wgmma_ss<0, 0, T>(pa, desc_kslice(s.o[0], kk, BOX_BYTES),
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
      for (int i = 0; i < 32; ++i)   // dS, rounded to T by the pack
        pa[i] = sa[i] * (pa[i] - dlt[(i >> 1) & 1]);
      uint32_t ds[4][4];
      acc_to_frag<T>(ds, pa);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)   // dq half += dS . K half, MN-major
        wgmma_rs<1, T>(acc, ds[kk],
                       desc_mnmajor(s.k[stage][2 * wg], BOX_BYTES) + kk * 128,
                       1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) bar_arrive(&s.empty[stage]);
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = r0 + 8 * hi;
      if (row >= a.n) continue;
      T* out = dq + ((int64_t(b) * a.n + row) * a.heads + h) * D + 128 * wg;
#pragma unroll
      for (int i = 2 * hi; i < 64; i += 4)
        store2(out + acc_col(i, lane), acc[i] * a.scale,
               acc[i + 1] * a.scale);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma_d256_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap to,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                T* __restrict__ dk, T* __restrict__ dv,
                                Args a) {
  using namespace ptwg;
  using Sm = DkvSmem256<T>;
  constexpr int D = Sm::D, ST = Sm::ST;
  Sm& s = aligned_smem<Sm>();
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int k0 = blockIdx.x * ROWS;   // the first key tiles go first
  const int b = blockIdx.y / a.kv_heads, kvh = blockIdx.y % a.kv_heads;
  const int rep = a.heads / a.kv_heads;
  const int32_t* sb =
      a.segs != nullptr ? a.segs + int64_t(b) * a.n : nullptr;
  // causal: query tiles that end before key k0 see none of these keys
  const int q_begin = a.causal ? k0 : 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      bar_init(&s.full[i], 32);
      bar_init(&s.empty[i], CONSUMERS * 4);
    }
    bar_init(&s.loaded, 1);
    bar_init_fence();
  }
  __syncthreads();
  const int2 k_ids =
      sb != nullptr ? id_range(sb, k0, a.n_kv) : make_int2(0, 0);

  if (wg == CONSUMERS) {   // producer warpgroup
    regs_dealloc<PRODUCER_REGS>();
    if (warp != CONSUMERS * 4) return;
    if (lane == 0) {
      bar_arrive_tx(&s.loaded, 2 * (D / 64) * BOX_BYTES);
      for (int j = 0; j < D / 64; ++j) {
        tma_load(s.k[j], &tk, &s.loaded, j * 64, kvh, k0, b);
        tma_load(s.v[j], &tv, &s.loaded, j * 64, kvh, k0, b);
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
        if (++stage == ST) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {   // consumer 0: dv of the CTA's keys; consumer 1: dk
    regs_alloc<CONSUMER_REGS>();
    const int r0 = k0 + (warp & 3) * 16 + (lane >> 2);
    const float scale2 = a.scale * LOG2E;
    int seg_r[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int key = r0 + 8 * hi;
      seg_r[hi] = sb != nullptr && key < a.n_kv ? sb[key] : 0;
    }
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    bar_wait(&s.loaded, 0);
    int stage = 0;
    uint32_t phase = 0;
    for (int hq = 0; hq < rep; ++hq) {
      for (int q0 = q_begin; q0 < a.n; q0 += ROWS) {
        if (sb != nullptr && !ranges_meet(id_range(sb, q0, a.n), k_ids))
          continue;
        bar_wait(&s.full[stage], phase);
        float sa[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)   // S^T = K . Q^T
          wgmma_ss<0, 0, T>(sa, desc_kslice(s.k[0], kk, BOX_BYTES),
                            desc_kslice(s.q[stage][0], kk, BOX_BYTES),
                            kk > 0);
        wgmma_commit();
        if (wg == 0) {
          wgmma_wait<0>();
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
          uint32_t pf[4][4];   // P^T rounded to T
          acc_to_frag<T>(pf, sa);
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)   // dv += P^T . dO, dO MN-major
            wgmma_rs<1, T>(acc, pf[kk],
                           desc_mnmajor(s.o[stage][0], BOX_BYTES) + kk * 128,
                           1);
        } else {
          float pa[32];
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)   // dP^T = V . dO^T
            wgmma_ss<0, 0, T>(pa, desc_kslice(s.v[0], kk, BOX_BYTES),
                              desc_kslice(s.o[stage][0], kk, BOX_BYTES),
                              kk > 0);
          wgmma_commit();
          wgmma_wait<1>();
          fence_regs(sa);
#pragma unroll
          for (int i = 0; i < 32; ++i) {   // P^T
            const int key = r0 + 8 * ((i >> 1) & 1);
            const int c = acc_col(i, lane), col = q0 + c;
            const bool ok =
                col < a.n && key < a.n_kv && (!a.causal || key <= col) &&
                (sb == nullptr || seg_r[(i >> 1) & 1] == s.seg[stage][c]);
            sa[i] = ok ? exp2f(sa[i] * scale2 - s.lse[stage][c]) : 0.f;
          }
          wgmma_wait<0>();
          fence_regs(pa);
#pragma unroll
          for (int i = 0; i < 32; ++i)   // dS^T
            pa[i] = sa[i] * (pa[i] - s.delta[stage][acc_col(i, lane)]);
          uint32_t df[4][4];   // dS^T rounded to T
          acc_to_frag<T>(df, pa);
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)   // dk += dS^T . Q, Q MN-major
            wgmma_rs<1, T>(acc, df[kk],
                           desc_mnmajor(s.q[stage][0], BOX_BYTES) + kk * 128,
                           1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) bar_arrive(&s.empty[stage]);
        if (++stage == ST) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    T* out = wg == 0 ? dv : dk;
    const float mul = wg == 0 ? 1.f : a.scale;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int key = r0 + 8 * hi;
      if (key >= a.n_kv) continue;
      const int64_t at =
          ((int64_t(b) * a.n_kv + key) * a.kv_heads + kvh) * D;
#pragma unroll
      for (int i = 2 * hi; i < 128; i += 4)
        store2(out + at + acc_col(i, lane), acc[i] * mul, acc[i + 1] * mul);
    }
  }
}

// the four operands' tensor maps: q, dO [B, N, H, D] and k, v [B, N_kv,
// H_kv, D] through their strides, 64-row boxes
template <int D, typename T>
cudaError_t operand_maps(CUtensorMap (&m)[4], const void* q, const void* k,
                         const void* v, const void* dout, int batch,
                         const Args& a) {
  cudaError_t err;
  if ((err = ptwg::tile_map(&m[0], q, D, a.heads, a.n, batch, a.sqh, a.sqn,
                            a.sqb, ROWS,
                            ptwg::tma_type<T>)) != cudaSuccess ||
      (err = ptwg::tile_map(&m[1], k, D, a.kv_heads, a.n_kv, batch, a.skh,
                            a.skn, a.skb, ROWS,
                            ptwg::tma_type<T>)) != cudaSuccess ||
      (err = ptwg::tile_map(&m[2], v, D, a.kv_heads, a.n_kv, batch, a.svh,
                            a.svn, a.svb, ROWS,
                            ptwg::tma_type<T>)) != cudaSuccess ||
      (err = ptwg::tile_map(&m[3], dout, D, a.heads, a.n, batch, a.soh,
                            a.son, a.sob, ROWS,
                            ptwg::tma_type<T>)) != cudaSuccess)
    return err;
  return cudaSuccess;
}

template <int D, typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int batch, const Args& a,
                      cudaStream_t stream) {
  CUtensorMap m[4];
  cudaError_t err = operand_maps<D, T>(m, q, k, v, dout, batch, a);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(DqSmem<D, T>) + 1024;
  auto kernel = flash_bwd_dq_wgmma_kernel<D, T>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + CTA_ROWS - 1) / CTA_ROWS, batch * a.heads);
  kernel<<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), a);
  return cudaGetLastError();
}

template <int D, typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int batch, const Args& a,
                       cudaStream_t stream) {
  CUtensorMap m[4];
  cudaError_t err = operand_maps<D, T>(m, q, k, v, dout, batch, a);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(DkvSmem<D, T>) + 1024;
  auto kernel = flash_bwd_dkv_wgmma_kernel<D, T>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_kv + CTA_ROWS - 1) / CTA_ROWS, batch * a.kv_heads);
  kernel<<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), a);
  return cudaGetLastError();
}


// head dim 256: 64-row (dq) and 64-key (dk/dv) CTAs, see above
template <typename T>
cudaError_t launch_dq256(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int batch, const Args& a,
                         cudaStream_t stream) {
  CUtensorMap m[4];
  cudaError_t err = operand_maps<256, T>(m, q, k, v, dout, batch, a);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(DqSmem256<T>) + 1024;
  auto kernel = flash_bwd_dq_wgmma_d256_kernel<T>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n + ROWS - 1) / ROWS, batch * a.heads);
  kernel<<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv256(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int batch,
                          const Args& a, cudaStream_t stream) {
  CUtensorMap m[4];
  cudaError_t err = operand_maps<256, T>(m, q, k, v, dout, batch, a);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(DkvSmem256<T>) + 1024;
  auto kernel = flash_bwd_dkv_wgmma_d256_kernel<T>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_kv + ROWS - 1) / ROWS, batch * a.kv_heads);
  kernel<<<grid, THREADS, smem, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<T*>(dv), a);
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
// dtype: 0 = float32, 1 = bfloat16, 3 = float16. segs: [B, N] int32 segment ids
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
  const int vec = rows_vec(q, k, v, dout, batch, n, n_kv, heads, kv_heads, st);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 256)
    return launch_dq_f32<256>(q, k, v, dout, lse, delta, dq, batch, a, vec,
                              s);
  if (dtype == 0 && head_dim == 128)
    return launch_dq_f32<128>(q, k, v, dout, lse, delta, dq, batch, a, vec,
                              s);
  if (dtype == 0 && head_dim == 64)
    return launch_dq_f32<64>(q, k, v, dout, lse, delta, dq, batch, a, vec, s);
  if (dtype == 1 && head_dim == 256)
    return tc::launch_dq256<tc::bf16>(q, k, v, dout, lse, delta, dq, batch,
                                    a, s);
  if (dtype == 1 && head_dim == 128)
    return tc::launch_dq<128, tc::bf16>(q, k, v, dout, lse, delta, dq, batch,
                                        a, s);
  if (dtype == 1 && head_dim == 64)
    return tc::launch_dq<64, tc::bf16>(q, k, v, dout, lse, delta, dq, batch,
                                       a, s);
  if (dtype == 3 && head_dim == 256)
    return tc::launch_dq256<__half>(q, k, v, dout, lse, delta, dq, batch,
                                  a, s);
  if (dtype == 3 && head_dim == 128)
    return tc::launch_dq<128, __half>(q, k, v, dout, lse, delta, dq, batch,
                                      a, s);
  if (dtype == 3 && head_dim == 64)
    return tc::launch_dq<64, __half>(q, k, v, dout, lse, delta, dq, batch, a,
                                     s);
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
  const int vec = rows_vec(q, k, v, dout, batch, n, n_kv, heads, kv_heads, st);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 256)
    return launch_dkv_f32<256>(q, k, v, dout, lse, delta, dk, dv, batch, a,
                               vec, s);
  if (dtype == 0 && head_dim == 128)
    return launch_dkv_f32<128>(q, k, v, dout, lse, delta, dk, dv, batch, a,
                               vec, s);
  if (dtype == 0 && head_dim == 64)
    return launch_dkv_f32<64>(q, k, v, dout, lse, delta, dk, dv, batch, a,
                              vec, s);
  if (dtype == 1 && head_dim == 256)
    return tc::launch_dkv256<tc::bf16>(q, k, v, dout, lse, delta, dk, dv,
                                     batch, a, s);
  if (dtype == 1 && head_dim == 128)
    return tc::launch_dkv<128, tc::bf16>(q, k, v, dout, lse, delta, dk, dv,
                                         batch, a, s);
  if (dtype == 1 && head_dim == 64)
    return tc::launch_dkv<64, tc::bf16>(q, k, v, dout, lse, delta, dk, dv,
                                        batch, a, s);
  if (dtype == 3 && head_dim == 256)
    return tc::launch_dkv256<__half>(q, k, v, dout, lse, delta, dk, dv,
                                   batch, a, s);
  if (dtype == 3 && head_dim == 128)
    return tc::launch_dkv<128, __half>(q, k, v, dout, lse, delta, dk, dv,
                                       batch, a, s);
  if (dtype == 3 && head_dim == 64)
    return tc::launch_dkv<64, __half>(q, k, v, dout, lse, delta, dk, dv,
                                      batch, a, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
