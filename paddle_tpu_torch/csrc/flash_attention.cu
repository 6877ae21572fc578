// Flash attention forward for Hopper (sm_90a): bf16 on the tensor cores
// through wgmma with TMA loads; float32 on the CUDA cores.
//
// Replaces: paddle_tpu/kernels/flash_attention.py, _flash_fwd_bhnd ->
// _fa_kernel (the pallas_call at line 161): blocked online-softmax attention
// that never writes the [N, N] score matrix to device memory, start-aligned
// causal mask (query i sees keys j <= i, for any kv length), emitting O and
// the per-row natural-log log-sum-exp the backward needs. With segment ids
// (packed variable-length sequences, the reference's `segmented` mode, mask
// at lines 104-106), a query also needs the key's id to equal its own.
//
// What bounds it on this card: per causal (query, key) pair and head two
// products of 2*D operations (S = Q.K^T, P.V) against ~4*N*D elements moved
// per head, far above the card's operations-per-byte line at the training
// and prefill shapes: bound by arithmetic, on the bf16 tensor cores (989
// TFLOP/s) for bf16 and on the fp32 CUDA cores (67 TFLOP/s) for float32,
// which stays off TF32 to match the reference's 'highest' matmuls.
//
// Both designs:
//  * exp2 with scale * log2(e) folded into one multiply; the running max
//    lives in the log2 domain and the LSE is converted back on its way out:
//    lse = (m2 + log2 l) * ln 2;
//  * masked scores take the reference's finite NEG_INF (-1e30, in the log2
//    domain too): a key tile that a row sees none of gives that row p = 1 on
//    every masked column, which the next visible tile's rescale alpha =
//    exp2(-1e30 - m) erases, as in the reference. Every row sees key 0 or
//    itself, so no row ends with l = 0;
//  * one CTA per (batch*head, query tile), heaviest (last) query tile
//    first: the tile is the grid's slow axis (blockIdx.y), so the card
//    hands out every head's last tile before any head's next one (with
//    the tile as the fast axis, whole heads go in turn and the heavy tiles
//    of the last heads run at the end, on a few SMs); K/V tiles of 64 keys
//    stream up to the causal edge;
//  * GQA: query head h reads kv head h / (H / H_kv); K/V are never repeated;
//  * segment ids ([B, N] int32, nullptr = off): a key tile whose id interval
//    [min, max] meets none of the CTA's rows is skipped whole (for any order
//    of the ids: disjoint intervals mean no equal pair). Skipping it gives
//    the same bits as masking it: a masked tile adds exact zeros after a
//    visible one and is erased before one. Every warp computes the
//    intervals itself, so the CTA agrees without a barrier.
//
// bf16 (namespace tc; building blocks in wgmma_bf16.cuh, the same as the
// backward's dq kernel):
//  * three warpgroups: two consumers of 64 query rows each (the wgmma M) and
//    a producer whose first warp issues TMA loads; setmaxnreg moves
//    registers from the producer (24) to the consumers (240);
//  * Q's 128 rows load once (two 64-row boxes per 64 columns of D); K and V
//    tiles and their segment ids stream through a ring of STAGES buffers
//    guarded by mbarriers (full: the producer warp's 32 arrivals plus the
//    tiles' bytes; empty: one arrival per consumer warp). Rank-4 tensor maps
//    over the caller's strides: no fold copy, rows past N or N_kv arrive as
//    zeros (the wrapper copies an operand TMA cannot read in place);
//  * S = Q.K^T is an ss product, both operands K-major (probe form 4), into
//    32 fp32 accumulators a thread; the masks and the online softmax work
//    on the accumulator fragments (a row's max over the 4 lanes that share
//    it; each lane keeps a partial row sum, reduced once at the end);
//  * p = exp2(s - m) is rounded to bf16 unnormalised, where the reference
//    rounds it (p.astype(v.dtype)), packed into A fragments, and O += P.V
//    runs as an rs product with V read MN-major (probe form 6), m64n128 at
//    D = 128. O is rescaled by alpha only after the previous P.V was waited
//    on;
//  * the producer and both consumers walk one tile sequence (the causal
//    bound min(N_kv, q0 + 128) and the CTA-wide id intervals); a consumer
//    warpgroup that a tile cannot reach (past its own 64-row causal edge,
//    past N, or no equal ids) still takes it and hands it back without
//    computing, so no side waits for a tile the other skipped;
//  * O = acc / max(l, 1e-30) goes out as bf16 from the fragments; rows >= N
//    are not written.
//  * D = 256 (a Llama at Gemma-2B's widths): Q's 128 rows take 64 KB and a
//    K/V stage 64 KB, so the ring has 2 stages instead of 3 (192 KB of the
//    227 KB a block may have); O is one m64n256 accumulator, 128 fp32
//    registers beside S's 32 and P's 16 fragments, within the consumers'
//    240. chip_smoke.py phase 2 prints ptxas's registers and spills.
//
// float16 (the same kernel with T = __half): the reference's `_dot`
// (paddle_tpu/kernels/flash_attention.py:47-65) takes two float16 operands
// and sums in float32, so the float16 mode is the bf16 design with
// `wgmma ... .f32.f16.f16`, float16 tensor maps and fragments, the same
// float32 statistics and the same rounding points (p rounded to float16
// before P.V, O once at the end). Nothing is clamped: a value past
// float16's range rounds to inf, where the plain version's cast does. The
// type is a template parameter; Args and the bf16 instantiation are
// unchanged.
//
// float32 (CUDA cores, TF32 off):
//  * 256 threads as 16 x 16; with 128-row query tiles thread (ty, tx)
//    owns query rows ty + 16 i (i < 8) and, per key tile, keys tx + 16 j
//    (j < 4): an 8 x 4 block of S (each 16-byte shared load of Q feeds 16
//    FMAs, of K 32) and an 8 x D/16 block of O (per key, 2 loads of P and
//    D/64 of V feed 8 * D/16 FMAs). A grid of 128-row tiles that leaves
//    SMs idle (a short prefill: B = 1, N <= 1024 at 16 heads) takes 64-row
//    tiles instead, 4 rows a thread;
//  * Q, K and V stay row-major as they come from memory, copied with
//    cp.async in 16-byte chunks (4-byte copies for an operand that is not
//    16-byte aligned); Q's and K's chunks are XOR-swizzled by row % 8, so a
//    quarter warp reading 8 consecutive rows hits 8 bank groups; the K/V
//    tiles are double-buffered, tile j + 1 loading while tile j computes;
//  * P goes through shared memory once, transposed and swizzled, behind one
//    barrier; the row max is a shuffle over the 16 lanes that share a row,
//    and the row sum is kept per lane and reduced at the end;
//  * inputs are read through their [B, N, H, D] strides, and the ragged
//    edge (N or N_kv not a multiple of the tile) is zero-filled and masked
//    in-kernel;
//  * D = 256: 64-row query tiles (4 x D/16 = 64 accumulators a thread)
//    and one K/V buffer, 208 KB: a second buffer would be 272 KB, so the
//    next tile loads after this one's P.V, behind a barrier.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "f32_tiles.cuh"
#include "segment_ids.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int BN = 64;          // keys per streamed tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Args {
  int n, n_kv, heads, kv_heads;
  long long sqb, sqn, sqh, skb, skn, skh, svb, svn, svh;
  float scale;
  int causal;
  const int32_t* segs;   // [B, N] or nullptr
  int vec;               // float32: every row start is 16-byte aligned
};

using ptseg::id_range;
using ptseg::ranges_meet;
static_assert(BN == 64, "id_range's default run of 64 rows is one key tile");

// -- float32: CUDA cores ----------------------------------------------------

constexpr int THREADS = 256;    // 16 x 16
constexpr int RN = BN / 16;     // keys per thread

using ptf32::cp_async_commit;
using ptf32::cp_async_wait_all;
using ptf32::load_rows;
using ptseg::next_tile;

// BM query rows per CTA (64 or 128), BM / 16 per thread; STAGES K/V
// buffers: 2 (tile j + 1 lands while tile j computes) or 1 (D = 256, where
// two do not fit: the next tile loads after this one's P.V)
template <int D, int BM, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Args a) {
  constexpr int RM = BM / 16;   // query rows per thread
  constexpr int NC = D / 16;    // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [BM][D], swizzled
  float* ks = qs + BM * D;                  // [STAGES][BN][D], swizzled
  float* vs = ks + STAGES * BN * D;         // [STAGES][BN][D]
  float* pt = vs + STAGES * BN * D;         // [BN][BM] P^T, swizzled

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;   // heaviest first
  const int bh = blockIdx.x;
  const int b = bh / a.heads, h = bh % a.heads;
  const int kvh = h / (a.heads / a.kv_heads);
  const float* qb = q + b * a.sqb + h * a.sqh;
  const float* kb = k + b * a.skb + kvh * a.skh;
  const float* vb = v + b * a.svb + kvh * a.svh;
  const int32_t* sb = a.segs != nullptr ? a.segs + int64_t(b) * a.n : nullptr;
  const float scale2 = a.scale * LOG2E;

  int seg_q[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    seg_q[i] = sb != nullptr && row < a.n ? sb[row] : 0;
  }
  const int2 q_ids =
      sb != nullptr ? id_range(sb, q0, a.n, BM) : make_int2(0, 0);
  const int kv_end = a.causal ? min(a.n_kv, q0 + BM) : a.n_kv;

  float acc[RM][NC], m_i[RM], l_i[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  load_rows<D, true, THREADS>(qs, qb, a.sqn, q0, BM, a.n, a.vec);
  int k0 = next_tile<BN>(0, kv_end, sb, a.n_kv, q_ids);
  if (k0 < kv_end) {
    load_rows<D, true, THREADS>(ks, kb, a.skn, k0, BN, a.n_kv, a.vec);
    load_rows<D, false, THREADS>(vs, vb, a.svn, k0, BN, a.n_kv, a.vec);
  }
  cp_async_commit();
  // the swizzle of this thread's rows: (ty + 16 i) % 8 and (tx + 16 j) % 8
  const int qsw = ty & 7, ksw = tx & 7;
  for (int stage = 0; k0 < kv_end; stage = (stage + 1) % STAGES) {
    cp_async_wait_all();
    // tile k0 has landed for every thread, and every thread is done with
    // the previous tile's P.V: its buffers and P^T are free
    __syncthreads();
    const int k1 = next_tile<BN>(k0 + BN, kv_end, sb, a.n_kv, q_ids);
    if (STAGES == 2) {
      if (k1 < kv_end) {
        load_rows<D, true, THREADS>(ks + (stage ^ 1) * BN * D, kb, a.skn,
                                    k1, BN, a.n_kv, a.vec);
        load_rows<D, false, THREADS>(vs + (stage ^ 1) * BN * D, vb, a.svn,
                                     k1, BN, a.n_kv, a.vec);
      }
      cp_async_commit();
    }

    const float* kt = ks + stage * BN * D;
    float s[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D / 4; ++c) {
      float4 qa[RM], kc[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qa[i] = *reinterpret_cast<const float4*>(
            qs + (ty + 16 * i) * D + ((c ^ qsw) << 2));
#pragma unroll
      for (int j = 0; j < RN; ++j)
        kc[j] = *reinterpret_cast<const float4*>(
            kt + (tx + 16 * j) * D + ((c ^ ksw) << 2));
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          float t = fmaf(qa[i].x, kc[j].x, s[i][j]);
          t = fmaf(qa[i].y, kc[j].y, t);
          t = fmaf(qa[i].z, kc[j].z, t);
          s[i][j] = fmaf(qa[i].w, kc[j].w, t);
        }
    }

    int seg_k[RN];
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int col = k0 + tx + 16 * j;
      seg_k[j] = sb != nullptr && col < a.n_kv ? sb[col] : 0;
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool ok = col < a.n_kv && (!a.causal || col <= row) &&
                        seg_q[i] == seg_k[j];
        s[i][j] = ok ? s[i][j] * scale2 : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = exp2f(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        sum += s[i][j];
      }
      l_i[i] = alpha * l_i[i] + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    // P^T[key][slot]: this thread's rows sit at slots ty * RM + i, so its
    // RM values of one key are RM / 4 16-byte chunks (swizzled by key % 8)
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      float* prow = pt + (tx + 16 * j) * BM;
#pragma unroll
      for (int u = 0; u < RM / 4; ++u)
        *reinterpret_cast<float4*>(
            prow + ((((RM / 4) * ty + u) ^ ksw) << 2)) =
            make_float4(s[4 * u][j], s[4 * u + 1][j], s[4 * u + 2][j],
                        s[4 * u + 3][j]);
    }
    __syncthreads();   // P^T is complete

    const float* vt = vs + stage * BN * D;
#pragma unroll 4
    for (int key = 0; key < BN; ++key) {
      const float* prow = pt + key * BM;
      float p[RM];
#pragma unroll
      for (int u = 0; u < RM / 4; ++u) {
        const float4 p4 = *reinterpret_cast<const float4*>(
            prow + ((((RM / 4) * ty + u) ^ (key & 7)) << 2));
        p[4 * u] = p4.x;
        p[4 * u + 1] = p4.y;
        p[4 * u + 2] = p4.z;
        p[4 * u + 3] = p4.w;
      }
#pragma unroll
      for (int g = 0; g < D / 64; ++g) {
        const float4 v4 =
            *reinterpret_cast<const float4*>(vt + key * D + g * 64 + tx * 4);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          acc[i][4 * g] = fmaf(p[i], v4.x, acc[i][4 * g]);
          acc[i][4 * g + 1] = fmaf(p[i], v4.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p[i], v4.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p[i], v4.w, acc[i][4 * g + 3]);
        }
      }
    }
    if (STAGES == 1) {
      __syncthreads();   // every thread is done with this tile's K and V
      if (k1 < kv_end) {
        load_rows<D, true, THREADS>(ks, kb, a.skn, k1, BN, a.n_kv, a.vec);
        load_rows<D, false, THREADS>(vs, vb, a.svn, k1, BN, a.n_kv, a.vec);
      }
      cp_async_commit();
    }
    k0 = k1;
  }
  cp_async_wait_all();

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float l = l_i[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    const int row = q0 + ty + 16 * i;
    if (row >= a.n) continue;
    l = fmaxf(l, 1e-30f);
    float* orow = o + ((int64_t(b) * a.n + row) * a.heads + h) * D;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
      *reinterpret_cast<float4*>(orow + g * 64 + tx * 4) =
          make_float4(acc[i][4 * g] / l, acc[i][4 * g + 1] / l,
                      acc[i][4 * g + 2] / l, acc[i][4 * g + 3] / l);
    if (tx == 0) lse[int64_t(bh) * a.n + row] = (m_i[i] + log2f(l)) * LN2;
  }
}

template <int D, int BM, int STAGES = 2>
cudaError_t launch_f32_tiles(const void* q, const void* k, const void* v,
                             void* o, void* lse, int batch, const Args& a,
                             cudaStream_t stream) {
  const size_t smem =
      size_t(BM * D + 2 * STAGES * BN * D + BN * BM) * sizeof(float);
  auto kernel = flash_fwd_f32_kernel<D, BM, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.heads, (a.n + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), a);
  return cudaGetLastError();
}

// 128-row query tiles, or 64-row ones for a grid that leaves SMs idle,
// at a 4 x 4 block of S a thread (ptf32::query_tile_rows). D = 256: 64-row
// tiles and one K/V buffer, 208 KB (a second buffer or 128 rows would be
// 272 or 336 KB, past the 227 KB a block may have)
template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* lse, int batch, const Args& a,
                       cudaStream_t stream) {
  if constexpr (D > 128) {
    return launch_f32_tiles<D, 64, 1>(q, k, v, o, lse, batch, a, stream);
  } else {
    int rows = 0;
    const cudaError_t err =
        ptf32::query_tile_rows((long long)batch * a.heads, a.n, &rows);
    if (err != cudaSuccess) return err;
    if (rows == 128)
      return launch_f32_tiles<D, 128>(q, k, v, o, lse, batch, a, stream);
    return launch_f32_tiles<D, 64>(q, k, v, o, lse, batch, a, stream);
  }
}

// -- bf16: wgmma + TMA ------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int ROWS = 64;                    // wgmma M, and a streamed tile
constexpr int CONSUMERS = 2;                // consumer warpgroups per CTA
constexpr int CTA_ROWS = CONSUMERS * ROWS;  // query rows of a CTA
constexpr int THREADS = (CONSUMERS + 1) * 128;
// ring of streamed K/V tiles: 3, or 2 at D = 256, where Q (64 KB) and
// three 64 KB K/V stages would pass the 227 KB a block may have
template <int D>
constexpr int STAGES = D > 128 ? 2 : 3;
constexpr int BOX = ROWS * 64;              // elements of one 64 x 64 box
constexpr uint32_t BOX_BYTES = BOX * 2;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
static_assert(ROWS == BN, "a streamed tile is one key tile");

template <int D, typename T>
struct Smem {
  static constexpr int ST = STAGES<D>;
  T q[CONSUMERS][D / 64][BOX];   // each consumer's 64 query rows
  T k[ST][D / 64][BOX];          // streamed key tiles
  T v[ST][D / 64][BOX];
  int32_t seg[ST][ROWS];            // the key tile's segment ids
  uint64_t full[ST], empty[ST], loaded;
};

template <int D, typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       T* __restrict__ o, float* __restrict__ lse,
                       Args a) {
  using namespace ptwg;
  Smem<D, T>& s = aligned_smem<Smem<D, T>>();
  constexpr int ST = Smem<D, T>::ST;
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * CTA_ROWS;   // heaviest first
  const int bh = blockIdx.x;
  const int b = bh / a.heads, h = bh % a.heads;
  const int kvh = h / (a.heads / a.kv_heads);
  const int32_t* sb = a.segs != nullptr ? a.segs + int64_t(b) * a.n : nullptr;
  const int kv_end = a.causal ? min(a.n_kv, q0 + CTA_ROWS) : a.n_kv;
  if (threadIdx.x == 0) {
    for (int i = 0; i < ST; ++i) {
      bar_init(&s.full[i], 32);               // the producer warp
      bar_init(&s.empty[i], CONSUMERS * 4);   // every consumer warp
    }
    bar_init(&s.loaded, 1);
    bar_init_fence();
  }
  __syncthreads();
  const int2 q_ids =
      sb != nullptr ? id_range(sb, q0, a.n, CTA_ROWS) : make_int2(0, 0);

  if (wg == CONSUMERS) {   // producer warpgroup: one warp issues the TMA
    regs_dealloc<PRODUCER_REGS>();
    if (warp != CONSUMERS * 4) return;
    if (lane == 0) {
      bar_arrive_tx(&s.loaded, CONSUMERS * (D / 64) * BOX_BYTES);
      for (int c = 0; c < CONSUMERS; ++c)
        for (int j = 0; j < D / 64; ++j)
          tma_load(s.q[c][j], &tq, &s.loaded, j * 64, h, q0 + c * ROWS, b);
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
  } else {   // consumer warpgroup wg: query rows wq0 .. wq0 + 63
    regs_alloc<CONSUMER_REGS>();
    const int wq0 = q0 + wg * ROWS;
    const int r0 = wq0 + (warp & 3) * 16 + (lane >> 2);
    const float scale2 = a.scale * LOG2E;
    float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
    int seg_r[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = r0 + 8 * hi;
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
      // warpgroup-uniform: rows past N, tiles past this warpgroup's causal
      // edge and tiles of other documents would add nothing
      if (mine && wq0 < a.n && (!a.causal || k0 < wq0 + ROWS)) {
        float sa[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)   // S = Q . K^T
          wgmma_ss<0, 0, T>(sa, desc_kslice(s.q[wg][0], kk, BOX_BYTES),
                            desc_kslice(s.k[stage][0], kk, BOX_BYTES),
                            kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sa);
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hi = (i >> 1) & 1, row = r0 + 8 * hi;
          const int c = acc_col(i, lane), col = k0 + c;
          const bool ok = col < a.n_kv && (!a.causal || col <= row) &&
                          (sb == nullptr || seg_r[hi] == s.seg[stage][c]);
          sa[i] = ok ? sa[i] * scale2 : NEG_INF;
          mx[hi] = fmaxf(mx[hi], sa[i]);
        }
        float alpha[2];
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {   // the 4 lanes sharing a row
          mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
          mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
          const float m_new = fmaxf(m_r[hi], mx[hi]);
          alpha[hi] = exp2f(m_r[hi] - m_new);
          m_r[hi] = m_new;
          l_r[hi] *= alpha[hi];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {   // p, unnormalised
          const int hi = (i >> 1) & 1;
          sa[i] = exp2f(sa[i] - m_r[hi]);
          l_r[hi] += sa[i];
        }
        uint32_t pf[4][4];   // p rounded to the operand type
        acc_to_frag<T>(pf, sa);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)   // O += P . V, V read MN-major
          wgmma_rs<1, T>(acc, pf[kk],
                         desc_mnmajor(s.v[stage][0], BOX_BYTES) + kk * 128,
                         1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&s.empty[stage]);
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float l = l_r[hi];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l = fmaxf(l, 1e-30f);
      const int row = r0 + 8 * hi;
      if (row >= a.n) continue;
      T* out = o + ((int64_t(b) * a.n + row) * a.heads + h) * D;
#pragma unroll
      for (int i = 2 * hi; i < D / 2; i += 4)
        store2(out + acc_col(i, lane), acc[i] / l, acc[i + 1] / l);
      if ((lane & 3) == 0)
        lse[int64_t(bh) * a.n + row] = (m_r[hi] + log2f(l)) * LN2;
    }
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, const Args& a, cudaStream_t stream) {
  CUtensorMap m[3];
  cudaError_t err;
  if ((err = ptwg::tile_map(&m[0], q, D, a.heads, a.n, batch, a.sqh, a.sqn,
                            a.sqb, ROWS, ptwg::tma_type<T>)) != cudaSuccess ||
      (err = ptwg::tile_map(&m[1], k, D, a.kv_heads, a.n_kv, batch, a.skh,
                            a.skn, a.skb, ROWS, ptwg::tma_type<T>)) !=
          cudaSuccess ||
      (err = ptwg::tile_map(&m[2], v, D, a.kv_heads, a.n_kv, batch, a.svh,
                            a.svn, a.svb, ROWS, ptwg::tma_type<T>)) !=
          cudaSuccess)
    return err;
  const size_t smem = sizeof(Smem<D, T>) + 1024;
  auto kernel = flash_fwd_wgmma_kernel<D, T>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.heads, (a.n + CTA_ROWS - 1) / CTA_ROWS);
  kernel<<<grid, THREADS, smem, stream>>>(m[0], m[1], m[2],
                                          static_cast<T*>(o),
                                          static_cast<float*>(lse), a);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q [B, N, H, D], k/v [B, N_kv, H_kv, D] with the given element strides for
// the first three axes (the last is contiguous; bf16 needs the addresses
// and strides in multiples of 16 bytes, as TMA reads them); o [B, N, H, D]
// contiguous; lse [B*H, N] float32. dtype: 0 = float32, 1 = bfloat16,
// 3 = float16 (kernels/flash_attention.py DTYPE_CODES).
// segs: [B, N] int32 segment ids (needs n == n_kv), or nullptr for none.
// Returns the launch's cudaError_t.
int pt_flash_attention_fwd(const void* q, const void* k, const void* v,
                           void* o, void* lse, int batch, int n, int n_kv,
                           int heads, int kv_heads, int head_dim,
                           long long sqb, long long sqn, long long sqh,
                           long long skb, long long skn, long long skh,
                           long long svb, long long svn, long long svh,
                           float scale, int causal, int dtype,
                           const void* segs, void* stream) {
  if (segs != nullptr && n != n_kv) return cudaErrorInvalidValue;
  using ptf32::rows_aligned;
  const int vec = rows_aligned(q, batch, sqb, n, sqn, heads, sqh) &&
                  rows_aligned(k, batch, skb, n_kv, skn, kv_heads, skh) &&
                  rows_aligned(v, batch, svb, n_kv, svn, kv_heads, svh);
  const Args a{n,     n_kv, heads, kv_heads, sqb,   sqn,
               sqh,   skb,  skn,   skh,      svb,   svn,
               svh,   scale, causal, static_cast<const int32_t*>(segs), vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 256)
    return launch_f32<256>(q, k, v, o, lse, batch, a, s);
  if (dtype == 0 && head_dim == 128)
    return launch_f32<128>(q, k, v, o, lse, batch, a, s);
  if (dtype == 0 && head_dim == 64)
    return launch_f32<64>(q, k, v, o, lse, batch, a, s);
  if (dtype == 1 && head_dim == 256)
    return tc::launch<256, tc::bf16>(q, k, v, o, lse, batch, a, s);
  if (dtype == 1 && head_dim == 128)
    return tc::launch<128, tc::bf16>(q, k, v, o, lse, batch, a, s);
  if (dtype == 1 && head_dim == 64)
    return tc::launch<64, tc::bf16>(q, k, v, o, lse, batch, a, s);
  if (dtype == 3 && head_dim == 256)
    return tc::launch<256, __half>(q, k, v, o, lse, batch, a, s);
  if (dtype == 3 && head_dim == 128)
    return tc::launch<128, __half>(q, k, v, o, lse, batch, a, s);
  if (dtype == 3 && head_dim == 64)
    return tc::launch<64, __half>(q, k, v, o, lse, batch, a, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
