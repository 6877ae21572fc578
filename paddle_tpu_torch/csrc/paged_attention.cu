// Paged attention for Hopper (sm_90a): queries over a history that lives
// scattered across fixed-size pool pages [NB, bs, Hkv, D], in float32,
// bfloat16, float16 or int8 (with fp32 scale planes [NB, bs, Hkv]).
//
// Replaces paddle_tpu/serving/kernels/paged_attention.py:
//  * paged_attention_kernel -> _pa_kernel (the pallas_call at line 167):
//    one query token per slot, GQA folded as [Hkv, rep, D], pages at or
//    past the slot's length skipped, exact zeros for idle slots (length 0);
//  * mixed_paged_attention_kernel -> _mixed_kernel (the pallas_call at line
//    345): ragged [S, C] query rows, row s holding q_lens[s] new tokens at
//    positions hist..hist+q_len-1, causal rule key position <= hist + ci,
//    exact zeros for rows past q_len. It carries chunked prefill (C = the
//    chunk, decode rows q_len 1) and the prefix-cache suffix prefill
//    (S = 1, C = the bucket).
// Both in every pool mode: fp32, bf16 and float16 pages, and int8 pages
// multiplied by their per-vector scale after they arrive in shared memory,
// exactly as dequantize_int8_block does (q * scale in fp32, one rounding).
// The query and the output take fp32, bf16 or float16 (the reference's
// kernels upcast q and pages to fp32, paged_attention.py:90-111, 256-282,
// and write the output in q's dtype): every element is widened to fp32 as
// it is read, the softmax and both products run in fp32, and only the
// output is rounded, once, to q's type. float16 is the bf16 code with
// other element types (to_f32, store, ld4 and ld2 overloads).
// A slot's rep*C query rows of one kv head are flattened chunk-index-major
// (row j = ci * rep + r) and cut into tiles; valid rows (ci < q_len) are a
// prefix of the tile.
//
// What bounds them on this card:
//  * the decode step and the decode-heavy mixed step read every history
//    byte once and do 2 * rep multiply-adds per element: bound by bytes.
//    The old design was bound by latency instead: one CTA walked a slot's
//    whole history alone (128 pages in a row for a 2048-token slot while
//    the short slots' CTAs sat idle) with one page in flight and four
//    barriers a page;
//  * the long suffix prefill does 4 * D operations per visible (query, key)
//    pair and head for ~2 bytes: bound by the fp32 CUDA-core rate.
//
// The design against that:
//  * Split histories. Each slot's pages are cut into splits of
//    `split_pages` pages (the wrapper's split_plan, from shapes only: no
//    length is read on the host); one CTA per (split, kv head, row tile,
//    slot). A split past its tile's causal horizon exits at once. With one
//    split the kernel writes the output; with more it writes fp32 partials
//    (unnormalised O, running max m in the log2 domain, sum l) and a
//    combine kernel merges each valid row's live splits (weights
//    exp2(m_i - m)), counting them from the row's own horizon. A row that
//    sees no key of a split (a later split of a tile wholly past an early
//    row's horizon) keeps l = 0, weight 0: masked keys get p = 0
//    explicitly, never exp(NEG_INF - NEG_INF). No atomics: two launches on
//    the same inputs give the same bits.
//  * Rows kernels (decode: 8-row tiles; the mixed step with fewer than 64
//    rows a slot and head: 16-row tiles), 128 threads: K/V pages arrive by
//    cp.async 16-byte copies into a ring of NST page stages, NST - 1 pages
//    in flight while one is computed, one barrier a page. Each warp owns
//    4 keys of each page and its own online softmax over them (max and sum
//    over the warp by shuffles), so no per-page barrier guards the
//    softmax; the 4 warps' states merge once at the end. The walk is
//    picked by the tile's valid rows: up to 4 (decode rows), 8 lanes a key
//    reduce a dot; 5 to 16 (prompt chunks), Q sits in registers (a lane
//    owns D/32 dims of every row) and one reduce-scatter over the warp
//    sums all 4 x 16 partial dots of a pass, so a K element is loaded
//    once for all the rows. What still holds the 16-row walk back is its
//    instruction count: about half of it is shuffles and selects.
//  * Tiles kernel (a mixed step with 64 rows or more a slot and head, the
//    suffix prefill): the register-blocked design of the fp32 flash forward
//    (flash_fwd_f32_kernel in flash_attention.cu): 64-row query tiles, or
//    128 from 512 rows, 256 threads as 16 x 16, a BM/16 x 4 block of S and
//    a BM/16 x D/16 block of O a thread, P through shared memory once;
//    64-key tiles gathered from the block table's pages by cp.async in
//    4-element chunks, double-buffered, K and Q XOR-swizzled; the row tile
//    on blockIdx.y, heaviest first. bf16 and int8 pools stay in their own
//    type in shared memory and are widened (and scaled) as they are read.
//    No tensor cores: TF32 stays off for parity with the reference's
//    'highest' matmuls. What holds it back: like the flash forward's fp32
//    loop, about half the fp32 peak (shared-memory load issue at 8 warps
//    an SM), and at the suffix prefill the causal spread of work over 128
//    CTAs, which two history splits even out in part.
//  * D = 256 (a Llama at Gemma-2B's widths): a 16-token fp32 page of one
//    kv head's K and V is 32 KB, so the rows kernels' ring takes 2 stages
//    where a stage passes 16 KB (NST); the mixed rows kernel takes 8-row
//    tiles (16 rows would hold 2 x 16 x 8 Q and O registers a lane) and
//    the decode kernel 2 CTAs an SM (the split plan counts the same); the
//    tiles kernel takes 64-row tiles only, with one K/V buffer where two do
//    not fit (fp32 pools: 208 KB with one). A lane's 8 dims load as two
//    4-element vectors (ldv<8>).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t MAX_SMEM = 232448;   // 227 KB, a block's opt-in limit

template <typename T>
constexpr bool kInt8 = std::is_same<T, int8_t>::value;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// rounds to nearest even; past 65504 the value is inf, never clamped
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half_rn(x);
}

// 4 (or 2) consecutive elements widened to fp32; p aligned to their size
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 ld4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 ld4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(c.x, c.y, c.z, c.w);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 ld2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
__device__ __forceinline__ float2 ld2(const int8_t* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(c.x, c.y);
}
template <int VW, typename T>
__device__ __forceinline__ void ldv(const T* p, float* x) {
  static_assert(VW == 8 || VW == 4 || VW == 2, "8, 4 or 2 elements");
  if constexpr (VW == 8) {   // D = 256: a lane's 8 dims
    ldv<4>(p, x);
    ldv<4>(p + 4, x + 4);
  } else if constexpr (VW == 4) {
    const float4 v = ld4(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    const float2 v = ld2(p);
    x[0] = v.x;
    x[1] = v.y;
  }
}
__device__ __forceinline__ float4 scaled(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

// -- cp.async ------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// BYTES from src to dst, or zeros when !ok (src must still be a valid
// address)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(ok ? BYTES : 0)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- arguments and rows ----------------------------------------------------------

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;   // int8 pools only
  const float* v_scale;
  const int* block_tables;
  const int* lens;        // decode: seq_lens; mixed: hist_lens
  const int* q_lens;      // mixed only
  void* out;
  float* part_o;          // [S*C*H][splits][D] (splits > 1)
  float* part_m;          // [S*C*H][splits], log2 domain
  float* part_l;          // [S*C*H][splits]
  int slots, chunk, heads, kv_heads, block_size, max_blocks;
  int tiles, split_pages, splits;
  float scale2;           // scale * log2(e)
};

struct SlotRows {
  int hist, q_len;
};

// decode: one row (ci = 0) that sees keys 0 .. len - 1, none when idle
template <bool DECODE>
__device__ __forceinline__ SlotRows slot_rows(const Args& a, int slot) {
  if constexpr (DECODE) {
    const int len = a.lens[slot];
    return {len - 1, len > 0 ? 1 : 0};
  } else {
    return {a.lens[slot], a.q_lens[slot]};
  }
}

// row j (= ci * rep + r) of (slot, kv head) -> its [S, C, H] row index
__device__ __forceinline__ int64_t out_row(const Args& a, int slot, int kvh,
                                           int rep, int j) {
  return (int64_t(slot) * a.chunk + j / rep) * a.heads + kvh * rep + j % rep;
}

// -- rows kernels: decode and the short mixed step ------------------------------

constexpr int RT = 128;              // threads
constexpr int RWARPS = RT / 32;
constexpr int TPW = 4;               // keys per warp and pass, 8 lanes each
constexpr int DECODE_ROWS = 8;       // query rows per tile
// Page ring stages: 4, or 2 where a page of one kv head's K and V passes 16
// KB at 16-token pages (fp32 at D = 256: 32 KB a stage), so that the ring
// stays at 64 KB and two or three CTAs share an SM.
template <typename TKV, int D>
constexpr int NST = D * sizeof(TKV) > 512 ? 2 : 4;
// Query rows a tile of the mixed rows kernel: 16, or 8 at D = 256, where
// the 16-row walk's Q and O registers (2 x 16 x D / 32) would be 256.
template <int D>
constexpr int MIXED_ROWS = D > 128 ? 8 : 16;
// CTAs an SM of the decode kernel: 3, or 2 at D = 256 (its 8-row walk holds
// 2 x 8 x 8 Q and O registers beside the dots: ~190, over 3 CTAs' 170);
// serving/kernels/paged_attention.py's split plan counts the same
template <int D>
constexpr int DECODE_CTAS = D > 128 ? 2 : 3;

// one ring stage: K and V of one page of one kv head ([bs][D] each), then
// the int8 pools' scales ([bs] each)
template <typename TKV, int D>
__host__ __device__ size_t page_stage_bytes(int bs) {
  const size_t b = size_t(2) * bs * D * sizeof(TKV) +
                   (kInt8<TKV> ? size_t(2) * bs * sizeof(float) : 0);
  return (b + 15) / 16 * 16;
}

// the query tile, then the ring, which the 4 warps' merge reuses
template <typename TKV, int D, int R>
size_t rows_smem(int bs) {
  const size_t ring = NST<TKV, D> * page_stage_bytes<TKV, D>(bs);
  const size_t merge = size_t(RWARPS) * R * (D + 2) * sizeof(float);
  return size_t(R) * D * sizeof(float) + (ring > merge ? ring : merge);
}

// copy tokens [0, nt) of kv head kvh of pool page `page` into a stage
template <typename TKV, int D>
__device__ __forceinline__ void issue_page(const Args& a, int page, int nt,
                                           int kvh, char* stage) {
  constexpr int EPC = 16 / int(sizeof(TKV));   // elements per 16 bytes
  constexpr int CH = D / EPC;                  // 16-byte chunks per key
  const int bs = a.block_size;
  TKV* ks = reinterpret_cast<TKV*>(stage);
  TKV* vs = ks + bs * D;
  const TKV* kp = static_cast<const TKV*>(a.k_pool);
  const TKV* vp = static_cast<const TKV*>(a.v_pool);
  const int64_t vec0 = int64_t(page) * bs * a.kv_heads + kvh;  // (page, 0, kvh)
  for (int e = threadIdx.x; e < nt * CH; e += RT) {
    const int t = e / CH, c = e % CH;
    const int64_t src = (vec0 + int64_t(t) * a.kv_heads) * D + c * EPC;
    cp_async<16>(ks + t * D + c * EPC, kp + src, true);
    cp_async<16>(vs + t * D + c * EPC, vp + src, true);
  }
  if constexpr (kInt8<TKV>) {
    float* sc = reinterpret_cast<float*>(vs + bs * D);
    for (int t = threadIdx.x; t < nt; t += RT) {
      const int64_t vec = vec0 + int64_t(t) * a.kv_heads;
      cp_async<4>(sc + t, a.k_scale + vec, true);
      cp_async<4>(sc + bs + t, a.v_scale + vec, true);
    }
  }
}

// Merge the 4 warps' states of the tile's valid rows (in the ring:
// m [RWARPS][R], l [RWARPS][R], O [RWARPS][R][D]) and write the output,
// or with more than one split this split's partials.
template <typename TQ, int D, int R>
__device__ __forceinline__ void merge_rows(const Args& a, int slot, int kvh,
                                           int j0, int split, int n_valid,
                                           const char* ring) {
  const float* mw = reinterpret_cast<const float*>(ring);
  const float* lw = mw + RWARPS * R;
  const float* aw = lw + RWARPS * R;
  const int rep = a.heads / a.kv_heads;
  TQ* out = static_cast<TQ*>(a.out);
  for (int e = threadIdx.x; e < n_valid * D; e += RT) {
    const int r = e / D, d = e % D;
    float mx = NEG_INF;
    for (int w = 0; w < RWARPS; ++w) mx = fmaxf(mx, mw[w * R + r]);
    float lsum = 0.f, o = 0.f;
    for (int w = 0; w < RWARPS; ++w) {
      const float lv = lw[w * R + r];
      if (lv > 0.f) {   // a warp that saw no key of the row weighs 0
        const float wt = exp2f(mw[w * R + r] - mx);
        lsum = fmaf(wt, lv, lsum);
        o = fmaf(wt, aw[(w * R + r) * D + d], o);
      }
    }
    const int64_t row = out_row(a, slot, kvh, rep, j0 + r);
    if (a.splits == 1) {
      store(out + row * D + d, o / fmaxf(lsum, 1e-30f));
    } else {
      const int64_t pi = row * a.splits + split;
      a.part_o[pi * D + d] = o;
      if (d == 0) {
        a.part_m[pi] = mx;
        a.part_l[pi] = lsum;
      }
    }
  }
}

// The page walk and the merge of a tile's first RR rows (RR >= n_valid:
// rows n_valid .. RR - 1 run on zero queries and are not written). Every
// step loops over all RR rows, so the rows' shuffle chains interleave.
template <typename TQ, typename TKV, int D, int R, int RR, bool DECODE>
__device__ __forceinline__ void rows_walk(const Args& a, const SlotRows& sr,
                                          int split, int kvh, int slot,
                                          int j0, int n_valid, int k_end,
                                          int p_begin, int p_end,
                                          const float* qs, char* ring) {
  constexpr int VW = D / 32;   // P.V: output dims per lane
  constexpr int QC = D / 32;   // Q.K^T: 4-element chunks per lane, 8 a key
  constexpr int ST = NST<TKV, D>;   // page ring stages
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rep = a.heads / a.kv_heads, bs = a.block_size;
  const size_t stage = page_stage_bytes<TKV, D>(bs);
  const int* table = a.block_tables + int64_t(slot) * a.max_blocks;

  // this warp's online softmax over its keys: m and l (equal on every
  // lane), O's dims lane * VW ..; each row's last visible key
  float m[RR], l[RR], acc[RR][VW];
  int last[RR];
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
    last[r] = DECODE ? sr.hist : sr.hist + (j0 + r) / rep;
#pragma unroll
    for (int v = 0; v < VW; ++v) acc[r][v] = 0.f;
  }
  const int tl = lane >> 3, g = lane & 7;
  for (int p = p_begin; p < p_end; ++p) {
    const int i = p - p_begin;
    cp_async_wait<ST - 2>();
    __syncthreads();   // page p has landed for every thread, and every warp
                       // is done with page p - 1: its stage refills now
    {
      const int pn = p + ST - 1;
      if (pn < p_end)
        issue_page<TKV, D>(a, table[pn], min(bs, k_end - pn * bs), kvh,
                           ring + ((i + ST - 1) % ST) * stage);
      cp_async_commit();
    }
    const TKV* ks = reinterpret_cast<const TKV*>(ring + (i % ST) * stage);
    const TKV* vs = ks + bs * D;
    const float* sc = reinterpret_cast<const float*>(vs + bs * D);
    const int nt = min(bs, k_end - p * bs);
    for (int t0 = warp * TPW; t0 < nt; t0 += RWARPS * TPW) {
      // Q.K^T: key t on lanes 8 tl .. 8 tl + 7, chunks g, g + 8, ..
      const int t = t0 + tl;
      const bool tok = t < nt;
      float4 kc[QC];
      const float ksc = kInt8<TKV> && tok ? sc[t] : 1.f;
#pragma unroll
      for (int c = 0; c < QC; ++c) {
        kc[c] = tok ? ld4(ks + t * D + 4 * (g + 8 * c))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
        if constexpr (kInt8<TKV>) kc[c] = scaled(kc[c], ksc);
      }
      float x[RR], y[RR];
#pragma unroll
      for (int r = 0; r < RR; ++r) x[r] = 0.f;
#pragma unroll
      for (int c = 0; c < QC; ++c)
#pragma unroll
        for (int r = 0; r < RR; ++r) {
          const float4 qv = *reinterpret_cast<const float4*>(
              qs + r * D + 4 * (g + 8 * c));
          x[r] = fmaf(qv.x, kc[c].x, x[r]);
          x[r] = fmaf(qv.y, kc[c].y, x[r]);
          x[r] = fmaf(qv.z, kc[c].z, x[r]);
          x[r] = fmaf(qv.w, kc[c].w, x[r]);
        }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
#pragma unroll
        for (int r = 0; r < RR; ++r) x[r] += __shfl_xor_sync(FULL, x[r], off);
      // the warp's 4 keys: max and sum over lanes 8 apart
      const int key = p * bs + t;
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        x[r] = tok && key <= last[r] ? x[r] * a.scale2 : NEG_INF;
        y[r] = fmaxf(x[r], __shfl_xor_sync(FULL, x[r], 8));
      }
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        const float m_new =
            fmaxf(m[r], fmaxf(y[r], __shfl_xor_sync(FULL, y[r], 16)));
        // a masked key (x = NEG_INF) gets p = 0, even while m is NEG_INF
        x[r] = x[r] > NEG_INF ? exp2f(x[r] - m_new) : 0.f;
        y[r] = exp2f(m[r] - m_new);   // alpha
        m[r] = m_new;
      }
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        float sum = x[r] + __shfl_xor_sync(FULL, x[r], 8);
        sum += __shfl_xor_sync(FULL, sum, 16);
        l[r] = l[r] * y[r] + sum;
#pragma unroll
        for (int v = 0; v < VW; ++v) acc[r][v] *= y[r];
      }
      // P.V over the warp's keys; p of key t0 + k sits on lane 8 k
#pragma unroll
      for (int k = 0; k < TPW; ++k) {
        const int tv = t0 + k;
        if (tv < nt) {   // uniform over the warp
          float vv[VW];
          ldv<VW>(vs + tv * D + lane * VW, vv);
          if constexpr (kInt8<TKV>) {
            const float vsc = sc[bs + tv];
#pragma unroll
            for (int v = 0; v < VW; ++v) vv[v] *= vsc;
          }
#pragma unroll
          for (int r = 0; r < RR; ++r) {
            const float pk = __shfl_sync(FULL, x[r], 8 * k);
#pragma unroll
            for (int v = 0; v < VW; ++v)
              acc[r][v] = fmaf(pk, vv[v], acc[r][v]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it holds the warps' states now
  float* mw = reinterpret_cast<float*>(ring);   // [RWARPS][R]
  float* lw = mw + RWARPS * R;                  // [RWARPS][R]
  float* aw = lw + RWARPS * R;                  // [RWARPS][R][D]
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    if (r < n_valid) {
      if (lane == 0) {
        mw[warp * R + r] = m[r];
        lw[warp * R + r] = l[r];
      }
#pragma unroll
      for (int v = 0; v < VW; ++v)
        aw[(warp * R + r) * D + lane * VW + v] = acc[r][v];
    }
  }
  __syncthreads();
  merge_rows<TQ, D, R>(a, slot, kvh, j0, split, n_valid, ring);
}

// One step of a warp's reduce-scatter: keep half of the N values (the
// upper half on lanes with bit O set), add the partner lane's copy of it.
template <int N, int O>
__device__ __forceinline__ void scatter_step(float* v, bool upper) {
  constexpr int H = N / 2;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, O);
  }
}

// Sums N values over the warp's 32 lanes, N / 32 results a lane: lane L
// ends with the sums of values N / 32 * L .. N / 32 * L + N / 32 - 1 in
// v[0 ..]. 31 * N / 32 shuffles in all, against 5 * N for a full reduce.
template <int N>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  scatter_step<N, 16>(v, lane & 16);
  scatter_step<N / 2, 8>(v, lane & 8);
  scatter_step<N / 4, 4>(v, lane & 4);
  scatter_step<N / 8, 2>(v, lane & 2);
  scatter_step<N / 16, 1>(v, lane & 1);
}

// The page walk of a tile's first RR rows (8 or 16) with Q in registers:
// lane l owns dims l * VW .. of every row. For the warp's 4 keys of a pass
// each lane forms 4 x RR partial dots, a reduce-scatter leaves key
// lane / 8 and rows NV * (lane % 8) .. on each lane, the softmax runs on
// those (max and sum over lanes 8 apart), and p and the rescale go back
// to every lane by shuffles for P.V. Against rows_walk this trades RR
// shared loads of Q per key for 150 / 4 shuffles a key at RR = 16.
template <typename TQ, typename TKV, int D, int R, int RR, bool DECODE>
__device__ __forceinline__ void rows_walk_lanes(
    const Args& a, const SlotRows& sr, int split, int kvh, int slot, int j0,
    int n_valid, int k_end, int p_begin, int p_end, const float* qs,
    char* ring) {
  static_assert(RR == 8 || RR == 16, "8 or 16 rows");
  constexpr int VW = D / 32;        // dims per lane
  constexpr int ST = NST<TKV, D>;   // page ring stages
  constexpr int NV = RR / 8;        // rows a lane holds after the scatter
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rep = a.heads / a.kv_heads, bs = a.block_size;
  const size_t stage = page_stage_bytes<TKV, D>(bs);
  const int* table = a.block_tables + int64_t(slot) * a.max_blocks;

  float qr[RR][VW], acc[RR][VW];
#pragma unroll
  for (int r = 0; r < RR; ++r)
#pragma unroll
    for (int v = 0; v < VW; ++v) {
      qr[r][v] = qs[r * D + lane * VW + v];
      acc[r][v] = 0.f;
    }
  // the scatter leaves this lane key kl of each pass and rows rl + u
  const int kl = lane >> 3, rl = NV * (lane & 7);
  float m[NV], l[NV];
  int last[NV];   // each held row's last visible key
#pragma unroll
  for (int u = 0; u < NV; ++u) {
    m[u] = NEG_INF;
    l[u] = 0.f;
    last[u] = DECODE ? sr.hist : sr.hist + (j0 + rl + u) / rep;
  }
  for (int p = p_begin; p < p_end; ++p) {
    const int i = p - p_begin;
    cp_async_wait<ST - 2>();
    __syncthreads();   // page p has landed for every thread, and every warp
                       // is done with page p - 1: its stage refills now
    {
      const int pn = p + ST - 1;
      if (pn < p_end)
        issue_page<TKV, D>(a, table[pn], min(bs, k_end - pn * bs), kvh,
                           ring + ((i + ST - 1) % ST) * stage);
      cp_async_commit();
    }
    const TKV* ks = reinterpret_cast<const TKV*>(ring + (i % ST) * stage);
    const TKV* vs = ks + bs * D;
    const float* sc = reinterpret_cast<const float*>(vs + bs * D);
    const int nt = min(bs, k_end - p * bs);
    for (int t0 = warp * TPW; t0 < nt; t0 += RWARPS * TPW) {
      // partial dots of (key t0 + k, row r) at index k * RR + r
      float part[TPW * RR];
#pragma unroll
      for (int k = 0; k < TPW; ++k) {
        float kv[VW];
#pragma unroll
        for (int v = 0; v < VW; ++v) kv[v] = 0.f;
        if (t0 + k < nt) {   // uniform over the warp
          ldv<VW>(ks + (t0 + k) * D + lane * VW, kv);
          if constexpr (kInt8<TKV>) {
            const float ksc = sc[t0 + k];
#pragma unroll
            for (int v = 0; v < VW; ++v) kv[v] *= ksc;
          }
        }
#pragma unroll
        for (int r = 0; r < RR; ++r) {
          float x = 0.f;
#pragma unroll
          for (int v = 0; v < VW; ++v) x = fmaf(qr[r][v], kv[v], x);
          part[k * RR + r] = x;
        }
      }
      reduce_scatter<TPW * RR>(part, lane);
      // the softmax on the held (key, row) pairs; lanes 8 apart hold the
      // same rows for the pass's other keys
      const int key = p * bs + t0 + kl;
      float alpha[NV];
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const bool ok = t0 + kl < nt && key <= last[u];
        const float x = ok ? part[u] * a.scale2 : NEG_INF;
        float mx = fmaxf(x, __shfl_xor_sync(FULL, x, 8));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 16));
        const float m_new = fmaxf(m[u], mx);
        // a masked key gets p = 0, even while m is NEG_INF
        const float pr = ok ? exp2f(x - m_new) : 0.f;
        float sum = pr + __shfl_xor_sync(FULL, pr, 8);
        sum += __shfl_xor_sync(FULL, sum, 16);
        alpha[u] = exp2f(m[u] - m_new);
        l[u] = l[u] * alpha[u] + sum;
        m[u] = m_new;
        part[u] = pr;
      }
      // row r's rescale from lane r / NV, its p of key t0 + k from lane
      // 8 k + r / NV (slot r % NV)
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        const float al = __shfl_sync(FULL, alpha[r % NV], r / NV);
#pragma unroll
        for (int v = 0; v < VW; ++v) acc[r][v] *= al;
      }
#pragma unroll
      for (int k = 0; k < TPW; ++k) {
        const int tv = t0 + k;
        if (tv < nt) {   // uniform over the warp
          float vv[VW];
          ldv<VW>(vs + tv * D + lane * VW, vv);
          if constexpr (kInt8<TKV>) {
            const float vsc = sc[bs + tv];
#pragma unroll
            for (int v = 0; v < VW; ++v) vv[v] *= vsc;
          }
#pragma unroll
          for (int r = 0; r < RR; ++r) {
            const float pk = __shfl_sync(FULL, part[r % NV], 8 * k + r / NV);
#pragma unroll
            for (int v = 0; v < VW; ++v)
              acc[r][v] = fmaf(pk, vv[v], acc[r][v]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it holds the warps' states now
  float* mw = reinterpret_cast<float*>(ring);   // [RWARPS][R]
  float* lw = mw + RWARPS * R;                  // [RWARPS][R]
  float* aw = lw + RWARPS * R;                  // [RWARPS][R][D]
  if (kl == 0) {
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      mw[warp * R + rl + u] = m[u];
      lw[warp * R + rl + u] = l[u];
    }
  }
#pragma unroll
  for (int r = 0; r < RR; ++r)
#pragma unroll
    for (int v = 0; v < VW; ++v)
      aw[(warp * R + r) * D + lane * VW + v] = acc[r][v];
  __syncthreads();
  merge_rows<TQ, D, R>(a, slot, kvh, j0, split, n_valid, ring);
}

// R query rows of one (split, kv head, row tile, slot)
template <typename TQ, typename TKV, int D, int R, bool DECODE>
__device__ __forceinline__ void rows_body(const Args& a) {
  const int split = blockIdx.x, kvh = blockIdx.y;
  const int slot = blockIdx.z / a.tiles, tile = blockIdx.z % a.tiles;
  const int tid = threadIdx.x;
  const int rep = a.heads / a.kv_heads, bs = a.block_size;
  const SlotRows sr = slot_rows<DECODE>(a, slot);
  const int j0 = tile * R;
  const int n_rows = min(R, rep * a.chunk - j0);
  const int n_valid = max(0, min(n_rows, sr.q_len * rep - j0));
  if (a.splits == 1) {   // else the combine writes the invalid rows' zeros
    TQ* out = static_cast<TQ*>(a.out);
    for (int e = n_valid * D + tid; e < n_rows * D; e += RT)
      store(out + out_row(a, slot, kvh, rep, j0 + e / D) * D + e % D, 0.f);
  }
  if (n_valid == 0) return;
  // the tile's last visible key, and this split's keys up to it
  const int horizon = sr.hist + (j0 + n_valid - 1) / rep;
  const int span = a.split_pages * bs;
  const int k_begin = split * span;
  if (k_begin > horizon) return;
  const int k_end = min(min(k_begin + span, horizon + 1), a.max_blocks * bs);
  const int p_begin = split * a.split_pages;
  const int p_end = (k_end + bs - 1) / bs;

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [R][D]
  char* ring = reinterpret_cast<char*>(qs + R * D);
  const size_t stage = page_stage_bytes<TKV, D>(bs);
  const int* table = a.block_tables + int64_t(slot) * a.max_blocks;
  for (int i = 0; i < NST<TKV, D> - 1; ++i) {
    const int p = p_begin + i;
    if (p < p_end)
      issue_page<TKV, D>(a, table[p], min(bs, k_end - p * bs), kvh,
                         ring + i * stage);
    cp_async_commit();
  }
  const TQ* q = static_cast<const TQ*>(a.q);
  for (int e = tid; e < R * D; e += RT)
    qs[e] = e < n_valid * D
                ? to_f32(q[out_row(a, slot, kvh, rep, j0 + e / D) * D + e % D])
                : 0.f;
  __syncthreads();   // Q is staged (the 8- and 16-row walks load it now)
  // the smallest row count that holds the valid rows: 8 and 16 with Q in
  // registers and a reduce-scatter, 1 and 4 with a dot per 8 lanes
#define PT_WALK(WALK, RR)                                                  \
  WALK<TQ, TKV, D, R, RR, DECODE>(a, sr, split, kvh, slot, j0, n_valid,   \
                                  k_end, p_begin, p_end, qs, ring)
  if constexpr (R > 8) {
    if (n_valid > 8) return PT_WALK(rows_walk_lanes, 16);
  }
  if (n_valid > 4) return PT_WALK(rows_walk_lanes, 8);
  if (n_valid > 1) return PT_WALK(rows_walk, 4);
  PT_WALK(rows_walk, 1);
#undef PT_WALK
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(RT, DECODE_CTAS<D>)
paged_decode_kernel(const Args a) {
  rows_body<TQ, TKV, D, DECODE_ROWS, true>(a);
}

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(RT, 2) mixed_paged_kernel(const Args a) {
  rows_body<TQ, TKV, D, MIXED_ROWS<D>, false>(a);
}

// -- tiles kernel: the long mixed step and the suffix prefill ----------------

constexpr int TT = 256;        // threads, 16 x 16
constexpr int BN = 64;         // keys per streamed tile
constexpr int RN = BN / 16;    // keys per thread

// element offset of the 4-element chunk c of row r in a tile of D elements
// a row, chunks XOR-swizzled by r % 8 when SWZ
template <int D, bool SWZ>
__device__ __forceinline__ int chunk_at(int r, int c) {
  return r * D + ((SWZ ? c ^ (r & 7) : c) << 2);
}

// Q [BM][D] and P^T [BN][BM] in fp32, the int8 scales [ST][2][BN], then
// K and V [ST][BN][D] each in the pool's type, for ST stages
template <typename TKV, int D, int BM>
constexpr size_t tiles_smem(int st) {
  return (size_t(BM) * D + size_t(BN) * BM + (kInt8<TKV> ? 2 * st * BN : 0)) *
             sizeof(float) +
         size_t(2) * st * BN * D * sizeof(TKV);
}
// K/V stages of the tiles kernel: 2 (tile j + 1 lands while tile j
// computes), or 1 where two do not fit (fp32 pools at D = 256: 208 KB with
// one, 336 KB with two)
template <typename TKV, int D, int BM>
constexpr int TILE_STAGES = tiles_smem<TKV, D, BM>(2) <= MAX_SMEM ? 2 : 1;

// keys [k0, k0 + BN) of kv head kvh, gathered through the block table in
// 4-element chunks (swizzled by key % 8 with SWZ); keys at or past k_lim
// are zero-filled
template <typename TKV, int D, bool SWZ>
__device__ __forceinline__ void load_keys(TKV* dst, const TKV* pool,
                                          const int* table, int bs,
                                          int kv_heads, int kvh, int k0,
                                          int k_lim) {
  constexpr int C = D / 4;
  for (int e = threadIdx.x; e < BN * C; e += TT) {
    const int r = e / C, c = e % C;
    const int key = k0 + r;
    const bool ok = key < k_lim;
    const TKV* src = pool;
    if (ok)
      src = pool + ((int64_t(table[key / bs]) * bs + key % bs) * kv_heads +
                    kvh) * D + 4 * c;
    cp_async<4 * int(sizeof(TKV))>(dst + chunk_at<D, SWZ>(r, c), src, ok);
  }
}

// BM query rows per CTA (64 or 128), BM / 16 per thread
template <typename TQ, typename TKV, int D, int BM>
__global__ void __launch_bounds__(TT, 1)
mixed_paged_tiles_kernel(const Args a) {
  constexpr int RM = BM / 16;  // query rows per thread
  constexpr int NC = D / 16;   // output columns per thread
  constexpr int C4 = D / 4;
  constexpr int ST = TILE_STAGES<TKV, D, BM>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [BM][D], swizzled
  float* pt = qs + BM * D;                       // [BN][BM] P^T, swizzled
  float* sc = pt + BN * BM;                      // [ST][K, V][BN] (int8)
  TKV* ks = reinterpret_cast<TKV*>(sc + (kInt8<TKV> ? 2 * ST * BN : 0));
  TKV* vs = ks + ST * BN * D;                    // [ST][BN][D] each

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tile = gridDim.y - 1 - blockIdx.y;   // heaviest first
  const int split = blockIdx.x % a.splits;
  const int kvh = blockIdx.x / a.splits % a.kv_heads;
  const int slot = blockIdx.x / a.splits / a.kv_heads;
  const int rep = a.heads / a.kv_heads, bs = a.block_size;
  const SlotRows sr = slot_rows<false>(a, slot);
  const int j0 = tile * BM;
  const int n_rows = min(BM, rep * a.chunk - j0);
  const int n_valid = max(0, min(n_rows, sr.q_len * rep - j0));
  TQ* out = static_cast<TQ*>(a.out);
  if (a.splits == 1)
    for (int e = n_valid * D + tid; e < n_rows * D; e += TT)
      store(out + out_row(a, slot, kvh, rep, j0 + e / D) * D + e % D, 0.f);
  if (n_valid == 0) return;
  const int horizon = sr.hist + (j0 + n_valid - 1) / rep;
  const int span = a.split_pages * bs;
  const int k_begin = split * span;
  if (k_begin > horizon) return;
  const int k_end = min(min(k_begin + span, horizon + 1), a.max_blocks * bs);
  const int* table = a.block_tables + int64_t(slot) * a.max_blocks;
  const TKV* kp = static_cast<const TKV*>(a.k_pool);
  const TKV* vp = static_cast<const TKV*>(a.v_pool);

  auto load_tile = [&](int st, int k0) {
    load_keys<TKV, D, true>(ks + st * BN * D, kp, table, bs, a.kv_heads, kvh,
                            k0, k_end);
    load_keys<TKV, D, false>(vs + st * BN * D, vp, table, bs, a.kv_heads,
                             kvh, k0, k_end);
    if constexpr (kInt8<TKV>) {
      for (int e = tid; e < 2 * BN; e += TT) {
        const int key = k0 + e % BN;
        const bool ok = key < k_end;
        const float* src = e < BN ? a.k_scale : a.v_scale;
        if (ok)
          src += (int64_t(table[key / bs]) * bs + key % bs) * a.kv_heads + kvh;
        cp_async<4>(sc + st * 2 * BN + e, src, ok);
      }
    }
  };
  int k0 = k_begin;
  load_tile(0, k0);
  cp_async_commit();

  // Q's rows in fp32, swizzled; rows past n_valid are zeros
  const TQ* q = static_cast<const TQ*>(a.q);
  for (int e = tid; e < BM * C4; e += TT) {
    const int r = e / C4, c = e % C4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_valid) x = ld4(q + out_row(a, slot, kvh, rep, j0 + r) * D + 4 * c);
    *reinterpret_cast<float4*>(qs + chunk_at<D, true>(r, c)) = x;
  }

  float acc[RM][NC], m_i[RM], l_i[RM];
  int last[RM];   // each row's last visible key
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
    last[i] = sr.hist + (j0 + ty + 16 * i) / rep;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  // the swizzle of this thread's rows: (ty + 16 i) % 8 and (tx + 16 j) % 8
  const int qsw = ty & 7, ksw = tx & 7;
  for (int st = 0; k0 < k_end; st = (st + 1) % ST) {
    cp_async_wait<0>();
    // tile k0 has landed for every thread, and every thread is done with
    // the previous tile's P.V: its buffers and P^T are free
    __syncthreads();
    const int k1 = k0 + BN;
    if (ST == 2) {
      if (k1 < k_end) load_tile(st ^ 1, k1);
      cp_async_commit();
    }

    const TKV* kt = ks + st * BN * D;
    const float* ksc = sc + st * 2 * BN;
    float kscale[RN];
#pragma unroll
    for (int j = 0; j < RN; ++j)
      kscale[j] = kInt8<TKV> ? ksc[tx + 16 * j] : 1.f;
    float s[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < C4; ++c) {
      float4 qa[RM], kc[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qa[i] = *reinterpret_cast<const float4*>(
            qs + (ty + 16 * i) * D + ((c ^ qsw) << 2));
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        kc[j] = ld4(kt + (tx + 16 * j) * D + ((c ^ ksw) << 2));
        if constexpr (kInt8<TKV>) kc[j] = scaled(kc[j], kscale[j]);
      }
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

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      bool ok[RN];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int col = k0 + tx + 16 * j;
        ok[j] = col < k_end && col <= last[i];
        s[i][j] = ok[j] ? s[i][j] * a.scale2 : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = exp2f(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        s[i][j] = ok[j] ? exp2f(s[i][j] - m_new) : 0.f;
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

    const TKV* vt = vs + st * BN * D;
    const float* vsc = ksc + BN;
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
      const float vscale = kInt8<TKV> ? vsc[key] : 1.f;
#pragma unroll
      for (int g = 0; g < D / 64; ++g) {
        float4 v4 = ld4(vt + key * D + g * 64 + tx * 4);
        if constexpr (kInt8<TKV>) v4 = scaled(v4, vscale);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          acc[i][4 * g] = fmaf(p[i], v4.x, acc[i][4 * g]);
          acc[i][4 * g + 1] = fmaf(p[i], v4.y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(p[i], v4.z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(p[i], v4.w, acc[i][4 * g + 3]);
        }
      }
    }
    if (ST == 1) {
      __syncthreads();   // every thread is done with this tile's K and V
      if (k1 < k_end) load_tile(0, k1);
      cp_async_commit();
    }
    k0 = k1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float l = l_i[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l += __shfl_xor_sync(FULL, l, off);
    const int r = ty + 16 * i;
    if (r >= n_valid) continue;
    const int64_t row = out_row(a, slot, kvh, rep, j0 + r);
    if (a.splits == 1) {
      const float lc = fmaxf(l, 1e-30f);
      TQ* o = out + row * D;
#pragma unroll
      for (int g = 0; g < D / 64; ++g)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          store(o + g * 64 + tx * 4 + u, acc[i][4 * g + u] / lc);
    } else {
      const int64_t pi = row * a.splits + split;
#pragma unroll
      for (int g = 0; g < D / 64; ++g)
        *reinterpret_cast<float4*>(a.part_o + pi * D + g * 64 + tx * 4) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                        acc[i][4 * g + 3]);
      if (tx == 0) {
        a.part_m[pi] = m_i[i];
        a.part_l[pi] = l;
      }
    }
  }
}

// -- combine: merge each valid row's live splits ------------------------------

// one warp per [S, C, H] row; rows past q_len (and idle slots) get zeros
template <typename TQ, int D, bool DECODE>
__device__ __forceinline__ void combine_body(const Args& a) {
  constexpr int VW = D / 32;
  const int64_t row = (int64_t(blockIdx.x) * RT + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= int64_t(a.slots) * a.chunk * a.heads) return;
  const int slot = int(row / (int64_t(a.chunk) * a.heads));
  const int ci = int(row / a.heads % a.chunk);
  const SlotRows sr = slot_rows<DECODE>(a, slot);
  TQ* o = static_cast<TQ*>(a.out) + row * D + lane * VW;
  if (ci >= sr.q_len) {
#pragma unroll
    for (int v = 0; v < VW; ++v) store(o + v, 0.f);
    return;
  }
  // the splits that hold a key of this row: every one of them ran and saw
  // at least that key
  const int bs = a.block_size;
  const int keys = min(sr.hist + ci + 1, a.max_blocks * bs);
  const int pages = (keys + bs - 1) / bs;
  const int live = min(a.splits, (pages + a.split_pages - 1) / a.split_pages);
  const float* pm = a.part_m + row * a.splits;
  const float* pl = a.part_l + row * a.splits;
  float mx = NEG_INF;
  for (int i = 0; i < live; ++i)
    if (pl[i] > 0.f) mx = fmaxf(mx, pm[i]);
  float lsum = 0.f, acc[VW];
#pragma unroll
  for (int v = 0; v < VW; ++v) acc[v] = 0.f;
  for (int i = 0; i < live; ++i) {
    const float li = pl[i];
    if (li > 0.f) {
      const float w = exp2f(pm[i] - mx);
      lsum = fmaf(w, li, lsum);
      float x[VW];
      ldv<VW>(a.part_o + (row * a.splits + i) * D + lane * VW, x);
#pragma unroll
      for (int v = 0; v < VW; ++v) acc[v] = fmaf(w, x[v], acc[v]);
    }
  }
#pragma unroll
  for (int v = 0; v < VW; ++v) store(o + v, acc[v] / fmaxf(lsum, 1e-30f));
}

template <typename TQ, int D>
__global__ void __launch_bounds__(RT) paged_decode_combine_kernel(
    const Args a) {
  combine_body<TQ, D, true>(a);
}

template <typename TQ, int D>
__global__ void __launch_bounds__(RT) mixed_paged_combine_kernel(
    const Args a) {
  combine_body<TQ, D, false>(a);
}

// -- launchers -------------------------------------------------------------

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  return cudaSuccess;
}

template <typename TQ, int D>
cudaError_t launch_combine(bool decode, const Args& a, cudaStream_t stream) {
  const int64_t rows = int64_t(a.slots) * a.chunk * a.heads;
  const unsigned blocks = unsigned((rows + RWARPS - 1) / RWARPS);
  if (decode)
    paged_decode_combine_kernel<TQ, D><<<blocks, RT, 0, stream>>>(a);
  else
    mixed_paged_combine_kernel<TQ, D><<<blocks, RT, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int D>
cudaError_t launch_decode(Args a, cudaStream_t stream) {
  a.chunk = 1;
  a.tiles = (a.heads / a.kv_heads + DECODE_ROWS - 1) / DECODE_ROWS;
  const size_t smem = rows_smem<TKV, D, DECODE_ROWS>(a.block_size);
  auto kernel = paged_decode_kernel<TQ, TKV, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.splits, a.kv_heads, a.slots * a.tiles), RT, smem,
           stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return launch_combine<TQ, D>(true, a, stream);
}

template <typename TQ, typename TKV, int D, int BM>
cudaError_t launch_tiles(Args a, cudaStream_t stream) {
  a.tiles = (a.heads / a.kv_heads * a.chunk + BM - 1) / BM;
  const size_t smem = tiles_smem<TKV, D, BM>(TILE_STAGES<TKV, D, BM>);
  auto kernel = mixed_paged_tiles_kernel<TQ, TKV, D, BM>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.slots * a.kv_heads * a.splits, a.tiles), TT, smem,
           stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return launch_combine<TQ, D>(false, a, stream);
}

// tile_rows: MIXED_ROWS<D> = the rows kernel, 64 or (D <= 128) 128 = the
// tiles kernel
template <typename TQ, typename TKV, int D>
cudaError_t launch_mixed(Args a, int tile_rows, cudaStream_t stream) {
  constexpr int R = MIXED_ROWS<D>;
  if (tile_rows == 64) return launch_tiles<TQ, TKV, D, 64>(a, stream);
  if constexpr (D <= 128) {
    if (tile_rows == 128) return launch_tiles<TQ, TKV, D, 128>(a, stream);
  }
  if (tile_rows != R) return cudaErrorInvalidValue;
  a.tiles = (a.heads / a.kv_heads * a.chunk + R - 1) / R;
  const size_t smem = rows_smem<TKV, D, R>(a.block_size);
  auto kernel = mixed_paged_kernel<TQ, TKV, D>;
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.splits, a.kv_heads, a.slots * a.tiles), RT, smem,
           stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  return launch_combine<TQ, D>(false, a, stream);
}

// Calls f(TQ{}, TKV{}, std::integral_constant<int, D>{}) for the element
// types named by the codes (0 float32, 1 bfloat16, 3 float16; pools also
// 2 int8) and head_dim; invalid combinations return cudaErrorInvalidValue.
template <typename F>
cudaError_t dispatch(int dtype, int kv_dtype, int head_dim, F&& f) {
  using D64 = std::integral_constant<int, 64>;
  using D128 = std::integral_constant<int, 128>;
  using D256 = std::integral_constant<int, 256>;
  using bf16 = __nv_bfloat16;
  if (head_dim != 64 && head_dim != 128 && head_dim != 256)
    return cudaErrorInvalidValue;
  const bool wide = head_dim == 128, d256 = head_dim == 256;
  if (dtype == 0 && kv_dtype == 0)
    return d256 ? f(float{}, float{}, D256{})
           : wide ? f(float{}, float{}, D128{}) : f(float{}, float{}, D64{});
  if (dtype == 1 && kv_dtype == 1)
    return d256 ? f(bf16{}, bf16{}, D256{})
           : wide ? f(bf16{}, bf16{}, D128{}) : f(bf16{}, bf16{}, D64{});
  if (dtype == 0 && kv_dtype == 2)
    return d256 ? f(float{}, int8_t{}, D256{})
           : wide ? f(float{}, int8_t{}, D128{})
                  : f(float{}, int8_t{}, D64{});
  if (dtype == 1 && kv_dtype == 2)
    return d256 ? f(bf16{}, int8_t{}, D256{})
           : wide ? f(bf16{}, int8_t{}, D128{}) : f(bf16{}, int8_t{}, D64{});
  if (dtype == 3 && kv_dtype == 3)
    return d256 ? f(__half{}, __half{}, D256{})
           : wide ? f(__half{}, __half{}, D128{})
                  : f(__half{}, __half{}, D64{});
  if (dtype == 3 && kv_dtype == 2)
    return d256 ? f(__half{}, int8_t{}, D256{})
           : wide ? f(__half{}, int8_t{}, D128{})
                  : f(__half{}, int8_t{}, D64{});
  return cudaErrorInvalidValue;
}

// The arguments both entry points share; false for what the kernels do not
// take: H not a multiple of Hkv, or a split plan that misses a page
// (splits * split_pages < max_blocks) or has more than one split and no
// scratch.
bool make_args(Args* a, const void* q, const void* k_pool,
               const void* v_pool, const void* k_scale, const void* v_scale,
               const void* block_tables, const void* lens,
               const void* q_lens, void* out, void* scratch, int slots,
               int chunk, int heads, int kv_heads, int head_dim,
               int block_size, int max_blocks, int split_pages, int splits,
               float scale) {
  if (kv_heads < 1 || heads % kv_heads != 0 || block_size < 1 ||
      split_pages < 1 || splits < 1 ||
      int64_t(splits) * split_pages < max_blocks ||
      (splits > 1 && scratch == nullptr))
    return false;
  *a = Args{};
  a->q = q;
  a->k_pool = k_pool;
  a->v_pool = v_pool;
  a->k_scale = static_cast<const float*>(k_scale);
  a->v_scale = static_cast<const float*>(v_scale);
  a->block_tables = static_cast<const int*>(block_tables);
  a->lens = static_cast<const int*>(lens);
  a->q_lens = static_cast<const int*>(q_lens);
  a->out = out;
  const int64_t parts = int64_t(slots) * chunk * heads * splits;
  a->part_o = static_cast<float*>(scratch);
  a->part_m = scratch != nullptr ? a->part_o + parts * head_dim : nullptr;
  a->part_l = scratch != nullptr ? a->part_m + parts : nullptr;
  a->slots = slots;
  a->chunk = chunk;
  a->heads = heads;
  a->kv_heads = kv_heads;
  a->block_size = block_size;
  a->max_blocks = max_blocks;
  a->split_pages = split_pages;
  a->splits = splits;
  a->scale2 = scale * LOG2E;
  return true;
}

}  // namespace

extern "C" {

const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q [S, H, D]; k/v pools [NB, bs, Hkv, D]; k/v scales [NB, bs, Hkv] fp32
// (int8 pools only, else ignored); block_tables [S, MB] int32; seq_lens [S]
// int32; out [S, H, D]; all contiguous, pools 16-byte aligned. dtype (q,
// out): 0 = float32, 1 = bfloat16, 3 = float16; kv_dtype: the same code,
// or 2 = int8.
// The split plan: `splits` splits of `split_pages` pages (splits *
// split_pages >= MB); with splits > 1, scratch holds S * H * splits *
// (D + 2) floats of partials. Requires H % Hkv == 0. Launches the decode
// kernel and, with splits > 1, the combine; returns the first cudaError_t.
int pt_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                       const void* k_scale, const void* v_scale,
                       const void* block_tables, const void* seq_lens,
                       void* out, void* scratch, int slots, int heads,
                       int kv_heads, int head_dim, int block_size,
                       int max_blocks, int split_pages, int splits,
                       float scale, int dtype, int kv_dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a;
  if (!make_args(&a, q, k_pool, v_pool, k_scale, v_scale, block_tables,
                 seq_lens, nullptr, out, scratch, slots, 1, heads, kv_heads,
                 head_dim, block_size, max_blocks, split_pages, splits,
                 scale))
    return cudaErrorInvalidValue;
  return dispatch(dtype, kv_dtype, head_dim, [&](auto tq, auto tkv, auto d) {
    return launch_decode<decltype(tq), decltype(tkv), decltype(d)::value>(
        a, s);
  });
}

// q [S, C, H, D]; pools, scales and block_tables as above; hist_lens and
// q_lens [S] int32; out [S, C, H, D]. Row (s, ci) with ci < q_lens[s] sees
// keys 0 .. hist_lens[s] + ci; other rows are written as zeros.
// `tile_rows` picks the kernel: 16 the rows kernel, 64 or 128 the tiles
// kernel at that tile height; the split plan and scratch as above, with
// S * C * H rows. Requires H % Hkv == 0 and
// hist + q_len <= MB * bs for every slot.
int pt_mixed_paged_attention(const void* q, const void* k_pool,
                             const void* v_pool, const void* k_scale,
                             const void* v_scale, const void* block_tables,
                             const void* hist_lens, const void* q_lens,
                             void* out, void* scratch, int slots, int chunk,
                             int heads, int kv_heads, int head_dim,
                             int block_size, int max_blocks, int tile_rows,
                             int split_pages, int splits, float scale,
                             int dtype, int kv_dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a;
  if (!make_args(&a, q, k_pool, v_pool, k_scale, v_scale, block_tables,
                 hist_lens, q_lens, out, scratch, slots, chunk, heads,
                 kv_heads, head_dim, block_size, max_blocks, split_pages,
                 splits, scale))
    return cudaErrorInvalidValue;
  return dispatch(dtype, kv_dtype, head_dim, [&](auto tq, auto tkv, auto d) {
    return launch_mixed<decltype(tq), decltype(tkv), decltype(d)::value>(
        a, tile_rows, s);
  });
}

}  // extern "C"
