// Weight-only int8 GEMM for Hopper (sm_90a): y = x @ dequantize(q, s), with
// fp32 activations x [M, K], an int8 weight q [K, N] (Paddle's [in, out]
// layout, contiguous along out) and fp32 block scales s [K / b, N]:
//
//     y[m, n] = sum_k x[m, k] * (q[k, n] * s[k / b, n])
//
// It has no Pallas counterpart. The reference's weight-only int8 decode
// (FLAGS_serving_quant_weights, paddle_tpu/serving/engine.py, the
// _dequant_state step) dequantizes each projection weight inside the traced
// decode step and leaves the multiply to XLA, which fuses it into the
// matmul's operand read, so only the int8 planes cross device memory.
// Eager PyTorch fuses nothing: a dequantize followed by a library GEMM would
// read the int8 planes, write and read an fp32 copy and read it again. This
// kernel is that fusion, written by hand.
//
// Numerics: the reference's fp32 products are 'highest', so the product
// runs on the CUDA cores in fp32 (no tensor cores, no TF32). Each element
// is dequantized exactly as dequantize_int8_weight does (the int8 value
// times its fp32 scale, one rounding), then multiplied and accumulated in
// fp32; only the order of the sums differs from the plain version. No
// floating-point atomics: every sum runs in a fixed order, so two launches
// on the same inputs give the same bits.
//
// What bounds it on this card (llama1b, one layer's 7 projections, 50.6 M
// int8 weights): at the decode batch (M = 16) 1.6 GFLOP, 0.024 ms at 67
// TFLOP/s fp32, against 50.6 MB of int8 planes, 0.015 ms at 3.35 TB/s: bound
// by operations, with the bytes close behind. Each projection is a few us
// of work, so a launch's fixed cost (the first loads, the block and
// cluster reductions; tools/w8_timing.py --sweep fits it) and the SMs a
// grid of clusters leaves idle weigh as much as the FMA loop. At the mixed
// step (M = 256) 25.9 GFLOP, 0.39 ms: a SIMT GEMM bound by operations,
// where what counts is how often each int8 element is dequantized and how
// many instruction slots each FMA costs (the fp32 pipe needs one warp
// instruction a cycle on every scheduler).
//
// Two regimes, picked by the wrapper's pure-integer plan (kernels/quant.py
// w8_plan) from the shapes alone; the grid is (splits, ceil(N / bn),
// ceil(M / bm)), and the `splits` CTAs that cut one output tile along K
// form one thread-block cluster (at most kMaxCluster; above 8 through
// cudaFuncAttributeNonPortableClusterSizeAllowed). Clusters of 3 to 16 CTAs
// fill only 102-120 of the 132 SMs at once (cudaOccupancyMaxActiveClusters;
// the GPCs' sizes), so the plan costs each split count by the rounds its
// grid takes on the SMs its clusters can use.
//
//  * Small M (bm = kSmallBM = 16; the plan takes it for M <= 32): one CTA
//    of 12 warps owns a 16-row x 128-column tile and a K chunk of the
//    cluster; each warp takes its own run of the chunk through its own
//    6-step ring of 16-byte cp.async copies (8 k rows of x and q a step,
//    5 KB of q in flight a warp, 60 KB an SM), synchronised with
//    __syncwarp only, so no warp waits on a block barrier. A lane owns 4
//    columns and dequantizes its 8 x 4 int8 values a step in registers,
//    once a CTA (byte permute into 0x4B0000bb, one subtract of 2^23 + 128
//    leaves the int8 value exactly, then the scale), feeding each to 16
//    FMAs with x read as broadcast float4s; a step whose rows stay in one
//    scale block and before the run's end takes a path with no checks, so
//    its 8 q words and 32 values are in flight before the first FMA. The
//    warps' partials are summed in shared memory in warp order; the
//    cluster's ranks then sum the tile through distributed shared memory:
//    after cluster.sync(), rank r loads slice r of every rank's tile (all
//    loads in flight at once) and adds them in rank order, writes y, and a
//    second cluster.sync() keeps every tile alive until all have read it.
//    No partial tile touches device memory, no counter, no last-CTA tail.
//    One CTA an SM (80 KB of shared memory, ~170 registers): with a 128-
//    register cap for two CTAs an SM the loop spilled and ran slower.
//  * Larger M (bm = 64 or 128): a register-tiled SIMT GEMM. 256 threads own
//    a bm x 128 tile, a thread a (bm / 16) x 8 micro-tile (rows ty*TM..,
//    columns tx*4.. and 64 + tx*4.., so its float4 reads of a k row are
//    conflict-free). x [bm][32] (rows padded to 36 floats) and q [32][128]
//    arrive through a 4-stage cp.async ring; each stage is converted once,
//    x transposed to [32][bm] and q dequantized once a CTA into an fp32
//    [32][128] tile that feeds every row of the tile (bm FMAs an element,
//    against 16 in the small regime), into one of two buffers while the
//    other feeds the FMAs, so one barrier a k-tile separates them. Scales
//    are reloaded only when a k row enters the next block of b rows (a
//    k-tile inside one block takes a path with no checks), so a block need
//    not be a multiple of the stage. When the output tiles leave SMs idle
//    the plan splits K over a cluster, reduced as above. One CTA an SM
//    (100-152 KB of shared memory).
//
// Rows past M are zero-filled and never stored; a k row past a split's end
// is zero-filled in x and in w (its scale is never read), so it adds
// exactly 0. Columns past N are zero-filled and never stored. Where N is
// not a multiple of 16, K not a multiple of 16 bytes of x (4 fp32, 8 bf16
// values) or an operand not 16-byte aligned, the same kernels stage
// through plain loads (kVec = false).
//
// bf16 mode (pt_w8_gemm_bf16: bf16 x [M, K] and y [M, N], the same q and
// fp32 scales): the reference's numerics for a bf16 model under int8
// weights, dequantize_int8_weight(q, s, bf16) and then a bf16 matmul. Each
// weight element is q * s in fp32 rounded once to bf16, the products of
// the widened bf16 x and w are summed in fp32 (the same FMAs and order as
// the fp32 mode), and y is rounded once to bf16 at the store; split-K
// partials meet in fp32, before that rounding. The kernels are the fp32
// mode's, instantiated on the activation type TX: x is staged as bf16 (16
// bytes = 8 values a cp.async copy, half the fp32 mode's x bytes) and
// widened to fp32 where it is read, at the small regime's FMA and at the
// large regime's transpose into shared memory; y is stored as bf16 pairs.
// The bytes it must move are the fp32 mode's less half of x and y, and
// its FMAs are the same, so at llama1b's projections it is bound as the
// fp32 mode is: by the fp32 operations.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kKT = 32;               // k rows a large-M stage
constexpr int kMaxCluster = 16;       // splits of K a tile, at most
constexpr int kSmallBM = 16;          // rows a small-M CTA computes
constexpr int kSmallBN = 128;         // columns a small-M CTA computes
constexpr int kSmallWarps = 12;       // each takes its own run of k rows
constexpr int kSmallRows = 8;         // k rows a warp step
constexpr int kSmallKT = kSmallWarps * kSmallRows;  // a chunk's granule
constexpr int kSmallStages = 6;       // steps in flight a warp
constexpr int kLargeBN = 128;         // columns a large-M CTA computes
constexpr int kLargeStages = 4;

// -- the activation type: float (fp32 mode) or bf16 (bf16 mode) --------------

template <typename TX>
struct Act {                          // float
  static constexpr bool kBf16 = false;
  static constexpr int kVec = 4;      // values a 16-byte copy
  static constexpr int kXStride = kKT + 4;   // values a staged x row, large M
};
template <>
struct Act<bf16> {
  static constexpr bool kBf16 = true;
  static constexpr int kVec = 8;
  static constexpr int kXStride = kKT + 8;   // 80 bytes: conflict-free reads
};

template <typename TX>
__device__ __forceinline__ TX zero_x() {
  if constexpr (Act<TX>::kBf16)
    return __float2bfloat16_rn(0.f);
  else
    return 0.f;
}

// two bf16 values packed in a word (the first in the low half) as floats
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ uint32_t pack_bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 8 consecutive staged x values (16-byte aligned) widened to fp32
template <typename TX>
__device__ __forceinline__ void load_x8(const TX* p, float4& a, float4& b) {
  if constexpr (Act<TX>::kBf16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    a = make_float4(bf_lo(u.x), bf_hi(u.x), bf_lo(u.y), bf_hi(u.y));
    b = make_float4(bf_lo(u.z), bf_hi(u.z), bf_lo(u.w), bf_hi(u.w));
  } else {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
}

// a dequantized weight as the reference's dequantize_int8_weight gives it
// in x's dtype: q * s in fp32, rounded once to bf16 in the bf16 mode
template <typename TX>
__device__ __forceinline__ float weight(float w) {
  if constexpr (Act<TX>::kBf16)
    return __bfloat162float(__float2bfloat16_rn(w));
  else
    return w;
}

// -- helpers ------------------------------------------------------------------

__device__ __forceinline__ float i8f(uint32_t biased, uint32_t sel) {
  // 2^23 + (v + 128) as a float, minus 2^23 + 128: exactly v
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, sel)) - 8388736.f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from src to dst, or zeros when !ok (src must still be a valid
// address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the 4 (or 8) scales of columns col.. of one scale row s, 0 past N
template <bool kVec, int C>
__device__ __forceinline__ void load_scales(const float* __restrict__ s,
                                            int col, int n, float* out) {
  if constexpr (kVec) {
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const float4 v = col + c < n
          ? __ldg(reinterpret_cast<const float4*>(s + col + c))
          : make_float4(0.f, 0.f, 0.f, 0.f);
      out[c] = v.x;
      out[c + 1] = v.y;
      out[c + 2] = v.z;
      out[c + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) out[c] = col + c < n ? s[col + c] : 0.f;
  }
}

// 4 int8 values (one 32-bit word) dequantized with their 4 scales
template <typename TX>
__device__ __forceinline__ void dequant4(uint32_t word, const float* sc,
                                         float* w) {
  const uint32_t b = word ^ 0x80808080u;
  w[0] = weight<TX>(i8f(b, 0x7540) * sc[0]);
  w[1] = weight<TX>(i8f(b, 0x7541) * sc[1]);
  w[2] = weight<TX>(i8f(b, 0x7542) * sc[2]);
  w[3] = weight<TX>(i8f(b, 0x7543) * sc[3]);
}

// v at y[row, col..col + 3], masked to M and N; the bf16 mode rounds each
// value once here
template <bool kVec, typename TX>
__device__ __forceinline__ void store4(TX* __restrict__ y, int row, int col,
                                       float4 v, int m_rows, int n) {
  if (row >= m_rows) return;
  TX* p = y + static_cast<size_t>(row) * n + col;
  if constexpr (Act<TX>::kBf16) {
    if constexpr (kVec) {
      if (col < n)
        *reinterpret_cast<uint2*>(p) =
            make_uint2(pack_bf2(v.x, v.y), pack_bf2(v.z, v.w));
    } else {
      if (col < n) p[0] = __float2bfloat16_rn(v.x);
      if (col + 1 < n) p[1] = __float2bfloat16_rn(v.y);
      if (col + 2 < n) p[2] = __float2bfloat16_rn(v.z);
      if (col + 3 < n) p[3] = __float2bfloat16_rn(v.w);
    }
  } else if constexpr (kVec) {
    if (col < n) *reinterpret_cast<float4*>(p) = v;
  } else {
    if (col < n) p[0] = v.x;
    if (col + 1 < n) p[1] = v.y;
    if (col + 2 < n) p[2] = v.z;
    if (col + 3 < n) p[3] = v.w;
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The cluster's split-K sum: every rank's CTA partial [rows][kCols] sits at
// `tile` in its shared memory. Rank r sums slice r of the tile over the
// ranks, in rank order, with every rank's load in flight at once, and
// writes y.
template <bool kVec, int kCols, typename TX>
__device__ __forceinline__ void cluster_reduce(float* tile, int rows,
                                               TX* __restrict__ y, int m0,
                                               int n0, int m_rows, int n) {
  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int total = rows * kCols / 4;             // float4s a tile
  const int per = (total + ranks - 1) / ranks;
  cluster.sync();
  for (int i = threadIdx.x; i < per; i += blockDim.x) {
    const int idx = rank * per + i;
    if (idx >= total) break;
    float4 v[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < ranks)
        v[r] = reinterpret_cast<const float4*>(
            cluster.map_shared_rank(tile, r))[idx];
    float4 sum = v[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < ranks) sum = add4(sum, v[r]);
    store4<kVec>(y, m0 + idx / (kCols / 4), n0 + (idx % (kCols / 4)) * 4,
                 sum, m_rows, n);
  }
  cluster.sync();
}

// -- small M: 16 x 128 tiles, dequantize in registers --------------------------

namespace small {
constexpr int kThreads = 32 * kSmallWarps;
constexpr int kRedBytes = kSmallWarps * kSmallBM * kSmallBN * 4;
constexpr int kTileBytes = kSmallBM * kSmallBN * 4;  // the CTA's partial
static_assert(kSmallBN == 32 * 4, "a lane owns 4 columns");

template <typename TX>
struct Ring {
  static constexpr int kXBytes =
      kSmallBM * kSmallRows * static_cast<int>(sizeof(TX));   // x [16][8]
  static constexpr int kQBytes = kSmallRows * kSmallBN;       // q [8][128]
  static constexpr int kStepBytes = kXBytes + kQBytes;
  static constexpr int kWarpRing = kSmallStages * kStepBytes; // a warp's
  static constexpr int kRingBytes = kSmallWarps * kWarpRing;
  static constexpr int kSmem =
      (kRingBytes > kRedBytes ? kRingBytes : kRedBytes) + kTileBytes;
  static constexpr int kXCopies = kSmallBM * kSmallRows / Act<TX>::kVec;
  static_assert(kXBytes % 16 == 0 && kXCopies <= 32,
                "a step's x is whole 16-byte copies, one a lane at most");
};

// one warp's step: x[m0.., k0..k0 + 8) and q[k0..k0 + 8, n0..), rows at
// or past `end` zero-filled
template <bool kVec, typename TX>
__device__ __forceinline__ void load_step(unsigned char* st,
                                          const TX* __restrict__ x,
                                          const int8_t* __restrict__ q,
                                          int m0, int m_rows, int n0, int n,
                                          int k_dim, int k0, int end) {
  using R = Ring<TX>;
  TX* sx = reinterpret_cast<TX*>(st);
  int8_t* sq = reinterpret_cast<int8_t*>(st + R::kXBytes);
  const int lane = threadIdx.x & 31;
  if constexpr (kVec) {
    if (lane < R::kXCopies) {
      constexpr int kPerRow = kSmallRows / Act<TX>::kVec;     // copies a row
      const int r = lane / kPerRow, c = (lane % kPerRow) * Act<TX>::kVec;
      const bool ok = m0 + r < m_rows && k0 + c < end;
      cp_async16(sx + r * kSmallRows + c,
                 ok ? x + static_cast<size_t>(m0 + r) * k_dim + k0 + c : x,
                 ok);
    }
#pragma unroll
    for (int i = 0; i < R::kQBytes / 16 / 32; ++i) {
      const int idx = lane + 32 * i;
      const int r = idx >> 3, c = (idx & 7) * 16;
      const bool ok = k0 + r < end && n0 + c < n;
      cp_async16(sq + r * kSmallBN + c,
                 ok ? q + static_cast<size_t>(k0 + r) * n + n0 + c : q, ok);
    }
  } else {
    for (int i = lane; i < kSmallBM * kSmallRows; i += 32) {
      const int r = i / kSmallRows, c = i % kSmallRows;
      sx[i] = m0 + r < m_rows && k0 + c < end
          ? x[static_cast<size_t>(m0 + r) * k_dim + k0 + c] : zero_x<TX>();
    }
    for (int i = lane; i < kSmallRows * kSmallBN; i += 32) {
      const int r = i / kSmallBN, c = i % kSmallBN;
      sq[i] = k0 + r < end && n0 + c < n
          ? q[static_cast<size_t>(k0 + r) * n + n0 + c] : int8_t(0);
    }
  }
}

// a warp's step of 8 rows, k its first. kSlow: some row is at or past
// `end` (it adds exactly 0) or enters the next scale block (reload its
// scales); the fast path has neither, so its 8 q words and 32 dequantized
// values are all in flight before the first FMA.
template <bool kVec, bool kSlow, typename TX>
__device__ __forceinline__ void step(const unsigned char* st,
                                     const float* __restrict__ scales,
                                     float (&acc)[kSmallBM][4],
                                     float (&sc)[4], int& blk_hi, int k,
                                     int end, int block, int col, int n) {
  const int lane = threadIdx.x & 31;
  const TX* sx = reinterpret_cast<const TX*>(st);
  const int8_t* sq =
      reinterpret_cast<const int8_t*>(st + Ring<TX>::kXBytes) + lane * 4;
  float w[kSmallRows][4];
#pragma unroll
  for (int j = 0; j < kSmallRows; ++j) {
    if (kSlow) {
      if (k + j >= end) {
#pragma unroll
        for (int c = 0; c < 4; ++c) w[j][c] = 0.f;
        continue;
      }
      if (k + j >= blk_hi) {
        const int blk = (k + j) / block;
        blk_hi = (blk + 1) * block;
        load_scales<kVec, 4>(scales + static_cast<size_t>(blk) * n, col, n,
                             sc);
      }
    }
    dequant4<TX>(*reinterpret_cast<const uint32_t*>(sq + j * kSmallBN), sc,
                 w[j]);
  }
#pragma unroll
  for (int g = 0; g < kSmallBM / 4; ++g) {
    float4 xa[4], xb[4];                 // x[m][k..k + 3], x[m][k + 4..k + 7]
#pragma unroll
    for (int i = 0; i < 4; ++i)
      load_x8(sx + (4 * g + i) * kSmallRows, xa[i], xb[i]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float a = acc[4 * g + i][c];
        a = fmaf(xa[i].x, w[0][c], a);
        a = fmaf(xa[i].y, w[1][c], a);
        a = fmaf(xa[i].z, w[2][c], a);
        a = fmaf(xa[i].w, w[3][c], a);
        a = fmaf(xb[i].x, w[4][c], a);
        a = fmaf(xb[i].y, w[5][c], a);
        a = fmaf(xb[i].z, w[6][c], a);
        a = fmaf(xb[i].w, w[7][c], a);
        acc[4 * g + i][c] = a;
      }
  }
}

// grid (splits, ceil(N / 128), ceil(M / 16)); split z takes k rows
// [z * chunk, min(K, (z + 1) * chunk)), warp w the w-th share of them
// through its own ring; a cluster of `splits` CTAs
template <bool kVec, typename TX>
__global__ void __launch_bounds__(kThreads, 1)
w8_gemm_small(const TX* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ scales, TX* __restrict__ y,
              int m_rows, int n, int k_dim, int block, int chunk) {
  using R = Ring<TX>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * kSmallBN, m0 = blockIdx.z * kSmallBM;
  const int per = chunk / kSmallWarps;            // a multiple of kSmallRows
  const int k_begin = min(k_dim, blockIdx.x * chunk + warp * per);
  const int end = min(k_dim, k_begin + per);
  const int steps = (end - k_begin + kSmallRows - 1) / kSmallRows;
  const int col = n0 + lane * 4;
  unsigned char* ring = smem + warp * R::kWarpRing;

#pragma unroll
  for (int s = 0; s < kSmallStages - 1; ++s) {
    if (s < steps)
      load_step<kVec>(ring + s * R::kStepBytes, x, q, m0, m_rows, n0, n,
                      k_dim, k_begin + s * kSmallRows, end);
    cp_async_commit();
  }
  float acc[kSmallBM][4];
#pragma unroll
  for (int m = 0; m < kSmallBM; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;
  float sc[4] = {0.f, 0.f, 0.f, 0.f};
  int blk_hi = 0;                    // first k row past the scales in sc
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kSmallStages - 2>();
    __syncwarp();                    // step t landed; step t - 1 is free
    const int tn = t + kSmallStages - 1;
    if (tn < steps)
      load_step<kVec>(ring + (tn % kSmallStages) * R::kStepBytes, x, q, m0,
                      m_rows, n0, n, k_dim, k_begin + tn * kSmallRows, end);
    cp_async_commit();
    const unsigned char* st = ring + (t % kSmallStages) * R::kStepBytes;
    const int k = k_begin + t * kSmallRows;
    if (k + kSmallRows <= end && k + kSmallRows <= blk_hi)
      step<kVec, false, TX>(st, scales, acc, sc, blk_hi, k, end, block, col,
                            n);
    else
      step<kVec, true, TX>(st, scales, acc, sc, blk_hi, k, end, block, col,
                           n);
  }
  cp_async_wait<0>();

  // the warps' partials summed in warp order into the CTA's tile
  float* red = reinterpret_cast<float*>(smem);
  float* tile = reinterpret_cast<float*>(smem + R::kSmem - kTileBytes);
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kSmallBM; ++m)
    *reinterpret_cast<float4*>(red + (warp * kSmallBM + m) * kSmallBN +
                               lane * 4) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  for (int i = tid; i < kSmallBM * kSmallBN / 4; i += kThreads) {
    const float4* r4 = reinterpret_cast<const float4*>(red);
    float4 v = r4[i];
#pragma unroll
    for (int w = 1; w < kSmallWarps; ++w)
      v = add4(v, r4[w * kSmallBM * kSmallBN / 4 + i]);
    if (gridDim.x == 1)
      store4<kVec>(y, m0 + i / (kSmallBN / 4), n0 + (i % (kSmallBN / 4)) * 4,
                   v, m_rows, n);
    else
      reinterpret_cast<float4*>(tile)[i] = v;
  }
  if (gridDim.x > 1)
    cluster_reduce<kVec, kSmallBN>(tile, kSmallBM, y, m0, n0, m_rows, n);
}

}  // namespace small

// -- larger M: BM x BN register tiles, dequantize once into shared memory -----

namespace large {

// BM rows x 128 columns a CTA, a (BM / 16) x 8 micro-tile a thread; x
// staged as TX
template <int BM, typename TX>
struct Tile {
  static constexpr int kBM = BM;
  static constexpr int kBN = kLargeBN;
  static constexpr int kTM = BM / 16;                     // rows a thread
  static constexpr int kThreads = 256;
  static constexpr int kXV = Act<TX>::kVec;               // x values a copy
  static constexpr int kXStride = Act<TX>::kXStride;
  static constexpr int kXBytes =                          // x [bm][stride]
      kBM * kXStride * static_cast<int>(sizeof(TX));
  static constexpr int kQBytes = kKT * kBN;                // q [32][bn]
  static constexpr int kStageBytes = kXBytes + kQBytes;
  static constexpr int kRingBytes = kLargeStages * kStageBytes;
  static constexpr int kXTBytes = kKT * kBM * 4;           // x^T [32][bm]
  static constexpr int kWBytes = kKT * kBN * 4;            // w [32][bn]
  static constexpr int kBufBytes = kXTBytes + kWBytes;     // one converted tile
  static constexpr int kSmem = kRingBytes + 2 * kBufBytes;
  static constexpr int kColGroups = kBN / 8;               // 8 columns each
  static constexpr int kRowsPerThread = kKT * kColGroups / kThreads;
  static_assert(kBM * kBN * 4 <= kSmem, "the partial tile fits");
  static_assert(kXBytes % 16 == 0 && kXStride % kXV == 0,
                "staged x rows keep 16-byte copies aligned");
  static_assert(kBM * kKT / kXV % kThreads == 0 &&
                    kBM * kKT / 8 % kThreads == 0 &&
                    kKT * kBN / 16 % kThreads == 0 &&
                    kKT * kColGroups % kThreads == 0 &&
                    kThreads % kBM == 0 && kBM % 16 == 0,
                "every thread copies and converts whole shares of a stage");
};

template <class T, bool kVec, typename TX>
__device__ __forceinline__ void load_stage(unsigned char* st,
                                           const TX* __restrict__ x,
                                           const int8_t* __restrict__ q,
                                           int m0, int m_rows, int n0, int n,
                                           int k_dim, int k0, int k_end) {
  TX* sx = reinterpret_cast<TX*>(st);
  int8_t* sq = reinterpret_cast<int8_t*>(st + T::kXBytes);
  const int tid = threadIdx.x;
  if constexpr (kVec) {
    constexpr int kPerRow = kKT / T::kXV;          // copies a staged x row
#pragma unroll
    for (int i = 0; i < T::kBM * kKT / T::kXV / T::kThreads; ++i) {
      const int idx = tid + i * T::kThreads;
      const int r = idx / kPerRow, c = (idx % kPerRow) * T::kXV;
      const bool ok = m0 + r < m_rows && k0 + c < k_end;
      cp_async16(sx + r * T::kXStride + c,
                 ok ? x + static_cast<size_t>(m0 + r) * k_dim + k0 + c : x,
                 ok);
    }
#pragma unroll
    for (int i = 0; i < kKT * T::kBN / 16 / T::kThreads; ++i) {
      const int idx = tid + i * T::kThreads;
      const int r = idx / (T::kBN / 16), c = (idx % (T::kBN / 16)) * 16;
      const bool ok = k0 + r < k_end && n0 + c < n;
      cp_async16(sq + r * T::kBN + c,
                 ok ? q + static_cast<size_t>(k0 + r) * n + n0 + c : q, ok);
    }
  } else {
    for (int i = tid; i < T::kBM * kKT; i += T::kThreads) {
      const int r = i / kKT, c = i % kKT;
      sx[r * T::kXStride + c] = m0 + r < m_rows && k0 + c < k_end
          ? x[static_cast<size_t>(m0 + r) * k_dim + k0 + c] : zero_x<TX>();
    }
    for (int i = tid; i < kKT * T::kBN; i += T::kThreads) {
      const int r = i / T::kBN, c = i % T::kBN;
      sq[i] = k0 + r < k_end && n0 + c < n
          ? q[static_cast<size_t>(k0 + r) * n + n0 + c] : int8_t(0);
    }
  }
}

// stage -> x^T [32][bm] in fp32 (bf16 x widened here) and the dequantized
// w [32][bn] (buf); a thread converts kRowsPerThread rows of 8 columns,
// c8.., and keeps their scales. kSlow: a row is past k_end (w = 0) or
// enters the next block.
template <class T, bool kVec, bool kSlow, typename TX>
__device__ __forceinline__ void convert(const unsigned char* st,
                                        unsigned char* buf,
                                        const float* __restrict__ scales,
                                        float (&sc)[8], int& blk_hi, int n0,
                                        int n, int k0, int k_end, int block) {
  const int tid = threadIdx.x;
  const TX* sx = reinterpret_cast<const TX*>(st);
  const int8_t* sq = reinterpret_cast<const int8_t*>(st + T::kXBytes);
  float* xt = reinterpret_cast<float*>(buf);
  float* wt = reinterpret_cast<float*>(buf + T::kXTBytes);
  constexpr int kXPer = T::kBM * kKT / 8 / T::kThreads;   // 8 values each
  const int m = tid % T::kBM;
#pragma unroll
  for (int i = 0; i < kXPer; ++i) {
    const int kq = tid / T::kBM + i * (T::kThreads / T::kBM);
    float4 a, b;
    load_x8(sx + m * T::kXStride + 8 * kq, a, b);
    xt[(8 * kq + 0) * T::kBM + m] = a.x;
    xt[(8 * kq + 1) * T::kBM + m] = a.y;
    xt[(8 * kq + 2) * T::kBM + m] = a.z;
    xt[(8 * kq + 3) * T::kBM + m] = a.w;
    xt[(8 * kq + 4) * T::kBM + m] = b.x;
    xt[(8 * kq + 5) * T::kBM + m] = b.y;
    xt[(8 * kq + 6) * T::kBM + m] = b.z;
    xt[(8 * kq + 7) * T::kBM + m] = b.w;
  }
  const int c8 = (tid % T::kColGroups) * 8;
  constexpr int kSlots = T::kThreads / T::kColGroups;     // row slots
#pragma unroll
  for (int h = 0; h < T::kRowsPerThread; ++h) {
    const int r = tid / T::kColGroups + kSlots * h, k = k0 + r;
    float w[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (!kSlow || k < k_end) {
      if (kSlow && k >= blk_hi) {
        const int blk = k / block;
        blk_hi = (blk + 1) * block;
        load_scales<kVec, 8>(scales + static_cast<size_t>(blk) * n, n0 + c8,
                             n, sc);
      }
      const uint2 b = *reinterpret_cast<const uint2*>(sq + r * T::kBN + c8);
      dequant4<TX>(b.x, sc, w);
      dequant4<TX>(b.y, sc + 4, w + 4);
    }
    *reinterpret_cast<float4*>(wt + r * T::kBN + c8) =
        make_float4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<float4*>(wt + r * T::kBN + c8 + 4) =
        make_float4(w[4], w[5], w[6], w[7]);
  }
}

template <class T, bool kVec, typename TX>
__device__ __forceinline__ void convert_tile(const unsigned char* st,
                                             unsigned char* buf,
                                             const float* __restrict__ scales,
                                             float (&sc)[8], int& blk_hi,
                                             int n0, int n, int k0, int k_end,
                                             int block) {
  if (k0 + kKT <= k_end && k0 + kKT <= blk_hi)
    convert<T, kVec, false, TX>(st, buf, scales, sc, blk_hi, n0, n, k0,
                                k_end, block);
  else
    convert<T, kVec, true, TX>(st, buf, scales, sc, blk_hi, n0, n, k0, k_end,
                               block);
}

// grid (splits, ceil(N / bn), ceil(M / bm)); as the small kernel. Each
// k-tile is converted once into one of two buffers while the other feeds
// the FMAs, so one barrier a k-tile separates them.
template <int BM, bool kVec, typename TX>
__global__ void __launch_bounds__(Tile<BM, TX>::kThreads, 1)
w8_gemm_large(const TX* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ scales, TX* __restrict__ y,
              int m_rows, int n, int k_dim, int block, int chunk) {
  using T = Tile<BM, TX>;
  constexpr int TM = T::kTM, kCols = 8;          // rows, columns a thread
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* bufs = smem + T::kRingBytes;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.y * T::kBN, m0 = blockIdx.z * T::kBM;
  const int k_begin = blockIdx.x * chunk;
  const int k_end = min(k_dim, k_begin + chunk);
  const int tiles = (k_end - k_begin + kKT - 1) / kKT;

#pragma unroll
  for (int s = 0; s < kLargeStages - 1; ++s) {
    if (s < tiles)
      load_stage<T, kVec>(smem + s * T::kStageBytes, x, q, m0, m_rows, n0, n,
                          k_dim, k_begin + s * kKT, k_end);
    cp_async_commit();
  }
  float acc[TM][kCols];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  float sc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int blk_hi = 0;
  cp_async_wait<kLargeStages - 2>();
  __syncthreads();
  convert_tile<T, kVec, TX>(smem, bufs, scales, sc, blk_hi, n0, n, k_begin,
                            k_end, block);
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kLargeStages - 3>();
    __syncthreads();   // stage t + 1 landed; tile t converted; buffer and
                       // ring slot of tile t - 1 free
    const int tn = t + kLargeStages - 1;
    if (tn < tiles)
      load_stage<T, kVec>(smem + (tn % kLargeStages) * T::kStageBytes, x, q,
                          m0, m_rows, n0, n, k_dim, k_begin + tn * kKT,
                          k_end);
    cp_async_commit();
    if (t + 1 < tiles)
      convert_tile<T, kVec, TX>(
          smem + ((t + 1) % kLargeStages) * T::kStageBytes,
          bufs + ((t + 1) & 1) * T::kBufBytes, scales, sc, blk_hi, n0, n,
          k_begin + (t + 1) * kKT, k_end, block);
    const float* xt =
        reinterpret_cast<const float*>(bufs + (t & 1) * T::kBufBytes);
    const float* wt = xt + kKT * T::kBM;
#pragma unroll 4
    for (int kk = 0; kk < kKT; ++kk) {
      float a[TM], b[kCols];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(xt + kk * T::kBM + ty * TM + i);
        a[i] = v.x;
        a[i + 1] = v.y;
        a[i + 2] = v.z;
        a[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < kCols; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(
            wt + kk * T::kBN + 16 * j + tx * 4);
        b[j] = v.x;
        b[j + 1] = v.y;
        b[j + 2] = v.z;
        b[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // thread (tx, ty): rows ty*TM.., columns tx*4.. and 64 + tx*4..
  const int row0 = m0 + ty * TM;
  if (gridDim.x == 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kCols; j += 4)
        store4<kVec>(y, row0 + i, n0 + 16 * j + tx * 4,
                     make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2],
                                 acc[i][j + 3]),
                     m_rows, n);
    return;
  }
  __syncthreads();           // every thread is past its last read of smem
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kCols; j += 4)
      *reinterpret_cast<float4*>(tile + (ty * TM + i) * T::kBN + 16 * j +
                                 tx * 4) =
          make_float4(acc[i][j], acc[i][j + 1], acc[i][j + 2], acc[i][j + 3]);
  cluster_reduce<kVec, T::kBN>(tile, T::kBM, y, m0, n0, m_rows, n);
}

}  // namespace large

// -- launch --------------------------------------------------------------------

// every kernel the plan can pick, by its rows a CTA and activation type: the
// function, its threads, its shared memory and its columns a CTA
template <int BM, typename TX, bool kVec>
struct Kernel {
  using T = large::Tile<BM, TX>;
  static constexpr int kThreads = T::kThreads, kSmem = T::kSmem;
  static constexpr int kBN = T::kBN;
  static auto fn() { return large::w8_gemm_large<BM, kVec, TX>; }
};
template <typename TX, bool kVec>
struct Kernel<kSmallBM, TX, kVec> {
  static constexpr int kThreads = small::kThreads;
  static constexpr int kSmem = small::Ring<TX>::kSmem;
  static constexpr int kBN = kSmallBN;
  static auto fn() { return small::w8_gemm_small<kVec, TX>; }
};

// per kernel and process: the attributes are set once, and each cluster size
// is checked once against cudaOccupancyMaxActiveClusters
struct LaunchState {
  bool attrs = false;
  bool cluster_ok[kMaxCluster + 1] = {};
};

template <int BM, typename TX, bool kVec>
LaunchState& state_of() {
  static LaunchState state;
  return state;
}

template <int BM, typename TX, bool kVec>
cudaError_t prepare() {
  using K = Kernel<BM, TX, kVec>;
  LaunchState& state = state_of<BM, TX, kVec>();
  if (state.attrs) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      K::fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, K::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        K::fn(), cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) state.attrs = true;
  return err;
}

// a launch of `grid` whose clusters are its splits (grid.x); attr holds the
// cluster dimension the config points to
template <int BM, typename TX, bool kVec>
cudaLaunchConfig_t config(dim3 grid, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  using K = Kernel<BM, TX, kVec>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(K::kThreads);
  cfg.dynamicSmemBytes = K::kSmem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = grid.x;       // the splits of one output tile
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int BM, typename TX, bool kVec>
cudaError_t launch(const TX* x, const int8_t* q, const float* s, TX* y,
                   int m_rows, int n, int k_dim, int block, int chunk,
                   int splits, cudaStream_t stream) {
  using K = Kernel<BM, TX, kVec>;
  cudaError_t err = prepare<BM, TX, kVec>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config<BM, TX, kVec>(
      dim3(splits, (n + K::kBN - 1) / K::kBN, (m_rows + BM - 1) / BM),
      stream, &attr);
  if (splits == 1) cfg.numAttrs = 0;
  LaunchState& state = state_of<BM, TX, kVec>();
  if (splits > 1 && !state.cluster_ok[splits]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, K::fn(), &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    state.cluster_ok[splits] = true;
  }
  return cudaLaunchKernelEx(&cfg, K::fn(), x, q, s, y, m_rows, n, k_dim,
                            block, chunk);
}

// the CTAs that grids of clusters of `splits` run at once
template <int BM, bool kVec>
cudaError_t cluster_ctas(int splits, int* ctas) {
  cudaError_t err = prepare<BM, float, kVec>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config<BM, float, kVec>(dim3(splits), nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, Kernel<BM, float, kVec>::fn(), &cfg);
  *ctas = clusters * splits;
  return err;
}

template <typename TX, bool kVec>
cudaError_t dispatch(const TX* x, const int8_t* q, const float* s, TX* y,
                     int m_rows, int n, int k_dim, int block, int bm,
                     int chunk, int splits, cudaStream_t stream) {
  if (bm == kSmallBM)
    return launch<kSmallBM, TX, kVec>(x, q, s, y, m_rows, n, k_dim, block,
                                      chunk, splits, stream);
  if (bm == 64)
    return launch<64, TX, kVec>(x, q, s, y, m_rows, n, k_dim, block, chunk,
                                splits, stream);
  return launch<128, TX, kVec>(x, q, s, y, m_rows, n, k_dim, block, chunk,
                               splits, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// both C entry points: check the plan, pick the vector path, launch
template <typename TX>
int gemm(const void* x, const void* q, const void* scales, void* y,
         int m_rows, int n, int k_dim, int block, int bm, int chunk,
         int splits, void* stream) {
  if (m_rows < 1 || n < 1 || k_dim < 1 || block < 1 || k_dim % block ||
      (bm != kSmallBM && bm != 64 && bm != 128) || chunk < 1 ||
      chunk % (bm == kSmallBM ? kSmallKT : kKT) || splits < 1 ||
      splits > kMaxCluster || splits != (k_dim + chunk - 1) / chunk ||
      (n + kSmallBN - 1) / kSmallBN > 65535 || (m_rows + bm - 1) / bm > 65535)
    return cudaErrorInvalidValue;
  const bool vec = n % 16 == 0 && k_dim % Act<TX>::kVec == 0 &&
                   aligned16(x) && aligned16(q) && aligned16(scales) &&
                   aligned16(y);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xt = static_cast<const TX*>(x);
  const auto* qi = static_cast<const int8_t*>(q);
  const auto* sf = static_cast<const float*>(scales);
  auto* yt = static_cast<TX*>(y);
  const cudaError_t err =
      vec ? dispatch<TX, true>(xt, qi, sf, yt, m_rows, n, k_dim, block, bm,
                               chunk, splits, st)
          : dispatch<TX, false>(xt, qi, sf, yt, m_rows, n, k_dim, block, bm,
                                chunk, splits, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [M, K] fp32, q [K, N] int8, scales [K / block, N] fp32, y [M, N] fp32,
// all contiguous. The plan (kernels/quant.py w8_plan): bm = 16 (small M),
// 64 or 128 rows a CTA; K cut into `splits` chunks of `chunk` rows (a
// multiple of kSmallKT or kKT, splits == ceil(K / chunk) <= 16), the
// splits of a tile one cluster. No scratch: y is written once. Returns the
// launch's cudaError_t.
int pt_w8_gemm(const void* x, const void* q, const void* scales, void* y,
               int m_rows, int n, int k_dim, int block, int bm, int chunk,
               int splits, void* stream) {
  return gemm<float>(x, q, scales, y, m_rows, n, k_dim, block, bm, chunk,
                     splits, stream);
}

// The bf16 mode: x [M, K] and y [M, N] bf16, q and scales as above, the
// same plan. Each weight is rounded to bf16 once, the sums run in fp32 and
// y is rounded to bf16 once.
int pt_w8_gemm_bf16(const void* x, const void* q, const void* scales,
                    void* y, int m_rows, int n, int k_dim, int block, int bm,
                    int chunk, int splits, void* stream) {
  return gemm<bf16>(x, q, scales, y, m_rows, n, k_dim, block, bm, chunk,
                    splits, stream);
}

// The CTAs that a grid of the kernel for `bm` (16, 64 or 128; vector path
// if `vec`) runs at once when its clusters hold `splits` CTAs, written to
// *ctas: cudaOccupancyMaxActiveClusters x splits. The plan's cost table
// (kernels/quant.py W8_CLUSTER_SMS) is this, on an H100 SXM.
int pt_w8_cluster_ctas(int bm, int splits, int vec, void* ctas) {
  if ((bm != kSmallBM && bm != 64 && bm != 128) || splits < 1 ||
      splits > kMaxCluster || ctas == nullptr)
    return cudaErrorInvalidValue;
  int* out = static_cast<int*>(ctas);
  if (bm == kSmallBM)
    return vec ? cluster_ctas<kSmallBM, true>(splits, out)
               : cluster_ctas<kSmallBM, false>(splits, out);
  if (bm == 64)
    return vec ? cluster_ctas<64, true>(splits, out)
               : cluster_ctas<64, false>(splits, out);
  return vec ? cluster_ctas<128, true>(splits, out)
             : cluster_ctas<128, false>(splits, out);
}

}  // extern "C"
