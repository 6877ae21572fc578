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
// fp32 scales). It replaces no Pallas kernel either: for a bf16 model the
// reference dequantizes to bf16 inside its traced step
// (paddle_tpu/serving/engine.py:1073-1089, dequantize_int8_weight(q, s,
// bf16)) and XLA fuses that into a bf16 matmul. Numerics: each weight
// element is q * s in fp32 rounded once to bf16 (the reference's bits), the
// exact bf16 x bf16 products are summed in fp32 on the tensor cores,
// split-K partials meet in fp32 in rank order (the fp32 mode's cluster
// reduction), and y is rounded once to bf16 at the store; no atomics.
//
// float16 mode (pt_w8_gemm_f16: float16 x and y, for a float16 model,
// whose weight-only decode the reference serves through
// dequantize_int8_weight(q, s, float16) and a float16 matmul): the bf16
// mode's kernels with another 16-bit type TX (a template parameter of
// every tensor-core kernel, bf16 or __half), mma.sync ... .f32.f16.f16.f32
// and wgmma ... .f32.f16.f16 in place of the bf16 forms, each weight q * s
// rounded once to float16, fp32 sums, y rounded once to float16 (past
// 65504 to inf: nothing is clamped). Its plan is the bf16 mode's
// (w8_plan_bf16): the kernels' tiles, shared memory and registers are the
// same.
//
// What bounds it (llama1b, one layer's 7 projections): at the decode batch
// (M = 16) the 50.6 MB of int8 planes, 0.015 ms at 3.35 TB/s (1.6 GFLOP is
// nothing to the tensor cores), and each launch's fixed cost (the first
// loads, the cluster reduction); at the mixed step (M = 256) the 25.9
// GFLOP, 0.026 ms at the 989 TFLOP/s bf16 peak, which wgmma nears and
// mma.sync does not (measured on this card: ~930 FLOP a clock an SM
// through mma.sync, a quarter of the peak). Both kernels stage x and q
// through a ring of 16-byte cp.async copies (64 k rows a stage), dequantize
// each int8 value once a CTA with the fp32 mode's byte trick, reload
// scales only when a stage opens the next block (a block of whole stages
// has its next block's scales loaded a block ahead, so no stage waits on
// them), and zero a k row past the split's end (scale 0, q byte 0).
//
//  * M <= 32 (namespace tc, bm = 16 or 32): 4 warps a CTA, each (16 MI) x
//    32 of a bm x 128 tile, mma.sync.m16n8k16. The int8 tile is never
//    widened in shared memory: ldmatrix.trans over it as 16-bit pairs
//    hands each lane a 2 x 2 block of bytes (k rows 2t, 2t + 1 of columns
//    c, c + 1), which the byte permute turns into the bf16 k-pairs of two
//    B fragments at once, one for the even columns of a 16-column group
//    and one for the odd; a lane's accumulators then hold 4 consecutive
//    columns, stored as one 8-byte write. Shared memory carries one byte a
//    weight each way. The weight stream is the cost, so the plan
//    (kernels/quant.py w8_plan_bf16) cuts K over a cluster until ~every SM
//    streams its share, four CTAs an SM.
//  * M > 32 (namespace wg, bm = 64 or 128): the product is taken as y^T =
//    w^T x^T, so that the weight is wgmma's A operand, which may come from
//    registers: two warpgroups own the tile's 128 columns (64 each, a
//    warp 16), and each warp builds its A fragments of a stage straight
//    from the int8 tile with the same ldmatrix.trans and byte permute
//    (the even columns of its 16 as logical rows g, the odd as g + 8), no
//    bf16 copy in shared memory. x, wgmma's B (K-major, bm rows as the
//    products' n), is copied straight into the 128-byte-swizzled layout
//    TMA would write and fenced to the async proxy; each warpgroup issues
//    4 m64nBMk16 products a stage. Two sets of A registers alternate by
//    stage, so a stage's dequantization runs while the previous stage's
//    products do, and each weight is dequantized once a CTA. bm = 64 runs
//    two CTAs an SM (128 registers); bm = 128 one, whose two register sets
//    need 141. (A first version, the weight as B through a dequantized
//    bf16 tile in shared memory, ran at ~1100 FLOP a clock an SM, little
//    above mma.sync; waiting for each stage's products before the next
//    dequantization cost ~10 %.) The plan splits K over a cluster where
//    the output tiles alone leave SMs idle (32 tiles of 128 x 128 at N =
//    2048, M = 256).
// Ragged edges and unaligned operands take the fp32 mode's rules (kVec =
// false: plain loads into the same tiles).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

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
constexpr int kXStride = kKT + 4;     // floats a staged x row, large M

// x rounded once to the 16-bit type T (bf16 or __half)
template <typename T>
__device__ __forceinline__ T round16(float x) {
  if constexpr (ptwg::is_f16<T>)
    return __float2half_rn(x);
  else
    return __float2bfloat16_rn(x);
}

// 8 consecutive staged x values (16-byte aligned)
__device__ __forceinline__ void load_x8(const float* p, float4& a,
                                        float4& b) {
  a = *reinterpret_cast<const float4*>(p);
  b = *reinterpret_cast<const float4*>(p + 4);
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
__device__ __forceinline__ void dequant4(uint32_t word, const float* sc,
                                         float* w) {
  const uint32_t b = word ^ 0x80808080u;
  w[0] = i8f(b, 0x7540) * sc[0];
  w[1] = i8f(b, 0x7541) * sc[1];
  w[2] = i8f(b, 0x7542) * sc[2];
  w[3] = i8f(b, 0x7543) * sc[3];
}

// v at y[row, col..col + 3], masked to M and N; a bf16 or float16 y
// rounds each value once here
template <bool kVec, typename TY>
__device__ __forceinline__ void store4(TY* __restrict__ y, int row, int col,
                                       float4 v, int m_rows, int n) {
  if (row >= m_rows) return;
  TY* p = y + static_cast<size_t>(row) * n + col;
  if constexpr (sizeof(TY) == 2) {
    if constexpr (kVec) {
      if (col < n)
        *reinterpret_cast<uint2*>(p) = make_uint2(
            ptwg::pack2<TY>(v.x, v.y), ptwg::pack2<TY>(v.z, v.w));
    } else {
      if (col < n) p[0] = round16<TY>(v.x);
      if (col + 1 < n) p[1] = round16<TY>(v.y);
      if (col + 2 < n) p[2] = round16<TY>(v.z);
      if (col + 3 < n) p[3] = round16<TY>(v.w);
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
template <bool kVec, int kCols, typename TY>
__device__ __forceinline__ void cluster_reduce(float* tile, int rows,
                                               TY* __restrict__ y, int m0,
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

constexpr int kXBytes = kSmallBM * kSmallRows * 4;           // x [16][8]
constexpr int kQBytes = kSmallRows * kSmallBN;               // q [8][128]
constexpr int kStepBytes = kXBytes + kQBytes;
constexpr int kWarpRing = kSmallStages * kStepBytes;         // a warp's
constexpr int kRingBytes = kSmallWarps * kWarpRing;
constexpr int kSmem =
    (kRingBytes > kRedBytes ? kRingBytes : kRedBytes) + kTileBytes;
constexpr int kXCopies = kSmallBM * kSmallRows / 4;
static_assert(kXBytes % 16 == 0 && kXCopies <= 32,
              "a step's x is whole 16-byte copies, one a lane at most");

// one warp's step: x[m0.., k0..k0 + 8) and q[k0..k0 + 8, n0..), rows at
// or past `end` zero-filled
template <bool kVec>
__device__ __forceinline__ void load_step(unsigned char* st,
                                          const float* __restrict__ x,
                                          const int8_t* __restrict__ q,
                                          int m0, int m_rows, int n0, int n,
                                          int k_dim, int k0, int end) {
  float* sx = reinterpret_cast<float*>(st);
  int8_t* sq = reinterpret_cast<int8_t*>(st + kXBytes);
  const int lane = threadIdx.x & 31;
  if constexpr (kVec) {
    if (lane < kXCopies) {
      constexpr int kPerRow = kSmallRows / 4;             // copies a row
      const int r = lane / kPerRow, c = (lane % kPerRow) * 4;
      const bool ok = m0 + r < m_rows && k0 + c < end;
      cp_async16(sx + r * kSmallRows + c,
                 ok ? x + static_cast<size_t>(m0 + r) * k_dim + k0 + c : x,
                 ok);
    }
#pragma unroll
    for (int i = 0; i < kQBytes / 16 / 32; ++i) {
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
          ? x[static_cast<size_t>(m0 + r) * k_dim + k0 + c] : 0.f;
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
template <bool kVec, bool kSlow>
__device__ __forceinline__ void step(const unsigned char* st,
                                     const float* __restrict__ scales,
                                     float (&acc)[kSmallBM][4],
                                     float (&sc)[4], int& blk_hi, int k,
                                     int end, int block, int col, int n) {
  const int lane = threadIdx.x & 31;
  const float* sx = reinterpret_cast<const float*>(st);
  const int8_t* sq = reinterpret_cast<const int8_t*>(st + kXBytes) + lane * 4;
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
    dequant4(*reinterpret_cast<const uint32_t*>(sq + j * kSmallBN), sc,
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
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
w8_gemm_small(const float* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ scales, float* __restrict__ y,
              int m_rows, int n, int k_dim, int block, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * kSmallBN, m0 = blockIdx.z * kSmallBM;
  const int per = chunk / kSmallWarps;            // a multiple of kSmallRows
  const int k_begin = min(k_dim, blockIdx.x * chunk + warp * per);
  const int end = min(k_dim, k_begin + per);
  const int steps = (end - k_begin + kSmallRows - 1) / kSmallRows;
  const int col = n0 + lane * 4;
  unsigned char* ring = smem + warp * kWarpRing;

#pragma unroll
  for (int s = 0; s < kSmallStages - 1; ++s) {
    if (s < steps)
      load_step<kVec>(ring + s * kStepBytes, x, q, m0, m_rows, n0, n, k_dim,
                      k_begin + s * kSmallRows, end);
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
      load_step<kVec>(ring + (tn % kSmallStages) * kStepBytes, x, q, m0,
                      m_rows, n0, n, k_dim, k_begin + tn * kSmallRows, end);
    cp_async_commit();
    const unsigned char* st = ring + (t % kSmallStages) * kStepBytes;
    const int k = k_begin + t * kSmallRows;
    if (k + kSmallRows <= end && k + kSmallRows <= blk_hi)
      step<kVec, false>(st, scales, acc, sc, blk_hi, k, end, block, col, n);
    else
      step<kVec, true>(st, scales, acc, sc, blk_hi, k, end, block, col, n);
  }
  cp_async_wait<0>();

  // the warps' partials summed in warp order into the CTA's tile
  float* red = reinterpret_cast<float*>(smem);
  float* tile = reinterpret_cast<float*>(smem + kSmem - kTileBytes);
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

// BM rows x 128 columns a CTA, a (BM / 16) x 8 micro-tile a thread
template <int BM>
struct Tile {
  static constexpr int kBM = BM;
  static constexpr int kBN = kLargeBN;
  static constexpr int kTM = BM / 16;                     // rows a thread
  static constexpr int kThreads = 256;
  static constexpr int kXV = 4;                           // x values a copy
  static constexpr int kXBytes = kBM * kXStride * 4;      // x [bm][stride]
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

template <class T, bool kVec>
__device__ __forceinline__ void load_stage(unsigned char* st,
                                           const float* __restrict__ x,
                                           const int8_t* __restrict__ q,
                                           int m0, int m_rows, int n0, int n,
                                           int k_dim, int k0, int k_end) {
  float* sx = reinterpret_cast<float*>(st);
  int8_t* sq = reinterpret_cast<int8_t*>(st + T::kXBytes);
  const int tid = threadIdx.x;
  if constexpr (kVec) {
    constexpr int kPerRow = kKT / T::kXV;          // copies a staged x row
#pragma unroll
    for (int i = 0; i < T::kBM * kKT / T::kXV / T::kThreads; ++i) {
      const int idx = tid + i * T::kThreads;
      const int r = idx / kPerRow, c = (idx % kPerRow) * T::kXV;
      const bool ok = m0 + r < m_rows && k0 + c < k_end;
      cp_async16(sx + r * kXStride + c,
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
      sx[r * kXStride + c] = m0 + r < m_rows && k0 + c < k_end
          ? x[static_cast<size_t>(m0 + r) * k_dim + k0 + c] : 0.f;
    }
    for (int i = tid; i < kKT * T::kBN; i += T::kThreads) {
      const int r = i / T::kBN, c = i % T::kBN;
      sq[i] = k0 + r < k_end && n0 + c < n
          ? q[static_cast<size_t>(k0 + r) * n + n0 + c] : int8_t(0);
    }
  }
}

// stage -> x^T [32][bm] in fp32 and the dequantized w [32][bn] (buf); a
// thread converts kRowsPerThread rows of 8 columns, c8.., and keeps their
// scales. kSlow: a row is past k_end (w = 0) or enters the next block.
template <class T, bool kVec, bool kSlow>
__device__ __forceinline__ void convert(const unsigned char* st,
                                        unsigned char* buf,
                                        const float* __restrict__ scales,
                                        float (&sc)[8], int& blk_hi, int n0,
                                        int n, int k0, int k_end, int block) {
  const int tid = threadIdx.x;
  const float* sx = reinterpret_cast<const float*>(st);
  const int8_t* sq = reinterpret_cast<const int8_t*>(st + T::kXBytes);
  float* xt = reinterpret_cast<float*>(buf);
  float* wt = reinterpret_cast<float*>(buf + T::kXTBytes);
  constexpr int kXPer = T::kBM * kKT / 8 / T::kThreads;   // 8 values each
  const int m = tid % T::kBM;
#pragma unroll
  for (int i = 0; i < kXPer; ++i) {
    const int kq = tid / T::kBM + i * (T::kThreads / T::kBM);
    float4 a, b;
    load_x8(sx + m * kXStride + 8 * kq, a, b);
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
      dequant4(b.x, sc, w);
      dequant4(b.y, sc + 4, w + 4);
    }
    *reinterpret_cast<float4*>(wt + r * T::kBN + c8) =
        make_float4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<float4*>(wt + r * T::kBN + c8 + 4) =
        make_float4(w[4], w[5], w[6], w[7]);
  }
}

template <class T, bool kVec>
__device__ __forceinline__ void convert_tile(const unsigned char* st,
                                             unsigned char* buf,
                                             const float* __restrict__ scales,
                                             float (&sc)[8], int& blk_hi,
                                             int n0, int n, int k0, int k_end,
                                             int block) {
  if (k0 + kKT <= k_end && k0 + kKT <= blk_hi)
    convert<T, kVec, false>(st, buf, scales, sc, blk_hi, n0, n, k0, k_end,
                            block);
  else
    convert<T, kVec, true>(st, buf, scales, sc, blk_hi, n0, n, k0, k_end,
                           block);
}

// grid (splits, ceil(N / bn), ceil(M / bm)); as the small kernel. Each
// k-tile is converted once into one of two buffers while the other feeds
// the FMAs, so one barrier a k-tile separates them.
template <int BM, bool kVec>
__global__ void __launch_bounds__(Tile<BM>::kThreads, 1)
w8_gemm_large(const float* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ scales, float* __restrict__ y,
              int m_rows, int n, int k_dim, int block, int chunk) {
  using T = Tile<BM>;
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
  convert_tile<T, kVec>(smem, bufs, scales, sc, blk_hi, n0, n, k_begin,
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
      convert_tile<T, kVec>(
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

// -- bf16 and float16 modes, M <= 32: mma.sync -> fp32, int8 B fragments by
// ldmatrix (TX, the activations' type, is bf16 or __half) --

namespace tc {

constexpr int kBN = 128;               // columns a CTA: 4 warps of 32
constexpr int kWarps = 4;
constexpr int kBK = 64;                // k rows a stage (a chunk's granule)
constexpr int kStages = 4;
constexpr int kXLd = kBK + 8;          // bf16 a staged x row: 144 bytes
constexpr int kQLd = kBN + 16;         // bytes a staged q row: 144

// 4 warps own a (16 MI) x kBN tile, each warp (16 MI) x 32 of it
template <int MI>
struct Tile {
  static constexpr int kBM = 16 * MI;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kXBytes = kBM * kXLd * 2;           // x [bm][kXLd]
  static constexpr int kQBytes = kBK * kQLd;               // q [64][kQLd]
  static constexpr int kStageBytes = kXBytes + kQBytes;
  static constexpr int kSmem = kStages * kStageBytes;
  static_assert(kBM * kBN * 4 <= kSmem, "the partial tile fits the ring");
  static_assert(kXBytes % 16 == 0 && kBM * kBK / 8 % kThreads == 0,
                "every thread copies whole 16-byte shares of a stage");
};

// q[k0..k0 + 64, n0..n0 + 128) into a padded int8 tile [64][kQLd] by
// kThreads threads, rows past k_end and columns past N zero-filled
template <int kThreads, bool kVec>
__device__ __forceinline__ void load_q(int8_t* sq,
                                       const int8_t* __restrict__ q, int n0,
                                       int n, int k0, int k_end) {
  static_assert(kBK * kBN / 16 % kThreads == 0, "whole 16-byte shares");
  const int tid = threadIdx.x;
  if constexpr (kVec) {
#pragma unroll
    for (int i = 0; i < kBK * kBN / 16 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kBN / 16), c = (idx % (kBN / 16)) * 16;
      const bool ok = k0 + r < k_end && n0 + c < n;
      cp_async16(sq + r * kQLd + c,
                 ok ? q + static_cast<size_t>(k0 + r) * n + n0 + c : q, ok);
    }
  } else {
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      sq[r * kQLd + c] = k0 + r < k_end && n0 + c < n
          ? q[static_cast<size_t>(k0 + r) * n + n0 + c] : int8_t(0);
    }
  }
}

template <class T, bool kVec, typename TX>
__device__ __forceinline__ void load_stage(unsigned char* st,
                                           const TX* __restrict__ x,
                                           const int8_t* __restrict__ q,
                                           int m0, int m_rows, int n0, int n,
                                           int k_dim, int k0, int k_end) {
  TX* sx = reinterpret_cast<TX*>(st);
  const int tid = threadIdx.x;
  if constexpr (kVec) {
#pragma unroll
    for (int i = 0; i < T::kBM * kBK / 8 / T::kThreads; ++i) {
      const int idx = tid + i * T::kThreads;
      const int r = idx / (kBK / 8), c = (idx % (kBK / 8)) * 8;
      const bool ok = m0 + r < m_rows && k0 + c < k_end;
      cp_async16(sx + r * kXLd + c,
                 ok ? x + static_cast<size_t>(m0 + r) * k_dim + k0 + c : x,
                 ok);
    }
  } else {
    for (int i = tid; i < T::kBM * kBK; i += T::kThreads) {
      const int r = i / kBK, c = i % kBK;
      sx[r * kXLd + c] = m0 + r < m_rows && k0 + c < k_end
          ? x[static_cast<size_t>(m0 + r) * k_dim + k0 + c]
          : round16<TX>(0.f);
    }
  }
  load_q<T::kThreads, kVec>(reinterpret_cast<int8_t*>(st + T::kXBytes), q,
                            n0, n, k0, k_end);
}

// A word that ldmatrix.trans read from the int8 tile as 16-bit pairs holds
// q[k][c], q[k][c + 1], q[k + 1][c], q[k + 1][c + 1] (low byte first): the
// TX k-pairs of column c (scale s[0]) and column c + 1 (s[1]), each value
// q * s in fp32 rounded once to TX.
template <typename TX>
__device__ __forceinline__ void dequant_pairs(uint32_t word,
                                              const float (&s)[2],
                                              uint32_t& even,
                                              uint32_t& odd) {
  const uint32_t b = word ^ 0x80808080u;
  even = ptwg::pack2<TX>(i8f(b, 0x7540) * s[0], i8f(b, 0x7542) * s[0]);
  odd = ptwg::pack2<TX>(i8f(b, 0x7541) * s[1], i8f(b, 0x7543) * s[1]);
}

// the scales of columns col, col + 1 in scale row blk, 0 past N
template <bool kVec>
__device__ __forceinline__ void load_col_scales(
    const float* __restrict__ scales, int blk, int col, int n,
    float (&sc)[2]) {
  const float* s = scales + static_cast<size_t>(blk) * n;
  if constexpr (kVec) {
    const float2 v = col < n
        ? __ldg(reinterpret_cast<const float2*>(s + col))
        : make_float2(0.f, 0.f);
    sc[0] = v.x;
    sc[1] = v.y;
  } else {
    sc[0] = col < n ? s[col] : 0.f;
    sc[1] = col + 1 < n ? s[col + 1] : 0.f;
  }
}

// the scales of this lane's columns col, col + 1 (h = 0) and col + 16,
// col + 17 (h = 1)
template <bool kVec>
__device__ __forceinline__ void load_pair_scales(
    const float* __restrict__ scales, int blk, int col, int n,
    float (&sc)[2][2]) {
  load_col_scales<kVec>(scales, blk, col, n, sc[0]);
  load_col_scales<kVec>(scales, blk, col + 16, n, sc[1]);
}

// One stage of a warp: for each 16-row k step, the A fragments of its MI
// row tiles (ldmatrix), its 16 x 32 int8 slice (one ldmatrix.x4.trans:
// word i = 2h + kh covers k rows 8 kh.., columns 16 h..), dequantized into
// the B fragments of 4 n8 tiles (h, even / odd columns), and 4 MI mma.
// acc[mi][h][p] holds rows g, g + 8 and logical columns 2t, 2t + 1 of tile
// (h, p): actual columns 16 h + 4t + p and 16 h + 4t + 2 + p. kSlow: a k
// row of the stage is past k_end (scale 0, q byte 0) or, in a block
// smaller than a stage, enters the next block (reload the lane's scales).
// The x tile holds TX; ldmatrix moves its 16-bit values whatever the type.
template <typename TX, class T, int MI, bool kVec, bool kSlow>
__device__ __forceinline__ void mma_stage(
    const unsigned char* st, const float* __restrict__ scales,
    float (&acc)[MI][2][2][4], float (&sc)[2][2], int& blk_hi, int k0,
    int k_end, int block, int n, int col, int col_b) {
  const bf16* sx = reinterpret_cast<const bf16*>(st);
  const int8_t* sq = reinterpret_cast<const int8_t*>(st + T::kXBytes);
  const int lane = threadIdx.x & 31;
  const int8_t* b_row =
      sq + ((lane & 7) + ((lane >> 3) & 1) * 8) * kQLd + col_b +
      (lane >> 4) * 16;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      ptmma::load_a<true>(a[mi], sx, kXLd, 16 * mi, kk, lane);
    uint32_t r[4];
    ptmma::ldmatrix_x4_trans(r, b_row + kk * kQLd);
    uint32_t b[2][2][2];                  // [h][even / odd][k half]
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      float s[2][2];
      if (kSlow) {
        const int row = k0 + kk + 8 * kh;
        if (row < k_end && row >= blk_hi) {
          const int blk = row / block;
          blk_hi = (blk + 1) * block;
          load_pair_scales<kVec>(scales, blk, col, n, sc);
        }
        const bool live = row < k_end;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[h][0] = live ? sc[h][0] : 0.f;
          s[h][1] = live ? sc[h][1] : 0.f;
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[h][0] = sc[h][0];
          s[h][1] = sc[h][1];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        dequant_pairs<TX>(r[2 * h + kh], s[h], b[h][0][kh], b[h][1][kh]);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          if constexpr (ptwg::is_f16<TX>)
            ptmma::mma_f16(acc[mi][h][p], a[mi], b[h][p][0], b[h][p][1]);
          else
            ptmma::mma_bf16(acc[mi][h][p], a[mi], b[h][p][0], b[h][p][1]);
  }
}

// grid (splits, ceil(N / 128), ceil(M / bm)); split z takes k rows
// [z * chunk, min(K, (z + 1) * chunk)) through the ring; the `splits` CTAs
// of a tile are one cluster, summed by cluster_reduce
template <int MI, bool kVec, typename TX>
__global__ void __launch_bounds__(Tile<MI>::kThreads, 4)
w8_gemm_mma(const TX* __restrict__ x, const int8_t* __restrict__ q,
            const float* __restrict__ scales, TX* __restrict__ y,
            int m_rows, int n, int k_dim, int block, int chunk) {
  using T = Tile<MI>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * kBN, m0 = blockIdx.z * T::kBM;
  const int k_begin = blockIdx.x * chunk;
  const int k_end = min(k_dim, k_begin + chunk);
  const int tiles = (k_end - k_begin + kBK - 1) / kBK;
  const int col_b = warp * 32;
  const int col = n0 + col_b + 2 * (lane >> 2);  // scales: col, +1, +16, +17

  // sc: the scales of the block of k_begin, blk_hi the first row past it.
  // A block of whole stages (b a multiple of kBK) never splits a stage, so
  // the next block's scales (sn) are loaded a block ahead and a stage that
  // opens a block takes them without waiting; smaller blocks reload in
  // the stage (mma_stage's kSlow path).
  float sc[2][2], sn[2][2];
  int blk_hi = (k_begin / block + 1) * block;
  const bool ahead = block % kBK == 0;
  load_pair_scales<kVec>(scales, k_begin / block, col, n, sc);
  if (ahead && blk_hi < k_end)
    load_pair_scales<kVec>(scales, blk_hi / block, col, n, sn);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles)
      load_stage<T, kVec>(smem + s * T::kStageBytes, x, q, m0, m_rows, n0, n,
                          k_dim, k_begin + s * kBK, k_end);
    cp_async_commit();
  }
  float acc[MI][2][2][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][h][p][e] = 0.f;
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                 // stage t landed; slot t - 1 is free
    const int tn = t + kStages - 1;
    if (tn < tiles)
      load_stage<T, kVec>(smem + (tn % kStages) * T::kStageBytes, x, q, m0,
                          m_rows, n0, n, k_dim, k_begin + tn * kBK, k_end);
    cp_async_commit();
    const unsigned char* st = smem + (t % kStages) * T::kStageBytes;
    const int k0 = k_begin + t * kBK;
    if (ahead && k0 >= blk_hi) {     // the stage opens the next block
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sc[h][0] = sn[h][0];
        sc[h][1] = sn[h][1];
      }
      blk_hi += block;
      if (blk_hi < k_end)
        load_pair_scales<kVec>(scales, blk_hi / block, col, n, sn);
    }
    if (k0 + kBK <= k_end && k0 + kBK <= blk_hi)
      mma_stage<TX, T, MI, kVec, false>(st, scales, acc, sc, blk_hi, k0,
                                        k_end, block, n, col, col_b);
    else
      mma_stage<TX, T, MI, kVec, true>(st, scales, acc, sc, blk_hi, k0,
                                       k_end, block, n, col, col_b);
  }
  cp_async_wait<0>();

  // lane (g, t): rows g and g + 8 of each row tile, columns 16 h + 4t..+3
  const int g = lane >> 2, c4 = 4 * (lane & 3);
  if (gridDim.x == 1) {
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float(&ev)[4] = acc[mi][h][0];
          const float(&od)[4] = acc[mi][h][1];
          store4<kVec>(y, m0 + 16 * mi + g + 8 * e, n0 + col_b + 16 * h + c4,
                       make_float4(ev[2 * e], od[2 * e], ev[2 * e + 1],
                                   od[2 * e + 1]),
                       m_rows, n);
        }
    return;
  }
  __syncthreads();           // every thread is past its last read of smem
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float(&ev)[4] = acc[mi][h][0];
        const float(&od)[4] = acc[mi][h][1];
        *reinterpret_cast<float4*>(tile + (16 * mi + g + 8 * e) * kBN +
                                   col_b + 16 * h + c4) =
            make_float4(ev[2 * e], od[2 * e], ev[2 * e + 1], od[2 * e + 1]);
      }
  cluster_reduce<kVec, kBN>(tile, T::kBM, y, m0, n0, m_rows, n);
}

}  // namespace tc

// -- bf16 and float16 modes, M > 32: wgmma on y^T = w^T x^T, w from
// registers ---------------------------------------------------------------

namespace wg {

constexpr int kBox = 64 * 128;         // a 64-row box of 128-byte rows

// the 16-byte chunk c of row r of a box in 128-byte swizzle: TMA's layout,
// which wgmma's descriptor (layout type 1) undoes
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps `a` live (and in its registers) until here: a wgmma reading them
// from registers has not finished before its wait
__device__ __forceinline__ void keep(const uint32_t (&a)[2][2][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        asm volatile("" ::"r"(a[h][s][i]) : "memory");
}

// a, b at y[row, col..col + 1], masked to M and N, each rounded once
template <bool kVec, typename TX>
__device__ __forceinline__ void store2(TX* __restrict__ y, int row, int col,
                                       float a, float b, int m_rows, int n) {
  if (row >= m_rows) return;
  TX* p = y + static_cast<size_t>(row) * n + col;
  if constexpr (kVec) {
    if (col < n) *reinterpret_cast<uint32_t*>(p) = ptwg::pack2<TX>(a, b);
  } else {
    if (col < n) p[0] = round16<TX>(a);
    if (col + 1 < n) p[1] = round16<TX>(b);
  }
}

// Two warpgroups own the 128 columns of a tile, warpgroup g columns
// 64 g.., warp w of it 16 w..; BM x rows (64 or 128) are the products' n.
// Shared memory (1024-aligned): the ring of stages, each x [BM][64] (bf16
// or float16) in 128-byte swizzle (wgmma's B, K-major) and q [64][kQLd].
template <int BM>
struct Tile {
  static constexpr int kBM = BM;
  static constexpr int kThreads = 256;
  static constexpr int kStages = 4;
  static constexpr int kXBytes = BM * 128;
  static constexpr int kQBytes = tc::kBK * tc::kQLd;
  static constexpr int kStageBytes = kXBytes + kQBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024;
  static_assert(kXBytes % 1024 == 0 && kQBytes % 1024 == 0,
                "every x tile stays 1024-aligned");
  static_assert(BM * tc::kBN * 4 <= kSmem - 1024, "the partial tile fits");
  static_assert(BM * 8 % kThreads == 0, "whole 16-byte shares of x");
};

template <class T, bool kVec, typename TX>
__device__ __forceinline__ void load_stage(unsigned char* st,
                                           const TX* __restrict__ x,
                                           const int8_t* __restrict__ q,
                                           int m0, int m_rows, int n0, int n,
                                           int k_dim, int k0, int k_end) {
  const int tid = threadIdx.x;
  if constexpr (kVec) {
#pragma unroll
    for (int i = 0; i < T::kBM * 8 / T::kThreads; ++i) {
      const int idx = tid + i * T::kThreads;
      const int r = idx >> 3, c = idx & 7;
      const bool ok = m0 + r < m_rows && k0 + 8 * c < k_end;
      cp_async16(st + swz(r, c),
                 ok ? x + static_cast<size_t>(m0 + r) * k_dim + k0 + 8 * c
                    : x,
                 ok);
    }
  } else {
    for (int i = tid; i < T::kBM * tc::kBK; i += T::kThreads) {
      const int r = i / tc::kBK, k = i % tc::kBK;
      *reinterpret_cast<TX*>(st + swz(r, k >> 3) + 2 * (k & 7)) =
          m0 + r < m_rows && k0 + k < k_end
              ? x[static_cast<size_t>(m0 + r) * k_dim + k0 + k]
              : round16<TX>(0.f);
    }
  }
  tc::load_q<T::kThreads, kVec>(reinterpret_cast<int8_t*>(st + T::kXBytes),
                                q, n0, n, k0, k_end);
}

// A warp's A fragments (m16 x k16, the m16n8k16 A layout) of half a
// stage, k16 slices 2 half and 2 half + 1: its 16 columns of the int8
// tile through one ldmatrix.x4.trans (word i covers k rows 32 half + 8i..),
// each word dequantized into the even columns (logical rows g: column 2g)
// and the odd ones (rows g + 8: column 2g + 1). kSlow: a k row of the
// stage is past k_end (scale 0, q byte 0) or, in a block smaller than a
// stage, enters the next block.
template <typename TX, bool kVec, bool kSlow>
__device__ __forceinline__ void a_frags(const int8_t* sq, int col_q, int half,
                                        const float* __restrict__ scales,
                                        float (&sc)[2], int& blk_hi, int k0,
                                        int k_end, int block, int n, int col,
                                        uint32_t (&a)[2][4]) {
  const int lane = threadIdx.x & 31;
  uint32_t r[4];
  ptmma::ldmatrix_x4_trans(
      r, sq + (32 * half + 8 * (lane >> 3) + (lane & 7)) * tc::kQLd + col_q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float s[2] = {sc[0], sc[1]};
    if (kSlow) {
      const int row = k0 + 32 * half + 8 * i;
      if (row < k_end && row >= blk_hi) {
        const int blk = row / block;
        blk_hi = (blk + 1) * block;
        tc::load_col_scales<kVec>(scales, blk, col, n, sc);
      }
      s[0] = row < k_end ? sc[0] : 0.f;
      s[1] = row < k_end ? sc[1] : 0.f;
    }
    const int hi = i & 1;
    tc::dequant_pairs<TX>(r[i], s, a[i >> 1][2 * hi],
                          a[i >> 1][2 * hi + 1]);
  }
}

// grid (splits, ceil(N / 128), ceil(M / bm)), clusters as the mma.sync
// kernel's. Each warpgroup computes its 64 columns x bm rows as y^T =
// w^T x^T: w^T (64 x k16) from registers (a_frags, straight from the
// int8 tile), x (bm x k16, K-major) from the swizzled stage, 4
// m64nBMk16 products a stage. Two sets of A registers alternate: a
// stage's fragments are built while the previous stage's products run,
// and only those are waited for; loads run kStages - 2 stages ahead, so a
// slot is refilled only after the products that read it have ended. x
// arrives
// by cp.async (generic proxy) and is fenced to the async proxy before
// the barrier that hands the stage to wgmma.
template <int BM, bool kVec, typename TX>
__global__ void __launch_bounds__(Tile<BM>::kThreads, BM == 128 ? 1 : 2)
w8_gemm_wgmma(const TX* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ scales, TX* __restrict__ y,
              int m_rows, int n, int k_dim, int block, int chunk) {
  using T = Tile<BM>;
  constexpr int kBK = tc::kBK, kBN = tc::kBN, S = T::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x, lane = tid & 31;
  const int col_q = 16 * (tid >> 5);       // warp's 16 columns: 64 g + 16 w
  const int n0 = blockIdx.y * kBN, m0 = blockIdx.z * BM;
  const int k_begin = blockIdx.x * chunk;
  const int k_end = min(k_dim, k_begin + chunk);
  const int tiles = (k_end - k_begin + kBK - 1) / kBK;
  const int col = n0 + col_q + 2 * (lane >> 2);   // this lane's: col, col+1

  // the scales of col, col + 1, a block ahead as in tc
  float sc[2], sn[2];
  int blk_hi = (k_begin / block + 1) * block;
  const bool ahead = block % kBK == 0;
  tc::load_col_scales<kVec>(scales, k_begin / block, col, n, sc);
  if (ahead && blk_hi < k_end)
    tc::load_col_scales<kVec>(scales, blk_hi / block, col, n, sn);
#pragma unroll
  for (int s = 0; s < S - 2; ++s) {
    if (s < tiles)
      load_stage<T, kVec>(smem + s * T::kStageBytes, x, q, m0, m_rows, n0, n,
                          k_dim, k_begin + s * kBK, k_end);
    cp_async_commit();
  }
  float d[BM / 2];
#pragma unroll
  for (int i = 0; i < BM / 2; ++i) d[i] = 0.f;
  // Two sets of A registers alternate by stage: a stage's fragments are
  // built while the previous stage's products run, and only those are
  // waited for.
  uint32_t a0[2][2][4] = {}, a1[2][2][4] = {};
  auto stage = [&](int t, uint32_t (&a)[2][2][4],
                   const uint32_t (&prev)[2][2][4]) {
    cp_async_wait<S - 3>();
    fence_proxy_async();   // this thread's x copies, to wgmma's proxy
    __syncthreads();       // stage t landed; stage t - 2's products are done
                           // everywhere, so its slot is free
    const int tn = t + S - 2;
    if (tn < tiles)
      load_stage<T, kVec>(smem + (tn % S) * T::kStageBytes, x, q, m0, m_rows,
                          n0, n, k_dim, k_begin + tn * kBK, k_end);
    cp_async_commit();
    const unsigned char* st = smem + (t % S) * T::kStageBytes;
    const int8_t* sq = reinterpret_cast<const int8_t*>(st + T::kXBytes);
    const int k0 = k_begin + t * kBK;
    if (ahead && k0 >= blk_hi) {     // the stage opens the next block
      sc[0] = sn[0];
      sc[1] = sn[1];
      blk_hi += block;
      if (blk_hi < k_end)
        tc::load_col_scales<kVec>(scales, blk_hi / block, col, n, sn);
    }
    const bool fast = k0 + kBK <= k_end && k0 + kBK <= blk_hi;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (fast)
        a_frags<TX, kVec, false>(sq, col_q, half, scales, sc, blk_hi, k0,
                                 k_end, block, n, col, a[half]);
      else
        a_frags<TX, kVec, true>(sq, col_q, half, scales, sc, blk_hi, k0,
                                k_end, block, n, col, a[half]);
    }
    ptwg::wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s)
      ptwg::wgmma_rs<0, TX>(d, a[s >> 1][s & 1],
                            ptwg::desc_kslice(st, s, kBox), 1);
    ptwg::wgmma_commit();
    ptwg::wgmma_wait<1>();
    keep(prev);            // live until the products that read them ended
  };
  for (int t = 0; t < tiles; t += 2) {
    stage(t, a0, a1);
    if (t + 1 < tiles) stage(t + 1, a1, a0);
  }
  ptwg::wgmma_wait<0>();
  keep(a0);
  keep(a1);
  ptwg::fence_regs(d);
  cp_async_wait<0>();

  // d[4j + 2h + e]: logical row 16 w + lane / 4 + 8h of the warpgroup, i.e.
  // column col + h; x row 8j + 2 (lane % 4) + e
  const int c_tile = col - n0, r2 = 2 * (lane & 3);
  if (gridDim.x == 1) {
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        store2<kVec>(y, m0 + 8 * j + r2 + e, col, d[4 * j + e],
                     d[4 * j + 2 + e], m_rows, n);
    return;
  }
  __syncthreads();           // every thread is past its last read of smem
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float2*>(tile + (8 * j + r2 + e) * kBN + c_tile) =
          make_float2(d[4 * j + e], d[4 * j + 2 + e]);
  cluster_reduce<kVec, kBN>(tile, BM, y, m0, n0, m_rows, n);
}

}  // namespace wg

// -- launch --------------------------------------------------------------------

// every kernel a plan can pick: its function, threads, shared memory and
// columns a CTA. The fp32 mode's by rows a CTA (kSmallBM: the small
// regime); the bf16 and float16 modes' mma.sync kernel by its row tiles a
// warp, their wgmma kernel by its rows a CTA, each for its 16-bit type TX.
template <int BM, bool kVec>
struct F32Kernel {
  using T = large::Tile<BM>;
  static constexpr int kThreads = T::kThreads, kSmem = T::kSmem;
  static constexpr int kBN = T::kBN;
  static auto fn() { return large::w8_gemm_large<BM, kVec>; }
};
template <bool kVec>
struct F32Kernel<kSmallBM, kVec> {
  static constexpr int kThreads = small::kThreads;
  static constexpr int kSmem = small::kSmem;
  static constexpr int kBN = kSmallBN;
  static auto fn() { return small::w8_gemm_small<kVec>; }
};
template <int MI, bool kVec, typename TX>
struct MmaKernel {
  using T = tc::Tile<MI>;
  static constexpr int kThreads = T::kThreads, kSmem = T::kSmem;
  static constexpr int kBN = tc::kBN;
  static auto fn() { return tc::w8_gemm_mma<MI, kVec, TX>; }
};
template <int BM, bool kVec, typename TX>
struct WgmmaKernel {
  using T = wg::Tile<BM>;
  static constexpr int kThreads = T::kThreads, kSmem = T::kSmem;
  static constexpr int kBN = tc::kBN;
  static auto fn() { return wg::w8_gemm_wgmma<BM, kVec, TX>; }
};

// per kernel and process: the attributes are set once, and each cluster size
// is checked once against cudaOccupancyMaxActiveClusters
struct LaunchState {
  bool attrs = false;
  bool cluster_ok[kMaxCluster + 1] = {};
};

template <class K>
LaunchState& state_of() {
  static LaunchState state;
  return state;
}

template <class K>
cudaError_t prepare() {
  LaunchState& state = state_of<K>();
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
template <class K>
cudaLaunchConfig_t config(dim3 grid, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
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

template <class K, typename TX>
cudaError_t launch(const TX* x, const int8_t* q, const float* s, TX* y,
                   int m_rows, int n, int k_dim, int block, int bm, int chunk,
                   int splits, cudaStream_t stream) {
  cudaError_t err = prepare<K>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config<K>(
      dim3(splits, (n + K::kBN - 1) / K::kBN, (m_rows + bm - 1) / bm),
      stream, &attr);
  if (splits == 1) cfg.numAttrs = 0;
  LaunchState& state = state_of<K>();
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
template <class K>
cudaError_t cluster_ctas(int splits, int* ctas) {
  cudaError_t err = prepare<K>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<K>(dim3(splits), nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, K::fn(), &cfg);
  *ctas = clusters * splits;
  return err;
}

template <bool kVec>
cudaError_t dispatch(const float* x, const int8_t* q, const float* s,
                     float* y, int m_rows, int n, int k_dim, int block,
                     int bm, int chunk, int splits, cudaStream_t stream) {
  if (bm == kSmallBM)
    return launch<F32Kernel<kSmallBM, kVec>>(x, q, s, y, m_rows, n, k_dim,
                                             block, bm, chunk, splits,
                                             stream);
  if (bm == 64)
    return launch<F32Kernel<64, kVec>>(x, q, s, y, m_rows, n, k_dim, block,
                                       bm, chunk, splits, stream);
  return launch<F32Kernel<128, kVec>>(x, q, s, y, m_rows, n, k_dim, block,
                                      bm, chunk, splits, stream);
}

// the tensor-core kernel for bm rows a CTA and 16-bit type TX (bf16 or
// __half): 16 and 32 on mma.sync (MI = 1, 2 row tiles a warp), 64 and 128
// on wgmma
template <bool kVec, typename TX>
cudaError_t dispatch_tc(const TX* x, const int8_t* q, const float* s, TX* y,
                        int m_rows, int n, int k_dim, int block, int bm,
                        int chunk, int splits, cudaStream_t stream) {
  if (bm == 16)
    return launch<MmaKernel<1, kVec, TX>>(x, q, s, y, m_rows, n, k_dim,
                                          block, bm, chunk, splits, stream);
  if (bm == 32)
    return launch<MmaKernel<2, kVec, TX>>(x, q, s, y, m_rows, n, k_dim,
                                          block, bm, chunk, splits, stream);
  if (bm == 64)
    return launch<WgmmaKernel<64, kVec, TX>>(x, q, s, y, m_rows, n, k_dim,
                                             block, bm, chunk, splits,
                                             stream);
  return launch<WgmmaKernel<128, kVec, TX>>(x, q, s, y, m_rows, n, k_dim,
                                            block, bm, chunk, splits, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// a plan's shape checks, shared by both modes: granule is the k rows a
// chunk must be a multiple of
bool plan_ok(int m_rows, int n, int k_dim, int block, int bm, int chunk,
             int splits, int granule) {
  return !(m_rows < 1 || n < 1 || k_dim < 1 || block < 1 ||
           k_dim % block || chunk < 1 || chunk % granule || splits < 1 ||
           splits > kMaxCluster || splits != (k_dim + chunk - 1) / chunk ||
           (n + kSmallBN - 1) / kSmallBN > 65535 ||
           (m_rows + bm - 1) / bm > 65535);
}

bool vec_ok(const void* x, const void* q, const void* scales, const void* y,
            int n, int k_dim, int x_vec) {
  return n % 16 == 0 && k_dim % x_vec == 0 && aligned16(x) && aligned16(q) &&
         aligned16(scales) && aligned16(y);
}

// a tensor-core mode's entry point: bf16 or float16 x [M, K] and y [M, N]
template <typename TX>
int w8_gemm_tc(const void* x, const void* q, const void* scales, void* y,
               int m_rows, int n, int k_dim, int block, int bm, int chunk,
               int splits, void* stream) {
  if ((bm != 16 && bm != 32 && bm != 64 && bm != 128) ||
      !plan_ok(m_rows, n, k_dim, block, bm, chunk, splits, tc::kBK))
    return cudaErrorInvalidValue;
  const bool vec = vec_ok(x, q, scales, y, n, k_dim, 8);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xt = static_cast<const TX*>(x);
  const auto* qi = static_cast<const int8_t*>(q);
  const auto* sf = static_cast<const float*>(scales);
  auto* yt = static_cast<TX*>(y);
  const cudaError_t err =
      vec ? dispatch_tc<true>(xt, qi, sf, yt, m_rows, n, k_dim, block, bm,
                              chunk, splits, st)
          : dispatch_tc<false>(xt, qi, sf, yt, m_rows, n, k_dim, block, bm,
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
  if ((bm != kSmallBM && bm != 64 && bm != 128) ||
      !plan_ok(m_rows, n, k_dim, block, bm, chunk, splits,
               bm == kSmallBM ? kSmallKT : kKT))
    return cudaErrorInvalidValue;
  const bool vec = vec_ok(x, q, scales, y, n, k_dim, 4);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* qi = static_cast<const int8_t*>(q);
  const auto* sf = static_cast<const float*>(scales);
  auto* yf = static_cast<float*>(y);
  const cudaError_t err =
      vec ? dispatch<true>(xf, qi, sf, yf, m_rows, n, k_dim, block, bm, chunk,
                           splits, st)
          : dispatch<false>(xf, qi, sf, yf, m_rows, n, k_dim, block, bm,
                            chunk, splits, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The bf16 mode: x [M, K] and y [M, N] bf16, q and scales as above. Its
// plan (kernels/quant.py w8_plan_bf16): bm = 16, 32, 64 or 128 rows a CTA
// of the tensor-core kernel, K cut into `splits` chunks of `chunk` rows (a
// multiple of tc::kBK), the splits of a tile one cluster. Each weight is
// rounded to bf16 once, the sums run in fp32 and y is rounded to bf16 once.
int pt_w8_gemm_bf16(const void* x, const void* q, const void* scales,
                    void* y, int m_rows, int n, int k_dim, int block, int bm,
                    int chunk, int splits, void* stream) {
  return w8_gemm_tc<bf16>(x, q, scales, y, m_rows, n, k_dim, block, bm,
                          chunk, splits, stream);
}

// The float16 mode: x [M, K] and y [M, N] float16, the rest as the bf16
// mode's (the same kernels, plan and checks). Each weight is rounded to
// float16 once, the sums run in fp32 and y is rounded to float16 once.
int pt_w8_gemm_f16(const void* x, const void* q, const void* scales,
                   void* y, int m_rows, int n, int k_dim, int block, int bm,
                   int chunk, int splits, void* stream) {
  return w8_gemm_tc<__half>(x, q, scales, y, m_rows, n, k_dim, block, bm,
                            chunk, splits, stream);
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
    return vec ? cluster_ctas<F32Kernel<kSmallBM, true>>(splits, out)
               : cluster_ctas<F32Kernel<kSmallBM, false>>(splits, out);
  if (bm == 64)
    return vec ? cluster_ctas<F32Kernel<64, true>>(splits, out)
               : cluster_ctas<F32Kernel<64, false>>(splits, out);
  return vec ? cluster_ctas<F32Kernel<128, true>>(splits, out)
             : cluster_ctas<F32Kernel<128, false>>(splits, out);
}

// The same for the bf16 mode's kernel of `bm` rows a CTA (16, 32, 64 or
// 128): the plan's W8B_CLUSTER_CTAS.
int pt_w8_bf16_cluster_ctas(int bm, int splits, int vec, void* ctas) {
  if ((bm != 16 && bm != 32 && bm != 64 && bm != 128) || splits < 1 ||
      splits > kMaxCluster || ctas == nullptr)
    return cudaErrorInvalidValue;
  int* out = static_cast<int*>(ctas);
  if (bm == 16)
    return vec ? cluster_ctas<MmaKernel<1, true, bf16>>(splits, out)
               : cluster_ctas<MmaKernel<1, false, bf16>>(splits, out);
  if (bm == 32)
    return vec ? cluster_ctas<MmaKernel<2, true, bf16>>(splits, out)
               : cluster_ctas<MmaKernel<2, false, bf16>>(splits, out);
  if (bm == 64)
    return vec ? cluster_ctas<WgmmaKernel<64, true, bf16>>(splits, out)
               : cluster_ctas<WgmmaKernel<64, false, bf16>>(splits, out);
  return vec ? cluster_ctas<WgmmaKernel<128, true, bf16>>(splits, out)
             : cluster_ctas<WgmmaKernel<128, false, bf16>>(splits, out);
}

}  // extern "C"
