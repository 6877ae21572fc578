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
// is dequantized in registers exactly as dequantize_int8_weight does (the
// int8 value times its fp32 scale, one rounding), then multiplied and
// accumulated in fp32; only the order of the sums differs from the plain
// version.
//
// What bounds it on this card (llama1b decode, M = 16 slots, 7 projections
// x 22 layers, 1.11 G int8 weights a step): 1.11 GB of int8 planes and
// ~21 MB of scales, 0.34 ms at 3.35 TB/s, against 35.6 GFLOP, 0.53 ms at
// 67 TFLOP/s fp32: bound by operations, barely. At M = 256 (the mixed step
// of 16 slots x 16-token chunks) it is a SIMT GEMM, bound by operations.
//
// The design against that:
//  * One CTA (8 warps) owns a 16-row x 256-column output tile. A lane owns
//    8 consecutive columns and reads them as one 8-byte load per k row (a
//    warp reads 256 contiguous bytes of q), turns the 8 int8 values into
//    floats with a byte permute (bits 0x4B0000bb are 2^23 + bb; the int8
//    value is the unsigned byte of v ^ 0x80, so one subtract of 2^23 + 128
//    leaves it exactly) and multiplies each by its column's scale. The 8
//    scales are reloaded only when the row enters the next block of b rows.
//    Each dequantized value then feeds 16 fused multiply-adds, one per row,
//    from x staged in shared memory (transposed, so a row's 16 x values are
//    four broadcast float4 reads).
//  * A warp walks a contiguous run of the CTA's k rows with four q rows in
//    flight (a register ring), so its loads overlap the other warps' FMAs;
//    the 8 warps' partial tiles are summed through shared memory.
//  * Few output tiles (N = 2048 gives 8 column tiles at M = 16): K is split
//    across CTAs (the wrapper's w8_plan fills the card's 132 SMs, at most
//    1024 k rows a CTA so x's chunk fits in shared memory). Each split
//    writes an fp32 partial tile; the last CTA of a tile to arrive (an int
//    counter per tile, reset by that CTA) sums the splits in split order.
//    No floating-point atomics: two launches on the same inputs give the
//    same bits.
// Later work, not this kernel's: wider M tiles at M = 256, cp.async rings,
// and the launch cost (154 launches a decode step).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 16;               // x rows a CTA computes
constexpr int kCols = 8;              // q columns a lane owns
constexpr int kTN = 32 * kCols;       // output columns a CTA computes
constexpr int kMaxChunk = 1024;       // k rows a CTA takes, at most
constexpr int kXStride = kBM + 4;     // floats per staged k row (padded)
constexpr int kRedRows = 4;           // output rows summed per round
constexpr int kRing = 4;              // q rows in flight per warp
constexpr int kSmemFloats =
    kMaxChunk * kXStride > kWarps * kRedRows * kTN
        ? kMaxChunk * kXStride : kWarps * kRedRows * kTN;

__device__ __forceinline__ float i8f(uint32_t biased, uint32_t sel) {
  // 2^23 + (v + 128) as a float, minus 2^23 + 128: exactly v
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, sel)) - 8388736.f;
}

template <bool kVec>
__device__ __forceinline__ uint2 load_q(const int8_t* __restrict__ q,
                                        size_t off, int col0, int n) {
  if constexpr (kVec) {
    if (col0 >= n) return make_uint2(0u, 0u);
    return __ldg(reinterpret_cast<const uint2*>(q + off));
  } else {
    uint32_t w[2] = {0u, 0u};
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (col0 + c < n)
        w[c / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(q[off + c]))
                    << (8 * (c % 4));
    return make_uint2(w[0], w[1]);
  }
}

template <bool kVec>
__device__ __forceinline__ void load_scales(const float* __restrict__ s,
                                            size_t off, int col0, int n,
                                            float* out) {
  if constexpr (kVec) {
    if (col0 >= n) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) out[c] = 0.f;
      return;
    }
    const float4 a = __ldg(reinterpret_cast<const float4*>(s + off));
    const float4 b = __ldg(reinterpret_cast<const float4*>(s + off + 4));
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      out[c] = col0 + c < n ? s[off + c] : 0.f;
  }
}

// grid (ceil(N / kTN), ceil(M / kBM), splits); split z takes k rows
// [z * chunk, min(K, (z + 1) * chunk)).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
w8_gemm_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scales, float* __restrict__ y,
               float* __restrict__ partial, int* __restrict__ counters,
               int m_rows, int n, int k_dim, int block, int chunk,
               int splits) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * kTN + lane * kCols;
  const int m0 = blockIdx.y * kBM;
  const int k_begin = blockIdx.z * chunk;
  const int len = min(chunk, k_dim - k_begin);

  // stage x[m0:m0+16, k_begin:k_begin+len] transposed: smem[r][m]
  for (int i = tid; i < kBM * len; i += kThreads) {
    const int m = i / len, r = i - m * len;
    smem[r * kXStride + m] =
        m0 + m < m_rows ? x[static_cast<size_t>(m0 + m) * k_dim + k_begin + r]
                        : 0.f;
  }
  __syncthreads();

  float acc[kBM][kCols];
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;

  // this warp's contiguous run of the chunk's rows
  const int per = (len + kWarps - 1) / kWarps;
  const int r0 = min(len, warp * per), r1 = min(len, r0 + per);
  float sc[kCols];
  int blk_hi = 0;                    // first k row past the loaded scales
  uint2 ring[kRing];
#pragma unroll
  for (int i = 0; i < kRing; ++i)
    ring[i] = r0 + i < r1
        ? load_q<kVec>(q, static_cast<size_t>(k_begin + r0 + i) * n + col0,
                       col0, n)
        : make_uint2(0u, 0u);
  for (int r = r0; r < r1; r += kRing) {
#pragma unroll
    for (int i = 0; i < kRing; ++i) {
      const int rr = r + i;
      if (rr < r1) {
        const uint2 cur = ring[i];
        ring[i] = rr + kRing < r1
            ? load_q<kVec>(q,
                           static_cast<size_t>(k_begin + rr + kRing) * n +
                               col0, col0, n)
            : make_uint2(0u, 0u);
        const int k = k_begin + rr;
        if (k >= blk_hi) {
          const int blk = k / block;
          blk_hi = (blk + 1) * block;
          load_scales<kVec>(scales, static_cast<size_t>(blk) * n + col0,
                            col0, n, sc);
        }
        const uint32_t lo = cur.x ^ 0x80808080u, hi = cur.y ^ 0x80808080u;
        float w[kCols];
        w[0] = i8f(lo, 0x7540) * sc[0];
        w[1] = i8f(lo, 0x7541) * sc[1];
        w[2] = i8f(lo, 0x7542) * sc[2];
        w[3] = i8f(lo, 0x7543) * sc[3];
        w[4] = i8f(hi, 0x7540) * sc[4];
        w[5] = i8f(hi, 0x7541) * sc[5];
        w[6] = i8f(hi, 0x7542) * sc[6];
        w[7] = i8f(hi, 0x7543) * sc[7];
        const float4* xr = reinterpret_cast<const float4*>(smem + rr * kXStride);
#pragma unroll
        for (int j = 0; j < kBM / 4; ++j) {
          const float4 xv = xr[j];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc[4 * j + 0][c] = fmaf(xv.x, w[c], acc[4 * j + 0][c]);
            acc[4 * j + 1][c] = fmaf(xv.y, w[c], acc[4 * j + 1][c]);
            acc[4 * j + 2][c] = fmaf(xv.z, w[c], acc[4 * j + 2][c]);
            acc[4 * j + 3][c] = fmaf(xv.w, w[c], acc[4 * j + 3][c]);
          }
        }
      }
    }
  }

  // sum the 8 warps' tiles, kRedRows rows a round; thread tid then owns
  // column blockIdx.x * kTN + tid of those rows
  const int col = blockIdx.x * kTN + tid;
  float* dst = splits == 1 ? y
                           : partial + static_cast<size_t>(blockIdx.z) *
                                           m_rows * n;
#pragma unroll
  for (int mr = 0; mr < kBM; mr += kRedRows) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRedRows; ++i) {
      float4* p = reinterpret_cast<float4*>(
          smem + (warp * kRedRows + i) * kTN + lane * kCols);
      p[0] = make_float4(acc[mr + i][0], acc[mr + i][1], acc[mr + i][2],
                         acc[mr + i][3]);
      p[1] = make_float4(acc[mr + i][4], acc[mr + i][5], acc[mr + i][6],
                         acc[mr + i][7]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRedRows; ++i) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += smem[(w * kRedRows + i) * kTN + tid];
      const int row = m0 + mr + i;
      if (row < m_rows && col < n) dst[static_cast<size_t>(row) * n + col] = v;
    }
  }
  if (splits == 1) return;

  // the last split of this tile to arrive sums every split's partial in
  // split order and resets the tile's counter for the next launch
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (tid == 0) s_last = atomicAdd(counters + tile, 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (col < n) {
    for (int m = 0; m < kBM && m0 + m < m_rows; ++m) {
      const size_t at = static_cast<size_t>(m0 + m) * n + col;
      float v = 0.f;
      for (int sp = 0; sp < splits; ++sp)
        v += __ldcg(partial + static_cast<size_t>(sp) * m_rows * n + at);
      y[at] = v;
    }
  }
  if (tid == 0) counters[tile] = 0;
}

template <bool kVec>
cudaError_t launch(const float* x, const int8_t* q, const float* scales,
                   float* y, float* partial, int* counters, int m_rows, int n,
                   int k_dim, int block, int chunk, int splits,
                   cudaStream_t stream) {
  static bool attr_set = false;      // once per instantiation and process
  const int smem = kSmemFloats * static_cast<int>(sizeof(float));
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        w8_gemm_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((n + kTN - 1) / kTN, (m_rows + kBM - 1) / kBM, splits);
  w8_gemm_kernel<kVec><<<grid, kThreads, smem, stream>>>(
      x, q, scales, y, partial, counters, m_rows, n, k_dim, block, chunk,
      splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [M, K] fp32, q [K, N] int8, scales [K / block, N] fp32, y [M, N] fp32,
// all contiguous. K is split into `splits` chunks of `chunk` rows (chunk <=
// 1024, splits == ceil(K / chunk)); with splits > 1, partial holds splits *
// M * N floats and counters ceil(N / 256) * ceil(M / 16) ints, all zero
// before the first launch (each launch leaves them zero). Returns the
// launch's cudaError_t.
int pt_w8_gemm(const void* x, const void* q, const void* scales, void* y,
               void* partial, void* counters, int m_rows, int n, int k_dim,
               int block, int chunk, int splits, void* stream) {
  if (m_rows < 1 || n < 1 || k_dim < 1 || block < 1 || k_dim % block ||
      chunk < 1 || chunk > kMaxChunk || splits != (k_dim + chunk - 1) / chunk ||
      (m_rows + kBM - 1) / kBM > 65535 || splits > 65535 ||
      (splits > 1 && (partial == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  const bool vec = n % kCols == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(scales) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* qi = static_cast<const int8_t*>(q);
  const auto* sf = static_cast<const float*>(scales);
  auto* yf = static_cast<float*>(y);
  auto* pf = static_cast<float*>(partial);
  auto* cf = static_cast<int*>(counters);
  return vec ? launch<true>(xf, qi, sf, yf, pf, cf, m_rows, n, k_dim, block,
                            chunk, splits, s)
             : launch<false>(xf, qi, sf, yf, pf, cf, m_rows, n, k_dim, block,
                             chunk, splits, s);
}

}  // extern "C"
