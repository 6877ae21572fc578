// Float32 block products on Hopper's CUDA cores: the main loop of every
// float32 kernel of csrc/fused_ce.cu, the forward (kernel 4), dl/dh (kernel
// 5) and dW (kernel 6). Full fp32 FMAs, no TF32 (the reference's 'highest'
// precision). Header only: no entry points.
//
// What held the loop it replaced (tile_product, the first CUDA-core block
// product of csrc/fused_ce.cu): per k a thread read 16 scalar floats for
// its 8 x 8 FMAs. An LDS is served a quarter warp (8 lanes, 128 bytes) a
// wavefront, broadcast or not, so a warp's wavefronts per k are the floats
// a thread reads: 16, as many cycles as its 64 FFMAs take on four
// schedulers. The shared pipe and the FMA issue tie, at about half the
// fp32 peak; 128-bit reads of the same 8 x 8 tile left it there (measured:
// PERF.md, section 6).
//
// Design:
//  * a thread owns 8 x TN outputs (TN = 16 in the forward, dl, dh and dW:
//    24 floats a k for 128 FFMAs, the shared pipe a quarter idle; 8 in dh's
//    64-row tiles), as 2 x TN / 4 quadrants of 4 x 4: rows r + {0..3}
//    and r + 16 + {0..3}, columns c + 32 q + {0..3}. A warp's lanes are 4
//    (rows) x 8 (columns), a warp owns 32 x 8 TN outputs. ~250 registers
//    at TN = 16: two CTAs of 4 warps an SM.
//  * both operands sit in shared memory with k as the slow axis, [BK][LD],
//    so a thread's four consecutive rows (or columns) at one k are one
//    128-bit load: per k two LDS.128 of A and TN / 4 of B. For one k the 8
//    lanes of a quarter warp read one A address (a broadcast) and 8
//    consecutive float4 of B (all 32 banks once).
//  * every operand goes through registers, loaded one stage ahead as
//    float4 (__ldg) and stored after this stage's FMAs; one barrier a
//    stage of BK = 16, two stages. A K-major operand (k contiguous in
//    device memory: h in the forward and dl, dl and W read as W^T in dh)
//    is read 4 lanes a row (coalesced: 32 rows a load cost 32 L1
//    wavefronts, 4 x the shared traffic of a stage's FMAs' reads in the
//    first design) and stored transposed, skewed so the stores hit 32
//    banks (Stage below). An MN-major one (W in the forward and dl; both of
//    dW's, h read as h^T and dl, whose k is the token axis) is stored as it
//    lies (4 % faster than cp.async in the forward, which then needs no
//    staging registers).
//  * a CTA may walk several N tiles of one M tile (the forward's vocab
//    tiles). The loop runs over (tile, stage) pairs, so the next tile's
//    first stage loads while this tile's epilogue runs.
//  * each tile ends in the epilogue's calls, one a row and column quad of
//    the thread's accumulators, in registers: no C tile in shared memory
//    and no barrier for it. Every output element has one writer and its
//    sum runs over k in order: no atomics, two launches give the same bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ptf32gemm {

constexpr int BK = 16;       // k of one stage
constexpr int WARP_M = 32;   // a warp's output rows (4 lanes x 8)

// One operand in device memory: element (r, k), r < rows, k < depth, at
// ptr[r * ld + k] (K-major) or ptr[k * ld + r] (MN-major). The contiguous
// extent is a multiple of 4 and ptr 16-byte aligned, so each float4 piece
// lies wholly inside or wholly outside the operand.
struct Mat {
  const float* ptr;
  long long ld;
  int rows, depth;
};

// One stage (ROWS x BK) of an operand into a [BK][LD] shared tile, zero
// outside the operand: fetch() loads it into registers, store() writes it
// after the stage being computed. Element (k, r) sits at k * LD + SKEW *
// (k / 4) + r.
template <int ROWS, int THREADS, bool KMAJOR>
struct Stage;

// K-major, through registers: four lanes take a row's 16 k (a warp eight
// rows, 64 contiguous bytes each: eight L1 lines a load), PER rows a
// thread. Stored transposed, each group of 4 k starts 8 floats later than
// the last (LD = ROWS + 24), so a warp's 32 stores of one element of its
// float4s (8 rows x 4 groups) hit 32 banks; reads of 4 consecutive rows
// at one k stay one aligned float4.
template <int ROWS, int THREADS>
struct Stage<ROWS, THREADS, true> {
  static constexpr int SKEW = 8, LD = ROWS + 3 * SKEW;
  static constexpr int STEP = THREADS / 4;   // rows between a thread's
  static constexpr int PER = ROWS / STEP;
  static_assert(BK == 16 && PER * STEP == ROWS,
                "four lanes a row, a stage's rows split evenly");
  float4 v[PER];

  __device__ __forceinline__ void fetch(const Mat& op, int r0, int k0) {
    const int r = r0 + threadIdx.x / 4, k = k0 + threadIdx.x % 4 * 4;
    const float* src = op.ptr + static_cast<long long>(r) * op.ld + k;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      v[i] = r + i * STEP < op.rows && k < op.depth
                 ? __ldg(reinterpret_cast<const float4*>(
                       src + static_cast<long long>(i * STEP) * op.ld))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void store(float* s) const {
    const int g = threadIdx.x % 4;   // the group of 4 k
    float* d = s + g * (4 * LD + SKEW) + threadIdx.x / 4;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      d[i * STEP] = v[i].x;
      d[LD + i * STEP] = v[i].y;
      d[2 * LD + i * STEP] = v[i].z;
      d[3 * LD + i * STEP] = v[i].w;
    }
  }
};

// MN-major, through registers: a warp's float4 loads are 512 contiguous
// bytes of one k row, stored as they lie
template <int ROWS, int THREADS>
struct Stage<ROWS, THREADS, false> {
  static constexpr int SKEW = 0, LD = ROWS;
  static constexpr int LINE = ROWS / 4, PER = BK * LINE / THREADS;
  static_assert(PER * THREADS == BK * LINE, "pieces split evenly");
  float4 v[PER];

  __device__ __forceinline__ void fetch(const Mat& op, int r0, int k0) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = threadIdx.x + i * THREADS;
      const int k = c / LINE, r = c % LINE * 4;
      v[i] = r0 + r < op.rows && k0 + k < op.depth
                 ? __ldg(reinterpret_cast<const float4*>(
                       op.ptr + static_cast<long long>(k0 + k) * op.ld + r0 +
                       r))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void store(float* s) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int c = threadIdx.x + i * THREADS;
      *reinterpret_cast<float4*>(s + c / LINE * ROWS + c % LINE * 4) = v[i];
    }
  }
};

// A BM x BN block tile of threads owning 8 x TN outputs (warps of WARP_M x
// 8 TN), over A K-major (A_K) or M-major and B K-major (B_K) or N-major,
// two stages.
template <int BM_, int BN_, int TN_, bool A_K_, bool B_K_>
struct Shape {
  static constexpr int BM = BM_, BN = BN_, TN = TN_;
  static constexpr bool A_K = A_K_, B_K = B_K_;
  static constexpr int WARP_N = 8 * TN;
  static constexpr int WARPS_M = BM / WARP_M;
  static constexpr int THREADS = 32 * WARPS_M * (BN / WARP_N);
  using SA = Stage<BM, THREADS, A_K>;
  using SB = Stage<BN, THREADS, B_K>;
  static constexpr int A_FLOATS = BK * SA::LD;
  static constexpr int STAGE = A_FLOATS + BK * SB::LD;   // floats
  static constexpr int SMEM_BYTES = 2 * STAGE * 4;
};

// Output tiles (m0, n tiles nt0 .. nt1 - 1) of C = A . B over K, in order;
// after each, epi(i, row, col, v) for each of the thread's 8 rows i and
// TN / 4 column quads: v = the float4 of columns col .. col + 3 of row
// `row` (both in C). smem holds S::SMEM_BYTES; on return every thread is
// past its last read of it.
template <typename S, typename Epilogue>
__device__ __forceinline__ void gemm(const Mat& A, const Mat& B, int m0,
                                     int nt0, int nt1, int K, float* smem,
                                     Epilogue& epi) {
  constexpr int BM = S::BM, BN = S::BN, TN = S::TN;
  constexpr int LDA = S::SA::LD, LDB = S::SB::LD;
  constexpr int SKA = S::SA::SKEW, SKB = S::SB::SKEW;
  // the k loop's unroll: half a stage where A is K-major and B N-major
  // (measured: the forward's and dl's FMAs ran 4 % faster so), all of it
  // otherwise (dh; dW, both operands MN-major: 9 % faster than by half)
  constexpr int UNROLL = S::A_K && !S::B_K ? BK / 2 : BK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = warp % S::WARPS_M * WARP_M + (lane >> 3) * 4;
  const int col = warp / S::WARPS_M * S::WARP_N + (lane & 7) * 4;
  const int steps = (K + BK - 1) / BK;
  const int total = (nt1 - nt0) * steps;
  if (total <= 0) return;
  typename S::SA sa;
  typename S::SB sb;
  sa.fetch(A, m0, 0);
  sb.fetch(B, nt0 * BN, 0);
  sa.store(smem);
  sb.store(smem + S::A_FLOATS);
  __syncthreads();

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  int s = 0, nt = nt0;   // the stage and tile being computed
  for (int g = 0; g < total; ++g) {
    const float* cur = smem + (g & 1) * S::STAGE;
    float* nxt = smem + ((g + 1) & 1) * S::STAGE;
    const bool more = g + 1 < total;
    const int s1 = s + 1 == steps ? 0 : s + 1;
    const int nt1_ = s1 == 0 ? nt + 1 : nt;
    if (more) {
      sa.fetch(A, m0, s1 * BK);
      sb.fetch(B, nt1_ * BN, s1 * BK);
    }
    const float* as = cur + row;
    const float* bs = cur + S::A_FLOATS + col;
#pragma unroll(UNROLL)
    for (int k = 0; k < BK; ++k) {
      const float* ak = as + k * LDA + SKA * (k / 4);
      const float* bk = bs + k * LDB + SKB * (k / 4);
      const float4 a0 = *reinterpret_cast<const float4*>(ak);
      const float4 a1 = *reinterpret_cast<const float4*>(ak + 16);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[TN];
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(bk + 32 * q);
        b[4 * q] = v.x;
        b[4 * q + 1] = v.y;
        b[4 * q + 2] = v.z;
        b[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (s == steps - 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          epi(i, m0 + row + (i & 3) + 16 * (i >> 2), nt * BN + col + 32 * q,
              make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                          acc[i][4 * q + 3]));
#pragma unroll
          for (int j = 4 * q; j < 4 * q + 4; ++j) acc[i][j] = 0.f;
        }
    }
    if (more) {
      sa.store(nxt);
      sb.store(nxt + S::A_FLOATS);
    }
    __syncthreads();
    s = s1;
    nt = nt1_;
  }
}

}  // namespace ptf32gemm
