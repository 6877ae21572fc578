// bf16 tensor-core building blocks for Hopper (sm_90a). Header only: no
// entry points. Used by csrc/mma_probe.cu, which checks every form below
// on its own, where a wrong fragment layout is easy to read, and by
// csrc/w8_gemm.cu's bf16 and float16 modes (load_a, ldmatrix_x4_trans over
// int8 pairs, mma_bf16 and mma_f16). csrc/fused_ce.cu's bf16 products run
// on wgmma, csrc/wgmma_bf16.cuh, and its float32 ones on csrc/f32_gemm.cuh.
//
// The product is warp-level `mma.sync.aligned.m16n8k16.row.col.f32.bf16.
// bf16.f32` (inline PTX): a 16 x 16 bf16 A fragment times a 16 x 8 bf16 B
// fragment, summed into a 16 x 8 fp32 accumulator. Fragments come from
// shared memory through `ldmatrix`: plain where the operand's contracted
// axis is its contiguous one ("K-major"), `.trans` where it is not. So one
// block tile product covers the four forms of the reference's Mosaic
// probe (tools/mosaic_probe.py):
//   nt  A [M, K] (K-major) x B [N, K] (K-major)   -> logits h.W^T forms
//   nn  A [M, K] (K-major) x B [K, N] (N-major)   -> h.W   (fused CE fwd)
//   tn  A [K, M] (M-major) x B [K, N] (N-major)   -> h^T.dl (fused CE dW)
//   chained nt -> exp -> cast -> nn, the accumulator re-used in registers
//   as the next product's A fragment (acc_to_a).
// `wgmma` forms join this header with the first kernel that uses them.
//
// Fragment layouts (PTX ISA, m16n8k16 with .bf16), lane = 4 * g + t:
//   A: a0 (row g, k 2t..2t+1), a1 (row g+8, same k), a2 (row g, k 2t+8..),
//      a3 (row g+8, k 2t+8..)
//   B: b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g)
//   C: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols)
// `ldmatrix.x4` hands lane l the pair (row l/4, cols 2(l%4)..) of each of
// four 8 x 8 matrices whose row addresses lanes 8i..8i+7 supply; with
// `.trans` it hands the transposed pair. The address formulas below pick
// the matrices so that the four registers are a0..a3, or b0/b1 of two
// neighbouring 8-column tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptmma {

// block tile of the shared product: BM x BN outputs, BK deep per stage,
// 8 warps as 2 (rows) x 4 (cols), each warp 64 x 32 = 4 x 4 mma tiles
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b on the bf16 tensor cores, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b on the fp16 tensor cores, fp32 accumulators (the same
// fragment layouts as mma_bf16; csrc/w8_gemm.cu's float16 mode)
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half (the lower k)
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The accumulators of two neighbouring 8-column tiles (cols 0-7 and 8-15
// of a 16 x 16 block), rounded to bf16, as the A fragment of a product
// that contracts those 16 columns (the flash-attention P.V step).
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

// 16 bytes global -> shared without registers; zero-filled when !pred
// (src must still be a valid address: callers pass the operand's base)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A fragment (16 rows x 16 k) at (row0, k0) of an A tile in shared memory,
// `ld` elements between its stored rows: K-major tiles hold A[m][k],
// M-major tiles hold A[k][m].
template <bool KMAJOR>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* s, int ld,
                                       int row0, int k0, int lane) {
  if (KMAJOR) {
    ldmatrix_x4(a, s + (row0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
  } else {
    ldmatrix_x4_trans(a, s + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                             row0 + ((lane >> 3) & 1) * 8);
  }
}

// B fragments of two neighbouring 8-column tiles (cols n0..n0+15, 16 k
// from k0): b[0] = {b0, b1} of cols n0..n0+7, b[1] of n0+8..n0+15.
// K-major tiles hold B[n][k], N-major tiles hold B[k][n].
template <bool KMAJOR>
__device__ __forceinline__ void load_b2(uint32_t (&b)[2][2],
                                        const __nv_bfloat16* s, int ld,
                                        int n0, int k0, int lane) {
  uint32_t r[4];
  if (KMAJOR) {
    ldmatrix_x4(r, s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                       ((lane >> 3) & 1) * 8);
  } else {
    ldmatrix_x4_trans(r, s + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                                 ld +
                             n0 + ((lane >> 4) << 3));
  }
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// One operand of C[M, N] = sum_k A(m, k) B(k, n), in device memory.
// Element (r, k), r < rows (M for A, N for B), k < depth (K), is at
// ptr[r * ld + k] when the operand is K-major and at ptr[k * ld + r]
// otherwise. The contiguous extent (depth or rows) must be a multiple of
// 16 bytes' worth of elements and ptr 16-byte aligned: tiles move in
// 16-byte pieces, each wholly inside or wholly outside the operand.
template <typename T>
struct Operand {
  const T* ptr;
  long long ld;
  int rows;
  int depth;
};

template <typename T>
__host__ __device__ constexpr int pad_elems() {
  return 16 / static_cast<int>(sizeof(T));
}

// leading dimension (elements) of one stage's tile in shared memory,
// padded by 16 bytes so ldmatrix's eight row addresses hit distinct banks
template <typename T, bool KMAJOR, int ROWS>
__host__ __device__ constexpr int tile_ld() {
  return (KMAJOR ? BK : ROWS) + pad_elems<T>();
}
template <typename T, bool KMAJOR, int ROWS>
__host__ __device__ constexpr int tile_elems() {
  return (KMAJOR ? ROWS : BK) * tile_ld<T, KMAJOR, ROWS>();
}

// Start the copy of rows r0..r0+ROWS-1, k0..k0+BK-1 of `op` into `s`
// (one stage), zero outside the operand.
template <typename T, bool KMAJOR, int ROWS>
__device__ __forceinline__ void load_tile_async(T* s, const Operand<T>& op,
                                                int r0, int k0) {
  constexpr int VEC = pad_elems<T>();
  constexpr int LD = tile_ld<T, KMAJOR, ROWS>();
  constexpr int PER_LINE = (KMAJOR ? BK : ROWS) / VEC;
  constexpr int CHUNKS = (KMAJOR ? ROWS : BK) * PER_LINE;
  for (int c = threadIdx.x; c < CHUNKS; c += THREADS) {
    const int line = c / PER_LINE, off = (c % PER_LINE) * VEC;
    const int r = KMAJOR ? r0 + line : r0 + off;
    const int k = KMAJOR ? k0 + off : k0 + line;
    const bool in = r < op.rows && k < op.depth;
    const T* src = !in ? op.ptr
                   : KMAJOR ? op.ptr + static_cast<long long>(r) * op.ld + k
                            : op.ptr + static_cast<long long>(k) * op.ld + r;
    cp_async16(s + line * LD + off, src, in);
  }
}

// Shared memory (bytes) that block_mma needs for its two stages.
template <bool AK, bool BKM>
__host__ __device__ constexpr int block_mma_smem() {
  return 2 * (tile_elems<__nv_bfloat16, AK, BM>() +
              tile_elems<__nv_bfloat16, BKM, BN>()) *
         static_cast<int>(sizeof(__nv_bfloat16));
}

// acc = A[m0:m0+BM, :K] . B[:K, n0:n0+BN] for one block of THREADS
// threads: two-stage cp.async pipeline over BK-deep slices, each warp
// 64 x 32 outputs as acc[mi][ni] (16 x 8 tiles at rows wm*64 + mi*16, cols
// wn*32 + ni*8). `smem` holds block_mma_smem() bytes; on return no copy is
// in flight and every thread is past its last read of it.
template <bool AK, bool BKM>
__device__ __forceinline__ void block_mma(float (&acc)[4][4][4],
                                          const Operand<__nv_bfloat16>& A,
                                          const Operand<__nv_bfloat16>& B,
                                          int m0, int n0, int K,
                                          __nv_bfloat16* smem) {
  using bf16 = __nv_bfloat16;
  constexpr int A_ELEMS = tile_elems<bf16, AK, BM>();
  constexpr int B_ELEMS = tile_elems<bf16, BKM, BN>();
  constexpr int LDA = tile_ld<bf16, AK, BM>();
  constexpr int LDB = tile_ld<bf16, BKM, BN>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int steps = (K + BK - 1) / BK;
  load_tile_async<bf16, AK, BM>(smem, A, m0, 0);
  load_tile_async<bf16, BKM, BN>(smem + A_ELEMS, B, n0, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    bf16* cur = smem + (s & 1) * (A_ELEMS + B_ELEMS);
    if (s + 1 < steps) {
      bf16* nxt = smem + ((s + 1) & 1) * (A_ELEMS + B_ELEMS);
      load_tile_async<bf16, AK, BM>(nxt, A, m0, (s + 1) * BK);
      load_tile_async<bf16, BKM, BN>(nxt + A_ELEMS, B, n0, (s + 1) * BK);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* As = cur;
    const bf16* Bs = cur + A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        load_a<AK>(a[mi], As, LDA, wm * 64 + mi * 16, kk, lane);
      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b2[2][2];
        load_b2<BKM>(b2, Bs, LDB, wn * 32 + np * 16, kk, lane);
        b[2 * np][0] = b2[0][0];
        b[2 * np][1] = b2[0][1];
        b[2 * np + 1][0] = b2[1][0];
        b[2 * np + 1][1] = b2[1][1];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
    __syncthreads();   // the next iteration's copies overwrite this stage
  }
  cp_async_wait<0>();
}

// Write block_mma's accumulators to out[(m0 + r) * ld + n0 + c] (fp32),
// rows < M and cols < N only (out in shared or device memory).
__device__ __forceinline__ void store_acc(const float (&acc)[4][4][4],
                                          float* out, long long ld, int m0,
                                          int n0, int M, int N) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm * 64 + mi * 16 + (lane >> 2) + h * 8;
        const int c = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
        if (r < M) {
          if (c < N) out[r * ld + c] = acc[mi][ni][2 * h];
          if (c + 1 < N) out[r * ld + c + 1] = acc[mi][ni][2 * h + 1];
        }
      }
}

}  // namespace ptmma
