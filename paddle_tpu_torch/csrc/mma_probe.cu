// The bf16 tensor-core form probe for Hopper (sm_90a).
//
// Replaces: tools/mosaic_probe.py, `probe` (the pallas_call at line 19),
// which asks whether the TPU compiler takes four bf16 dot forms at
// BQ = BK = 512, D = 128 with fp32 results: nt (contracting dims (1,1)),
// nn ((1,0)), tn ((0,0)) and nt -> exp -> cast -> nn chained. Here each
// form runs through the building blocks of csrc/mma_bf16.cuh (ldmatrix /
// ldmatrix.trans fragment loads, mma.sync m16n8k16 bf16 -> fp32, the
// register hand-over of acc_to_a), and tools/mma_probe.py holds each
// result against the same product taken in fp32 by PyTorch: a wrong
// fragment layout shows here as a wrong value of one form, not as a wrong
// loss.
//
// Forms 4-6 do the same for the warpgroup forms of csrc/wgmma_bf16.cuh
// that the bf16 flash-attention backward kernels use, each operand tile
// loaded by TMA with 128-byte swizzle: (4) nt, an ss product with A and B
// K-major; (5) nn, an ss product with B MN-major (the transpose bit) two
// 64-wide blocks apart (LBO); (6) the chained form on wgmma: S = a.b^T
// (ss), exp, the accumulator handed over as bf16 A fragments, and P.b as
// an rs product with b read MN-major, as dk/dv computes P^T.dO. Form 7
// is tn on wgmma, both operands MN-major (A with the transpose-A bit), each
// loaded through a rank-2 tensor map: the form the fused CE backward's
// dW = h^T . dl takes (its forward's h . W and dl take form 5's operand
// form, B MN-major).
//
// What bounds it: each form is 2 * 512 * 512 * 128 = 6.7e7 operations on
// ~1.3 MB, so at this size it is bound by bytes and by its launch; the
// probe checks layouts and values, its time is printed for reference.
// Design: the three plain forms are one 128 x 128 block tile each
// (ptmma::block_mma, 16 blocks); the chained form is a flash-attention
// shaped kernel, 4 warps of 16 query rows per block, keys in tiles of 64.
// The wgmma forms run one warpgroup per block (64 rows), its thread 0
// issuing the TMA loads onto one mbarrier.
#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int PQ = 512, PK = 512, PD = 128;

// forms 0 nt, 1 nn, 2 tn: out [512, 512] fp32
template <bool AK, bool BKM>
__global__ void __launch_bounds__(ptmma::THREADS)
    probe_gemm(const bf16* a, const bf16* b, float* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  // nt: a [Q, D], b [K, D]; nn: a [Q, D], b [D, K]; tn: a [D, Q], b [D, K]
  const ptmma::Operand<bf16> A{a, AK ? PD : PQ, PQ, PD};
  const ptmma::Operand<bf16> B{b, BKM ? PD : PK, PK, PD};
  float acc[4][4][4];
  const int m0 = blockIdx.x * ptmma::BM, n0 = blockIdx.y * ptmma::BN;
  ptmma::block_mma<AK, BKM>(acc, A, B, m0, n0, PD,
                            reinterpret_cast<bf16*>(smem));
  ptmma::store_acc(acc, out, PK, m0, n0, PQ, PK);
}

// form 3: out [512, 128] = bf16(exp(a . b^T - 1)) . b, a [Q, D], b [K, D]
constexpr int CQ = 64, CK = 64, CLD = PD + 8;

__global__ void __launch_bounds__(128)
    probe_chained(const bf16* a, const bf16* b, float* out) {
  __shared__ __align__(16) bf16 qs[CQ * CLD];
  __shared__ __align__(16) bf16 ks[CK * CLD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * CQ;
  for (int e = threadIdx.x; e < CQ * PD / 8; e += 128) {
    const int r = e / (PD / 8), c = (e % (PD / 8)) * 8;
    *reinterpret_cast<uint4*>(qs + r * CLD + c) =
        *reinterpret_cast<const uint4*>(a + (q0 + r) * PD + c);
  }
  float o[PD / 8][4] = {};
  for (int k0 = 0; k0 < PK; k0 += CK) {
    __syncthreads();
    for (int e = threadIdx.x; e < CK * PD / 8; e += 128) {
      const int r = e / (PD / 8), c = (e % (PD / 8)) * 8;
      *reinterpret_cast<uint4*>(ks + r * CLD + c) =
          *reinterpret_cast<const uint4*>(b + (k0 + r) * PD + c);
    }
    __syncthreads();
    // s [16 rows, 64 keys] = q . k^T: the nt form, k K-major
    float s[CK / 8][4] = {};
    for (int d = 0; d < PD; d += 16) {
      uint32_t qa[4];
      ptmma::load_a<true>(qa, qs, CLD, warp * 16, d, lane);
      for (int n = 0; n < CK; n += 16) {
        uint32_t kb[2][2];
        ptmma::load_b2<true>(kb, ks, CLD, n, d, lane);
        ptmma::mma_bf16(s[n / 8], qa, kb[0][0], kb[0][1]);
        ptmma::mma_bf16(s[n / 8 + 1], qa, kb[1][0], kb[1][1]);
      }
    }
    for (int n = 0; n < CK / 8; ++n)
      for (int e = 0; e < 4; ++e) s[n][e] = expf(s[n][e] - 1.f);
    // o [16 rows, 128] += p . v, v = the same key tile read N-major
    for (int kk = 0; kk < CK; kk += 16) {
      uint32_t pa[4];
      ptmma::acc_to_a(pa, s[kk / 8], s[kk / 8 + 1]);
      for (int n = 0; n < PD; n += 16) {
        uint32_t vb[2][2];
        ptmma::load_b2<false>(vb, ks, CLD, n, kk, lane);
        ptmma::mma_bf16(o[n / 8], pa, vb[0][0], vb[0][1]);
        ptmma::mma_bf16(o[n / 8 + 1], pa, vb[1][0], vb[1][1]);
      }
    }
  }
  const int r = q0 + warp * 16 + (lane >> 2);
  for (int n = 0; n < PD / 8; ++n) {
    const int c = n * 8 + (lane & 3) * 2;
    out[r * PD + c] = o[n][0];
    out[r * PD + c + 1] = o[n][1];
    out[(r + 8) * PD + c] = o[n][2];
    out[(r + 8) * PD + c + 1] = o[n][3];
  }
}

// forms 4-6 ----------------------------------------------------------------

constexpr uint32_t BOX_BYTES = 64 * 64 * 2;   // a 64 x 64 bf16 box

__device__ __forceinline__ unsigned char* aligned_smem() {
  extern __shared__ unsigned char smem_raw[];
  return smem_raw + ((1024 - (ptwg::smem_u32(smem_raw) & 1023)) & 1023);
}

// out[m0 + row, n0 + col] for every accumulator element of the warpgroup
template <int R>
__device__ __forceinline__ void store_wg(const float (&acc)[R], float* out,
                                         int ld, int m0, int n0) {
  const int lane = threadIdx.x & 31;
  const int r = m0 + (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < R; ++i)
    out[(r + 8 * ((i >> 1) & 1)) * ld + n0 + (i >> 2) * 8 + 2 * (lane & 3) +
        (i & 1)] = acc[i];
}

// form 4 (MN = false): out = a . b^T, a [512, 128], b [512, 128], a 64 x 64
// tile per block; form 5 (MN = true): out = a . b, b [128, 512], a 64 x 128
// tile per block, b's tile two boxes of 64 columns x 128 rows
template <bool MN>
__global__ void __launch_bounds__(128)
    probe_wgmma_ss(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb, float* out) {
  using namespace ptwg;
  constexpr int BN = MN ? 128 : 64;
  constexpr uint32_t B_BOX = MN ? 2 * BOX_BYTES : BOX_BYTES;
  unsigned char* smem = aligned_smem();
  bf16* as = reinterpret_cast<bf16*>(smem);               // 2 boxes
  bf16* bs = reinterpret_cast<bf16*>(smem + 2 * BOX_BYTES);   // 2 boxes
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * BOX_BYTES +
                                              2 * B_BOX);
  const int m0 = blockIdx.x * 64, n0 = blockIdx.y * BN;
  if (threadIdx.x == 0) {
    bar_init(bar, 1);
    bar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bar_arrive_tx(bar, 2 * BOX_BYTES + 2 * B_BOX);
    for (int j = 0; j < 2; ++j) {
      tma_load(as + j * BOX_BYTES / 2, &ta, bar, j * 64, 0, m0, 0);
      if (MN)
        tma_load(bs + j * B_BOX / 2, &tb, bar, n0 + j * 64, 0, 0, 0);
      else
        tma_load(bs + j * B_BOX / 2, &tb, bar, j * 64, 0, n0, 0);
    }
  }
  bar_wait(bar, 0);
  float acc[BN / 2];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < PD / 16; ++kk) {
    if (MN)
      wgmma_ss<1>(acc, desc_kslice(as, kk, BOX_BYTES),
                  desc_mnmajor(bs, B_BOX) + kk * 128, kk > 0);
    else
      wgmma_ss<0>(acc, desc_kslice(as, kk, BOX_BYTES),
                  desc_kslice(bs, kk, BOX_BYTES), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  store_wg(acc, out, PK, m0, n0);
}

// form 6: out [512, 128] = bf16(exp(a . b^T - 1)) . b, a 64-row block per
// CTA, keys in tiles of 64: S on ss, P handed over in registers, P.b on
// rs with the key tile read MN-major
__global__ void __launch_bounds__(128)
    probe_wgmma_chained(const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb, float* out) {
  using namespace ptwg;
  unsigned char* smem = aligned_smem();
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = reinterpret_cast<bf16*>(smem + 2 * BOX_BYTES);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 4 * BOX_BYTES);
  const int q0 = blockIdx.x * 64;
  if (threadIdx.x == 0) {
    bar_init(bar, 1);
    bar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bar_arrive_tx(bar, 2 * BOX_BYTES);
    for (int j = 0; j < 2; ++j)
      tma_load(as + j * BOX_BYTES / 2, &ta, bar, j * 64, 0, q0, 0);
  }
  uint32_t phase = 0;
  bar_wait(bar, phase);
  phase ^= 1;
  float o[PD / 2];
#pragma unroll
  for (int i = 0; i < PD / 2; ++i) o[i] = 0.f;
  for (int k0 = 0; k0 < PK; k0 += 64) {
    __syncthreads();   // every warp's products on the last key tile are done
    if (threadIdx.x == 0) {
      bar_arrive_tx(bar, 2 * BOX_BYTES);
      for (int j = 0; j < 2; ++j)
        tma_load(bs + j * BOX_BYTES / 2, &tb, bar, j * 64, 0, k0, 0);
    }
    bar_wait(bar, phase);
    phase ^= 1;
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PD / 16; ++kk)
      wgmma_ss<0>(s, desc_kslice(as, kk, BOX_BYTES),
                  desc_kslice(bs, kk, BOX_BYTES), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = expf(s[i] - 1.f);
    uint32_t p[4][4];
    acc_to_frag(p, s);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<1>(o, p[kk], desc_mnmajor(bs, BOX_BYTES) + kk * 128, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }
  store_wg(o, out, PD, q0, 0);
}

// form 7: out = a^T . b, a [128, 512], b [128, 512]: a 64 x 128 tile per
// block, both operands MN-major in boxes of 64 columns x 128 rows (A one
// box, B two, 64-wide N blocks a box apart) through rank-2 maps
__global__ void __launch_bounds__(128)
    probe_wgmma_tn(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb, float* out) {
  using namespace ptwg;
  constexpr uint32_t MN_BOX = 2 * BOX_BYTES;   // 64 columns x 128 rows
  unsigned char* smem = aligned_smem();
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = reinterpret_cast<bf16*>(smem + MN_BOX);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 3 * MN_BOX);
  const int m0 = blockIdx.x * 64, n0 = blockIdx.y * 128;
  if (threadIdx.x == 0) {
    bar_init(bar, 1);
    bar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bar_arrive_tx(bar, 3 * MN_BOX);
    tma_load_2d(as, &ta, bar, m0, 0);
    for (int j = 0; j < 2; ++j)
      tma_load_2d(bs + j * MN_BOX / 2, &tb, bar, n0 + j * 64, 0);
  }
  bar_wait(bar, 0);
  float acc[64];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < PD / 16; ++kk)
    wgmma_ss<1, 1>(acc, desc_mnslice(as, kk, MN_BOX),
                   desc_mnslice(bs, kk, MN_BOX), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  store_wg(acc, out, PK, m0, n0);
}

// a [512, 128] (or b [128, 512] for form 5) as a tensor map of 64-column
// boxes
cudaError_t probe_map(CUtensorMap* map, const void* x, int rows, int cols,
                      int box_rows) {
  return ptwg::tile_map(map, x, cols, 1, rows, 1, cols, cols,
                        (long long)rows * cols, box_rows);
}

cudaError_t launch_wgmma(int form, const void* a, const void* b, void* out,
                         cudaStream_t s) {
  CUtensorMap ta, tb;
  cudaError_t err;
  float* o = static_cast<float*>(out);
  if (form == 7) {
    const int smem = 6 * BOX_BYTES + 1024 + 64;
    if ((err = ptwg::matrix_map(&ta, a, PD, PQ, PQ, PD)) != cudaSuccess ||
        (err = ptwg::matrix_map(&tb, b, PD, PK, PK, PD)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(
             probe_wgmma_tn, cudaFuncAttributeMaxDynamicSharedMemorySize,
             smem)) != cudaSuccess)
      return err;
    probe_wgmma_tn<<<dim3(PQ / 64, PK / 128), 128, smem, s>>>(ta, tb, o);
    return cudaGetLastError();
  }
  err = probe_map(&ta, a, PQ, PD, 64);
  if (err == cudaSuccess)
    err = form == 5 ? probe_map(&tb, b, PD, PK, PD)
                    : probe_map(&tb, b, PK, PD, 64);
  if (err != cudaSuccess) return err;
  if (form == 6) {
    const int smem = 4 * BOX_BYTES + 1024 + 64;
    err = cudaFuncSetAttribute(probe_wgmma_chained,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    probe_wgmma_chained<<<PQ / 64, 128, smem, s>>>(ta, tb, o);
    return cudaGetLastError();
  }
  const bool mn = form == 5;
  const int smem = (mn ? 6 : 4) * BOX_BYTES + 1024 + 64;
  auto kernel = mn ? probe_wgmma_ss<true> : probe_wgmma_ss<false>;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(PQ / 64, PK / (mn ? 128 : 64)), 128, smem, s>>>(ta, tb, o);
  return cudaGetLastError();
}

template <bool AK, bool BKM>
cudaError_t launch_gemm(const void* a, const void* b, void* out,
                        cudaStream_t s) {
  constexpr int smem = ptmma::block_mma_smem<AK, BKM>();
  cudaError_t err = cudaFuncSetAttribute(
      probe_gemm<AK, BKM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  probe_gemm<AK, BKM><<<dim3(PQ / ptmma::BM, PK / ptmma::BN), ptmma::THREADS,
                        smem, s>>>(static_cast<const bf16*>(a),
                                   static_cast<const bf16*>(b),
                                   static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// form 0 nt: a [512, 128], b [512, 128] -> out [512, 512] = a . b^T
// form 1 nn: a [512, 128], b [128, 512] -> out [512, 512] = a . b
// form 2 tn: a [128, 512], b [128, 512] -> out [512, 512] = a^T . b
// form 3 chained: a, b [512, 128] -> out [512, 128]
//   = bf16(exp(a . b^T - 1)) . b
// forms 4-7: forms 0, 1, 3 and 2 on wgmma (4 nt ss, 5 nn ss with B
//   MN-major, 6 chained ss -> exp -> bf16 -> rs, 7 tn ss with A and B
//   MN-major through rank-2 tensor maps)
// a, b contiguous bf16, out contiguous fp32. Returns the launch's error.
int pt_mma_probe(int form, const void* a, const void* b, void* out,
                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0: return launch_gemm<true, true>(a, b, out, s);
    case 1: return launch_gemm<true, false>(a, b, out, s);
    case 2: return launch_gemm<false, false>(a, b, out, s);
    case 3:
      probe_chained<<<PQ / CQ, 128, 0, s>>>(static_cast<const bf16*>(a),
                                            static_cast<const bf16*>(b),
                                            static_cast<float*>(out));
      return cudaGetLastError();
    case 4:
    case 5:
    case 6:
    case 7: return launch_wgmma(form, a, b, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
