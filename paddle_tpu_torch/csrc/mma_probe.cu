// The bf16 tensor-core form probe for Hopper (sm_90a).
//
// Replaces: tools/mosaic_probe.py, `probe` (the pallas_call at line 19),
// which asks whether the TPU compiler takes four bf16 dot forms at
// BQ = BK = 512, D = 128 with fp32 results: nt (contracting dims (1,1)),
// nn ((1,0)), tn ((0,0)) and nt -> exp -> cast -> nn chained. Here each
// form runs through the building blocks of csrc/mma_bf16.cuh that the
// fused lm_head + cross-entropy kernels use (ldmatrix / ldmatrix.trans
// fragment loads, mma.sync m16n8k16 bf16 -> fp32, the register hand-over
// of acc_to_a), and tools/mma_probe.py holds each result against the same
// product taken in fp32 by PyTorch: a wrong fragment layout shows here as
// a wrong value of one form, not as a wrong loss.
//
// What bounds it: each form is 2 * 512 * 512 * 128 = 6.7e7 operations on
// ~1.3 MB, so at this size it is bound by bytes and by its launch; the
// probe checks layouts and values, its time is printed for reference.
// Design: the three plain forms are one 128 x 128 block tile each
// (ptmma::block_mma, 16 blocks); the chained form is a flash-attention
// shaped kernel, 4 warps of 16 query rows per block, keys in tiles of 64.
#include "mma_bf16.cuh"

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
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
