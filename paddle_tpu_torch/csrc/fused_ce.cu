// Fused lm_head + softmax cross-entropy for Hopper (sm_90a): the [T, V]
// logits never exist in device memory.
//
// Replaces: paddle_tpu/kernels/fused_ce.py
//   _pallas_fwd -> _fwd_kernel (pallas_call at line 147): per token, the
//     logits h.W tile by tile, online max / sum-exp, gold logit by column
//     match; loss = lse - gold and lse.
//   _pallas_bwd -> _dh_kernel (line 177): dl = (exp(l - lse) - onehot) * g,
//     rounded to W's dtype, dh = dl . W^T (vocab contracted).
//   _pallas_bwd -> _dw_kernel (line 193): the same dl rounded to h's dtype,
//     dW = h^T . dl (tokens contracted).
//
// What bounds them: at the llama1b training shape (T = 8192, H = 2048,
// V = 32000, bf16) one T x H x V product is 1.07e12 operations against
// 0.16 GB of h and W: ~1.1 ms at the bf16 tensor-core peak against 0.05 ms
// of bytes. All three are bound by arithmetic, so bf16 runs on the tensor
// cores: warp-level mma.sync m16n8k16 with fp32 accumulators, fragments
// through ldmatrix / ldmatrix.trans (csrc/mma_bf16.cuh, checked form by
// form by csrc/mma_probe.cu). fp32 inputs run in full fp32 on the CUDA
// cores (8 x 8 FMA register blocks; TF32 stays off, the reference's
// 'highest' precision): correct, and slow.
//
// What the design does about it:
//  * one block tile product for every step: 128 x 128 outputs, 32 deep per
//    stage, two cp.async stages, 8 warps; the tile lands in shared memory
//    as fp32 (aliasing the operand stages), where each kernel's epilogue
//    reads it row by row. The TPU kernels' accumulators do not fit a block
//    (dh: [256, H] fp32 = 2 MB; dW: [H, 1024] fp32 = 8 MB), so:
//  * forward: grid (token tiles, vocab splits). Each block walks its share
//    of the vocab tiles keeping per-row (max, sum-exp, gold) in shared
//    memory, and writes them as partials [3, splits, T]; a second small
//    kernel combines the splits per token (lse = M + log sum l_i e^(m_i-M),
//    gold = sum of the one non-zero gold_i). The splits give the card
//    ~1000 blocks at the training shape where token tiles alone give 64.
//  * backward, one vocab chunk of C columns at a time (C = a multiple of
//    32, at most 4096 and under V/4, so the workspace is T x C elements,
//    64 MB at the training shape, never half of T x V):
//      dl kernel:  recompute the logits tile, dl = (p - onehot) * g,
//                  rounded to the input dtype (the reference's rounding
//                  point; h and W share one dtype) -> workspace [T, C];
//      dh kernel:  dh += dl . W[:, chunk]^T into an fp32 [T, H] buffer,
//                  written as dh in h's dtype at the last chunk;
//      dW kernel:  dW[:, chunk] = h^T . dl, the whole token axis in the
//                  block's fp32 registers, written once in W's dtype.
//    That is 3 products (dl's recompute, dh, dW) where the TPU kernels do
//    4 (each of dh and dW recomputes the logits).
//  * every output tile is written by one block, in a fixed order of
//    summation: no atomics, deterministic.
//  * ragged vocab: columns >= V are zero-filled operand rows, masked to
//    -1e30 in the forward (nothing in lse) and give dl = 0 (nothing in dW);
//    dW is [H, V]. Ragged T and H are masked the same way.
//  * ignored rows arrive with label 0 and g = 0 (the wrapper), so dl = 0.
//  * registers: __launch_bounds__(256, 2) caps a thread at 128; ptxas for
//    sm_90a reports 122-128 in every instantiation, with an 8-byte spill
//    in one of the two forward ones. At the training shape the bf16
//    kernels run at ~210-220 TFLOP/s of mma.sync, 4.5-4.8x their bound:
//    wgmma with TMA loads is the road to it.
// Inputs: h [T, H], W [H, V] contiguous, one dtype, H and V multiples of 8
// (tiles move in 16-byte pieces), labels int32 [T] in [0, V).
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ptmma::BK;
using ptmma::BM;
using ptmma::BN;
using ptmma::Operand;
using ptmma::THREADS;

constexpr float NEG_INF = -1e30f;
constexpr int LDC = BN + 8;   // fp32 output tile row stride in shared memory
constexpr int C_BYTES = BM * LDC * static_cast<int>(sizeof(float));

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// -- the block tile product: C tile (fp32, shared, [BM][LDC]) ------------

// fp32 on the CUDA cores: thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty + 16 i and cols tx + 16 j, i, j < 8; same two-stage cp.async pipeline
// and tiles as ptmma::block_mma.
template <bool AK, bool BKM>
__device__ __forceinline__ void block_fma(float* cs, const Operand<float>& A,
                                          const Operand<float>& B, int m0,
                                          int n0, int K, float* smem) {
  constexpr int A_ELEMS = ptmma::tile_elems<float, AK, BM>();
  constexpr int B_ELEMS = ptmma::tile_elems<float, BKM, BN>();
  constexpr int LDA = ptmma::tile_ld<float, AK, BM>();
  constexpr int LDB = ptmma::tile_ld<float, BKM, BN>();
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int steps = (K + BK - 1) / BK;
  ptmma::load_tile_async<float, AK, BM>(smem, A, m0, 0);
  ptmma::load_tile_async<float, BKM, BN>(smem + A_ELEMS, B, n0, 0);
  ptmma::cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    float* cur = smem + (s & 1) * (A_ELEMS + B_ELEMS);
    if (s + 1 < steps) {
      float* nxt = smem + ((s + 1) & 1) * (A_ELEMS + B_ELEMS);
      ptmma::load_tile_async<float, AK, BM>(nxt, A, m0, (s + 1) * BK);
      ptmma::load_tile_async<float, BKM, BN>(nxt + A_ELEMS, B, n0,
                                             (s + 1) * BK);
    }
    ptmma::cp_async_commit();
    ptmma::cp_async_wait<1>();
    __syncthreads();
    const float* As = cur;
    const float* Bs = cur + A_ELEMS;
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = AK ? As[(ty + 16 * i) * LDA + k] : As[k * LDA + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = BKM ? Bs[(tx + 16 * j) * LDB + k] : Bs[k * LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  ptmma::cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) cs[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
  __syncthreads();
}

// C tile [BM][LDC] in shared memory (aliasing the operand stages) =
// A[m0:+BM, :K] . B[:K, n0:+BN]; every thread may read it on return.
template <bool AK, bool BKM>
__device__ __forceinline__ void tile_product(float* cs,
                                             const Operand<bf16>& A,
                                             const Operand<bf16>& B, int m0,
                                             int n0, int K, void* smem) {
  float acc[4][4][4];
  ptmma::block_mma<AK, BKM>(acc, A, B, m0, n0, K, static_cast<bf16*>(smem));
  __syncthreads();   // cs aliases the stages the last slice was read from
  ptmma::store_acc(acc, cs, LDC, 0, 0, BM, BN);
  __syncthreads();
}
template <bool AK, bool BKM>
__device__ __forceinline__ void tile_product(float* cs,
                                             const Operand<float>& A,
                                             const Operand<float>& B, int m0,
                                             int n0, int K, void* smem) {
  block_fma<AK, BKM>(cs, A, B, m0, n0, K, static_cast<float*>(smem));
}

template <typename T, bool AK, bool BKM>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int stages = 2 * (ptmma::tile_elems<T, AK, BM>() +
                              ptmma::tile_elems<T, BKM, BN>()) *
                         static_cast<int>(sizeof(T));
  return stages > C_BYTES ? stages : C_BYTES;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

// -- forward ------------------------------------------------------------

// grid (ceil(T / BM), splits): block (x, y) walks vocab tiles
// y * per_split .. and leaves per-row partial (max, sum-exp, gold) in
// part[0 / 1 / 2][y][T]. Logits: A = h (K-major), B = W (N-major).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    fce_fwd_partial(const T* __restrict__ h, const T* __restrict__ w,
                    const int* __restrict__ labels, float* __restrict__ part,
                    int t_len, int hid, int vocab, int per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float m_s[BM], l_s[BM], g_s[BM];
  float* cs = reinterpret_cast<float*>(smem);
  const Operand<T> A{h, hid, t_len, hid};
  const Operand<T> B{w, vocab, vocab, hid};
  const int m0 = blockIdx.x * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < BM) {
    m_s[threadIdx.x] = NEG_INF;
    l_s[threadIdx.x] = 0.f;
    g_s[threadIdx.x] = 0.f;
  }
  const int tiles = (vocab + BN - 1) / BN;
  const int split = blockIdx.y;
  const int v_end = min(tiles, (split + 1) * per_split);
  for (int vt = split * per_split; vt < v_end; ++vt) {
    const int n0 = vt * BN;
    tile_product<true, false>(cs, A, B, m0, n0, hid, smem);
    for (int rr = 0; rr < BM / 8; ++rr) {
      const int r = warp * (BM / 8) + rr, row = m0 + r;
      if (row >= t_len) break;
      const int label = labels[row];
      float s[4], tmax = NEG_INF, gold = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + lane + 32 * j;
        s[j] = col < vocab ? cs[r * LDC + lane + 32 * j] : NEG_INF;
        tmax = fmaxf(tmax, s[j]);
        if (col == label) gold = s[j];
      }
      tmax = warp_max(tmax);
      const float m_old = m_s[r], m_new = fmaxf(m_old, tmax);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += expf(s[j] - m_new);
      sum = warp_sum(sum);
      gold = warp_sum(gold);
      if (lane == 0) {
        l_s[r] = expf(m_old - m_new) * l_s[r] + sum;
        m_s[r] = m_new;
        g_s[r] += gold;
      }
    }
    __syncthreads();   // the next tile's copies overwrite cs
  }
  if (threadIdx.x < BM && m0 + threadIdx.x < t_len) {
    const long long i =
        static_cast<long long>(blockIdx.y) * t_len + m0 + threadIdx.x;
    const long long plane = static_cast<long long>(gridDim.y) * t_len;
    part[i] = m_s[threadIdx.x];
    part[plane + i] = l_s[threadIdx.x];
    part[2 * plane + i] = g_s[threadIdx.x];
  }
}

__global__ void fce_fwd_combine(const float* __restrict__ part,
                                float* __restrict__ loss,
                                float* __restrict__ lse, int t_len,
                                int splits) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= t_len) return;
  const long long plane = static_cast<long long>(splits) * t_len;
  float m = NEG_INF;
  for (int y = 0; y < splits; ++y) m = fmaxf(m, part[y * t_len + row]);
  float l = 0.f, gold = 0.f;
  for (int y = 0; y < splits; ++y) {
    const long long i = static_cast<long long>(y) * t_len + row;
    l += expf(part[i] - m) * part[plane + i];
    gold += part[2 * plane + i];
  }
  const float x = m + logf(l);
  lse[row] = x;
  loss[row] = x - gold;
}

// -- backward -------------------------------------------------------------

// grid (ceil(T / BM), ceil(cw / BN)): dl[t][c] for the chunk's columns
// c0 + c, c < cw = min(C, V - c0), rounded to T, in a [T, ld_dl] workspace.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    fce_bwd_dl(const T* __restrict__ h, const T* __restrict__ w,
               const int* __restrict__ labels, const float* __restrict__ lse,
               const float* __restrict__ g, T* __restrict__ dl, int t_len,
               int hid, int vocab, int c0, int cw, int ld_dl) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);
  const Operand<T> A{h, hid, t_len, hid};
  const Operand<T> B{w + c0, vocab, cw, hid};
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  tile_product<true, false>(cs, A, B, m0, n0, hid, smem);
  for (int rr = 0; rr < BM / 8; ++rr) {
    const int r = warp * (BM / 8) + rr, row = m0 + r;
    if (row >= t_len) break;
    const float x = lse[row], gt = g[row];
    const int label = labels[row] - c0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + lane + 32 * j;
      if (c < cw) {
        const float p = expf(cs[r * LDC + lane + 32 * j] - x);
        store(dl + static_cast<long long>(row) * ld_dl + c,
              (p - (c == label ? 1.f : 0.f)) * gt);
      }
    }
  }
}

// grid (ceil(T / BM), ceil(H / BN)): acc (+)= dl . W[:, chunk]^T; at the
// last chunk the sum goes to dh in T instead. A = dl (K-major),
// B(k = v, n = j) = W[j][c0 + v] (K-major).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    fce_bwd_dh(const T* __restrict__ dl, const T* __restrict__ w,
               float* __restrict__ acc, T* __restrict__ dh, int t_len,
               int hid, int vocab, int c0, int cw, int ld_dl, int first,
               int last) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);
  const Operand<T> A{dl, ld_dl, t_len, cw};
  const Operand<T> B{w + c0, vocab, hid, cw};
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  tile_product<true, true>(cs, A, B, m0, n0, cw, smem);
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN, row = m0 + r, col = n0 + c;
    if (row >= t_len || col >= hid) continue;
    const long long i = static_cast<long long>(row) * hid + col;
    float v = cs[r * LDC + c];
    if (!first) v += acc[i];
    if (last)
      store(dh + i, v);
    else
      acc[i] = v;
  }
}

// grid (ceil(H / BM), ceil(cw / BN)): dW[:, c0 + c] = h^T . dl over all T.
// A(m = j, k = t) = h[t][j] (M-major), B(k = t, n = c) = dl[t][c] (N-major).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    fce_bwd_dw(const T* __restrict__ h, const T* __restrict__ dl,
               T* __restrict__ dw, int t_len, int hid, int vocab, int c0,
               int cw, int ld_dl) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* cs = reinterpret_cast<float*>(smem);
  const Operand<T> A{h, hid, hid, t_len};
  const Operand<T> B{dl, ld_dl, cw, t_len};
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  tile_product<false, false>(cs, A, B, m0, n0, t_len, smem);
  for (int e = threadIdx.x; e < BM * BN; e += THREADS) {
    const int r = e / BN, c = e % BN, row = m0 + r, col = n0 + c;
    if (row < hid && col < cw)
      store(dw + static_cast<long long>(row) * vocab + c0 + col,
            cs[r * LDC + c]);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel k, int bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

dim3 grid_of(int rows, int cols) {
  return dim3((rows + BM - 1) / BM, (cols + BN - 1) / BN);
}

template <typename T>
cudaError_t fwd(const void* h, const void* w, const int* labels, float* loss,
                float* lse, float* part, int t_len, int hid, int vocab,
                int splits, cudaStream_t s) {
  constexpr int smem = smem_bytes<T, true, false>();
  cudaError_t err = allow_smem(fce_fwd_partial<T>, smem);
  if (err != cudaSuccess) return err;
  const int v_tiles = (vocab + BN - 1) / BN;
  const int per_split = (v_tiles + splits - 1) / splits;
  fce_fwd_partial<T><<<dim3((t_len + BM - 1) / BM, splits), THREADS, smem, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), labels, part, t_len,
      hid, vocab, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fce_fwd_combine<<<(t_len + 255) / 256, 256, 0, s>>>(part, loss, lse, t_len,
                                                      splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dl(const void* h, const void* w, const int* labels,
                   const float* lse, const float* g, void* dl, int t_len,
                   int hid, int vocab, int c0, int cw, int ld_dl,
                   cudaStream_t s) {
  constexpr int smem = smem_bytes<T, true, false>();
  cudaError_t err = allow_smem(fce_bwd_dl<T>, smem);
  if (err != cudaSuccess) return err;
  fce_bwd_dl<T><<<grid_of(t_len, cw), THREADS, smem, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), labels, lse, g,
      static_cast<T*>(dl), t_len, hid, vocab, c0, cw, ld_dl);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dh(const void* dl, const void* w, float* acc, void* dh,
                   int t_len, int hid, int vocab, int c0, int cw, int ld_dl,
                   int first, int last, cudaStream_t s) {
  constexpr int smem = smem_bytes<T, true, true>();
  cudaError_t err = allow_smem(fce_bwd_dh<T>, smem);
  if (err != cudaSuccess) return err;
  fce_bwd_dh<T><<<grid_of(t_len, hid), THREADS, smem, s>>>(
      static_cast<const T*>(dl), static_cast<const T*>(w), acc,
      static_cast<T*>(dh), t_len, hid, vocab, c0, cw, ld_dl, first, last);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dw(const void* h, const void* dl, void* dw, int t_len,
                   int hid, int vocab, int c0, int cw, int ld_dl,
                   cudaStream_t s) {
  constexpr int smem = smem_bytes<T, false, false>();
  cudaError_t err = allow_smem(fce_bwd_dw<T>, smem);
  if (err != cudaSuccess) return err;
  fce_bwd_dw<T><<<grid_of(hid, cw), THREADS, smem, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(dl),
      static_cast<T*>(dw), t_len, hid, vocab, c0, cw, ld_dl);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// h [T, H], w [H, V] contiguous, dtype 0 = float32, 1 = bfloat16; labels
// [T] int32 in [0, V); loss, lse [T] float32; part [3, splits, T] float32
// scratch, 1 <= splits <= ceil(V / 128). Two launches (partials, combine).
int pt_fused_ce_fwd(const void* h, const void* w, const void* labels,
                    void* loss, void* lse, void* part, int t_len, int hid,
                    int vocab, int splits, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  float* pa = static_cast<float*>(part);
  if (dtype == 0)
    return fwd<float>(h, w, lab, lo, ls, pa, t_len, hid, vocab, splits, s);
  if (dtype == 1)
    return fwd<bf16>(h, w, lab, lo, ls, pa, t_len, hid, vocab, splits, s);
  return cudaErrorInvalidValue;
}

// One vocab chunk, columns c0 .. c0 + cw - 1: dl [T, ld_dl] (h's dtype)
// from h, w, labels, lse and g (float32 [T], 0 on ignored rows).
int pt_fused_ce_bwd_dl(const void* h, const void* w, const void* labels,
                       const void* lse, const void* g, void* dl, int t_len,
                       int hid, int vocab, int c0, int cw, int ld_dl,
                       int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* gt = static_cast<const float*>(g);
  if (dtype == 0)
    return bwd_dl<float>(h, w, lab, ls, gt, dl, t_len, hid, vocab, c0, cw,
                         ld_dl, s);
  if (dtype == 1)
    return bwd_dl<bf16>(h, w, lab, ls, gt, dl, t_len, hid, vocab, c0, cw,
                        ld_dl, s);
  return cudaErrorInvalidValue;
}

// acc [T, H] float32 (unused when first and last), dh [T, H] h's dtype
int pt_fused_ce_bwd_dh(const void* dl, const void* w, void* acc, void* dh,
                       int t_len, int hid, int vocab, int c0, int cw,
                       int ld_dl, int first, int last, int dtype,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(acc);
  if (dtype == 0)
    return bwd_dh<float>(dl, w, a, dh, t_len, hid, vocab, c0, cw, ld_dl,
                         first, last, s);
  if (dtype == 1)
    return bwd_dh<bf16>(dl, w, a, dh, t_len, hid, vocab, c0, cw, ld_dl,
                        first, last, s);
  return cudaErrorInvalidValue;
}

// dw [H, V] in W's dtype: columns c0 .. c0 + cw - 1 written
int pt_fused_ce_bwd_dw(const void* h, const void* dl, void* dw, int t_len,
                       int hid, int vocab, int c0, int cw, int ld_dl,
                       int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_dw<float>(h, dl, dw, t_len, hid, vocab, c0, cw, ld_dl, s);
  if (dtype == 1)
    return bwd_dw<bf16>(h, dl, dw, t_len, hid, vocab, c0, cw, ld_dl, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
