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
// cores; fp32 inputs run in full fp32 on the CUDA cores (TF32 stays off,
// the reference's 'highest' precision), at the training shape 16 ms a
// product at the fp32 peak.
//
// Every kernel writes each output tile from one CTA, in a fixed order of
// summation: no atomics, deterministic. Ragged T and H are masked; ignored
// rows arrive with label 0 and g = 0 (the wrapper), so their dl is 0.
//
// float32 (h and W float32): the forward and all three backward products
// run on csrc/f32_gemm.cuh's main loop (8 x 16 outputs a thread in 128 x
// 128 tiles of 128 threads, two CTAs an SM, both operands k-slow in shared
// memory, 128-bit fragment reads; its head says why), each with a register
// epilogue that takes the thread's accumulators four columns at a time:
//  * forward (fce_fwd_partial): grid (token tiles, vocab splits), the
//    split count from kernels/fused_ce.py forward_splits (the fewest
//    tile-times of the busiest CTA slot). Each CTA walks its split's vocab
//    tiles on one loop, and each thread folds its columns into a running
//    (max, sum-exp, gold) of its 8 rows in shared memory (its own slots:
//    no barrier a tile); at the end the 8 lanes that share a row merge
//    theirs by xor shuffles and write the partials [3, splits, T].
//  * dl (fce_bwd_dl): the chunk's logits tile -> (p - onehot) * g as
//    float4 stores into the workspace.
//  * dh (fce_bwd_dh): dl . W^T, both operands K-major, (+)= the fp32
//    buffer; where 128-row tiles would leave SMs without a CTA (T = 1024)
//    fce_bwd_dh64 takes 64-row tiles of 8 x 8 a thread, twice the CTAs,
//    by ptf32::query_tile_rows (csrc/f32_tiles.cuh), the float32 flash
//    kernels' rule.
//  * dW (fce_bwd_dw): h^T . dl over all T, both operands MN-major (the
//    token axis is k, and both h and dl hold it as their slow axis), so
//    both stages are stored as they lie; float4 stores straight into dW,
//    one writer an element.
//
// Either dtype's forward ends in one small kernel, fce_fwd_combine, that
// combines the splits per token: lse = M + log sum l_i e^(m_i - M), gold
// = the sum of the one non-zero gold_i, loss = lse - gold, one thread a
// row in a fixed order of summation. m_i and lse are in the natural log.
//
// Backward, one vocab chunk of C columns at a time (C a multiple of 32,
// at most 4096 and under V/4, so the workspace is T x C elements, 64 MB at
// the training shape, never half of T x V), three products per chunk
// where the TPU kernels do four (each of dh and dW recomputes the logits):
//   dl:  recompute the logits tile, dl = (p - onehot) * g, rounded to the
//        input dtype (the reference's rounding point; h and W share one
//        dtype) -> workspace [T, C];
//   dh:  dh += dl . W[:, chunk]^T into an fp32 [T, H] buffer, written as
//        dh in h's dtype at the last chunk;
//   dW:  dW[:, chunk] = h^T . dl over the whole token axis, written once in
//        W's dtype; columns of dW >= V are never written.
//
// bfloat16 and float16 (namespace tc) run all four products, the forward's
// logits and the backward's three, through one warp-specialized wgmma
// main loop, gemm(), building blocks in csrc/wgmma_bf16.cuh. float16 (the
// reference's kernels take any float dtype: fused_ce.py:44-133) is the
// same code with another operand type: the kernels and epilogues take it
// as a template parameter T (bf16 or __half), the tensor maps name it
// (ptwg::tma_type<T>), wgmma runs .f32.f16.f16 where bf16 runs
// .f32.bf16.bf16, and each epilogue's pair store rounds to T (ptwg::
// store2<T>: __floats2half2_rn in float16). Nothing is clamped: dl
// underflows to zero and dh / dW overflow to inf in float16 exactly where
// a rounding to float16 puts them, as in the plain version. The launch
// arguments do not grow (a by-value Args grown by one int slowed the flash
// backward ~45 %), so the bf16 instances compile as before:
//  * 384 threads a CTA, one CTA an SM, persistent over the product's
//    128 x 256 output tiles, M tile fastest: a producer warpgroup (24
//    registers after setmaxnreg; its first warp issues the TMA, the other
//    three leave) and two consumer warpgroups (240 registers) of 64 output
//    rows each, on two m64n128k16 wgmma per k16 slice with 128 fp32
//    accumulators a thread. (128 x 128 tiles were right first, and slower:
//    the 256-wide B tile halves the A traffic per product.)
//  * operands come as 64 x 64 boxes of T with 128-byte swizzle through
//    rank-2 tensor maps into a ring of 4 stages (48 KB each: two A boxes,
//    one per consumer, and four B boxes), guarded by full (one arrival
//    plus the bytes) and empty (one arrival per consumer warp) mbarriers.
//    The ring runs on across tiles, so the next tile's loads overlap this
//    tile's epilogue.
//  * each epilogue reads its accumulators in registers (the layout of
//    wgmma_bf16.cuh) and writes partials, T pairs or fp32 pairs
//    straight to device memory; nothing goes through an fp32 shared-memory
//    tile and no epilogue has a __syncthreads().
//  * forward (fce_fwd_wgmma): C[T, V] = h . W in one product over the
//    whole vocab, no chunks (at the training shape 64 x 125 = 8000 tiles
//    over 132 CTAs). Its epilogue reduces each row of its 64 x 256 tile to
//    (max, sum-exp, gold) in registers and the quad's shuffles, and one
//    lane writes them to the partials at split = the N tile's index:
//    splits = ceil(V / 256) exactly (12.3 MB of partials at the training
//    shape). The max is known before the exp, so no tile rescales.
//  * dh's epilogue loads the fp32 buffer's 16 pairs of a row half before
//    it adds any, so their latencies overlap (a load just before each add
//    left the tile waiting on one load at a time).
//  Where trouble was likely, and what the design does:
//   1. transpose-A: dW = h^T . dl reads h with the token axis (k) as the
//      stored row, i.e. A MN-major; wgmma_ss takes a TRANS_A bit and
//      desc_mnslice the slice, both checked by mma_probe.cu form 7 (A and
//      B MN-major) before the dW kernel relies on them.
//   2. tensor maps: a rank-2 matrix_map (base, rows, cols, row stride, 64
//      x 64 boxes); every operand is a plain row-major matrix.
//   3. chunk edges: the workspace's row stride is C, and where cw < C its
//      columns cw..C still hold an earlier chunk's dl. The dl map that dh
//      and dW read has extent cw, so TMA fills those columns with zeros.
//   4. W tiles past the chunk: in the dl product a W box may run past c0 +
//      cw (the next chunk's columns) or past V (zeros); exp(acc - lse) is
//      not 0 there, so the epilogue stores only c < cw.
//   5. columns past V in the forward: TMA's zeros would add exp(0 - max)
//      to the last tile's sum, so the forward epilogue leaves every column
//      c >= V out of the max and the sum, which is what the reference's
//      finite -1e30 gives (exp to exactly 0). Every tile holds a column
//      < V, so no row's max stays -1e30.
//   6. rows past T: TMA zero-fills them; no epilogue writes them.
//   7. the log domain: the forward's max stays in the natural log, as the
//      combine and the backward (lse * LOG2E in the dl epilogue) read it;
//      only the exponent goes through ex2.approx, as fmaf(x, LOG2E, -max *
//      LOG2E).
//   8. ragged edges are exercised by chip_smoke.py's fused-CE cases: V =
//      40000 (last chunk 3136, last forward tile 64 columns wide), V =
//      2000 (chunk 480, last chunk 80, last forward tile 208 wide) and T =
//      1000 (the last 128-row tile 104 rows deep).
//   9. registers: 128 accumulators plus the epilogue's exp, label
//      compare and packing (dh: 32 more for the buffer's pairs; the
//      forward: two rows' max, sum, gold and label) within 240;
//      chip_smoke.py phase 2 prints ptxas's registers and spill bytes of
//      each kernel.
//  10. determinism: one writer per partial and per output element, sums in
//      a fixed order (a thread's values, then xor 1, then xor 2; the
//      combine's loop over splits), no atomics: two launches give the same
//      bits.
//  11. alignment: the wrapper requires h and W contiguous, 16-byte
//      aligned, H and V multiples of 8, so every TMA stride is a multiple
//      of 16 bytes, as is the workspace's (C a multiple of 32).
//  12. names keep the fce_ prefix (tools/train_profile.py groups by it,
//      tools/fce_timing.py counts fce_fwd* as the forward).
//  13. _build.HEADERS["fused_ce"] lists wgmma_bf16.cuh, so an edit to it
//      rebuilds this library.
// Inputs: h [T, H], W [H, V] contiguous, one dtype, H and V multiples of 8
// (tiles move in 16-byte pieces), labels int32 [T] in [0, V).
#include "f32_gemm.cuh"
#include "f32_tiles.cuh"
#include "wgmma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BM = 128, BN = 128;   // the float32 kernels' block tile

// -- forward, float32: the CUDA cores --------------------------------------

// the forward's and dl's tile (A = h K-major, B = W N-major), dh's
// (A = dl, B = W^T, both K-major) and dW's (A = h^T, B = dl, both
// MN-major): 128 x 128 outputs, 8 x 16 a thread
using Wide = ptf32gemm::Shape<BM, BN, 16, true, false>;
using WideT = ptf32gemm::Shape<BM, BN, 16, true, true>;
using WideMN = ptf32gemm::Shape<BM, BN, 16, false, false>;
// dh's where WideT's grid would leave SMs without a CTA: 64 x 128, 8 x 8
using Narrow = ptf32gemm::Shape<64, BN, 8, true, true>;
using ptf32gemm::Mat;
// a forward thread's running state: (max, sum-exp, gold) of its 8 rows
constexpr int FWD_STATE = 3 * 8;
constexpr int FWD_SMEM = Wide::SMEM_BYTES + FWD_STATE * Wide::THREADS * 4;

// (m, l) of two partial softmax sums over disjoint columns, in one sum:
// the max, and each sum rescaled to it (both -1e30 gives (-1e30, 0))
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float x = fmaxf(m, m2);
  l = l * expf(m - x) + l2 * expf(m2 - x);
  m = x;
}

// The forward's epilogue: each thread folds its logits, four columns at a
// time, into the running (max, sum-exp, gold) of its 8 rows, kept in
// shared memory as st[q][THREADS] (the thread's own column: no barrier).
// Columns >= V take no part (the reference's -1e30, exp to exactly 0; V
// is a multiple of 8, so four columns are all in or all out); the max is
// in the natural log, as the combine reads it.
struct FwdTile {
  float* st;          // [FWD_STATE][Wide::THREADS]
  const int* label;   // the CTA's rows' labels, -1 past T
  int m0, vocab;

  __device__ __forceinline__ void operator()(int i, int row, int col,
                                             float4 v) const {
    if (col >= vocab) return;
    const int lab = label[row - m0] - col;
    float* mine = st + threadIdx.x;
    float& m = mine[i * Wide::THREADS];
    float& l = mine[(8 + i) * Wide::THREADS];
    const float x = fmaxf(m, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
    l = l * expf(m - x) + ((expf(v.x - x) + expf(v.y - x)) +
                           (expf(v.z - x) + expf(v.w - x)));
    m = x;
    if (lab >= 0 && lab < 4)
      mine[(16 + i) * Wide::THREADS] += lab == 0   ? v.x
                                        : lab == 1 ? v.y
                                        : lab == 2 ? v.z
                                                   : v.w;
  }
};

// grid (ceil(T / BM), splits): block (x, y) walks vocab tiles
// y * per_split .. on one f32_gemm loop (A = h K-major, B = W N-major),
// each thread keeping its rows' running state over its columns; at the
// end the 8 column lanes of a row merge theirs in a fixed order (xor 1,
// 2, 4: a warp spans the tile's 128 columns) and lane 0 writes the
// per-row partial (max, sum-exp, gold) to part[0 / 1 / 2][y][T].
__global__ void __launch_bounds__(Wide::THREADS, 2)
    fce_fwd_partial(const float* __restrict__ h, const float* __restrict__ w,
                    const int* __restrict__ labels, float* __restrict__ part,
                    int t_len, int hid, int vocab, int per_split) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int label_s[BM];
  float* st = reinterpret_cast<float*>(smem + Wide::SMEM_BYTES);
  const int m0 = blockIdx.x * BM, tid = threadIdx.x;
  if (tid < BM) label_s[tid] = m0 + tid < t_len ? labels[m0 + tid] : -1;
#pragma unroll
  for (int q = 0; q < FWD_STATE; ++q)
    st[q * Wide::THREADS + tid] = q < 8 ? NEG_INF : 0.f;
  __syncthreads();
  const int tiles = (vocab + BN - 1) / BN;
  const int nt0 = blockIdx.y * per_split;
  const FwdTile epi{st, label_s, m0, vocab};
  ptf32gemm::gemm<Wide>(
      Mat{h, hid, t_len, hid}, Mat{w, vocab, vocab, hid}, m0, nt0,
      min(tiles, nt0 + per_split), hid, reinterpret_cast<float*>(smem), epi);
  const int lane = tid & 31;
  const int row = m0 + (tid >> 5) * ptf32gemm::WARP_M + (lane >> 3) * 4;
  const long long plane = static_cast<long long>(gridDim.y) * t_len;
  float* out = part + static_cast<long long>(blockIdx.y) * t_len;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float m = st[i * Wide::THREADS + tid];
    float l = st[(8 + i) * Wide::THREADS + tid];
    float g = st[(16 + i) * Wide::THREADS + tid];
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      merge(m, l, __shfl_xor_sync(~0u, m, o), __shfl_xor_sync(~0u, l, o));
      g += __shfl_xor_sync(~0u, g, o);
    }
    const int r = row + (i & 3) + 16 * (i >> 2);
    if ((lane & 7) == 0 && r < t_len) {
      out[r] = m;
      out[plane + r] = l;
      out[2 * plane + r] = g;
    }
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

// loss and lse from the partials [3, splits, T], one thread a row
cudaError_t combine(const float* part, float* loss, float* lse, int t_len,
                    int splits, cudaStream_t s) {
  fce_fwd_combine<<<(t_len + 255) / 256, 256, 0, s>>>(part, loss, lse, t_len,
                                                      splits);
  return cudaGetLastError();
}

// -- backward, float32: the CUDA cores ------------------------------------

// dl[t][c] = (exp(l - lse) - [c == label]) * g for the chunk's columns
// c0 + c, c < cw, as float4 stores into the [T, ld] workspace; rows past T
// and columns past cw (W's next chunk, or zeros past V) get nothing (cw is
// a multiple of 8: four columns are all in or all out).
struct DlTile {
  const int* labels;
  const float* lse;
  const float* g;
  float* dl;
  int t_len, c0, cw, ld;

  __device__ __forceinline__ void operator()(int, int row, int col,
                                             float4 v) const {
    if (row >= t_len || col >= cw) return;
    const float x = lse[row], gt = g[row];
    const int lab = labels[row] - c0 - col;
    v.x = (expf(v.x - x) - (lab == 0 ? 1.f : 0.f)) * gt;
    v.y = (expf(v.y - x) - (lab == 1 ? 1.f : 0.f)) * gt;
    v.z = (expf(v.z - x) - (lab == 2 ? 1.f : 0.f)) * gt;
    v.w = (expf(v.w - x) - (lab == 3 ? 1.f : 0.f)) * gt;
    *reinterpret_cast<float4*>(dl + static_cast<long long>(row) * ld + col) =
        v;
  }
};

// dh (+)= acc: the chunk's sum joins the fp32 [T, H] buffer (first: is
// it); at the last chunk the total goes to dh instead. float4 pieces (H is
// a multiple of 8).
struct DhTile {
  float* buf;
  float* dh;
  int t_len, hid, first, last;

  __device__ __forceinline__ void operator()(int, int row, int col,
                                             float4 v) const {
    if (row >= t_len || col >= hid) return;
    const long long at = static_cast<long long>(row) * hid + col;
    if (!first) {
      const float4 o = *reinterpret_cast<const float4*>(buf + at);
      v.x += o.x;
      v.y += o.y;
      v.z += o.z;
      v.w += o.w;
    }
    *reinterpret_cast<float4*>((last ? dh : buf) + at) = v;
  }
};

// dW[row][c0 + col] = acc for row < H and col < cw, as float4 stores (V is
// a multiple of 8 and c0 of 32, so they are 16-byte aligned)
struct DwTile {
  float* dw;
  int hid, vocab, c0, cw;

  __device__ __forceinline__ void operator()(int, int row, int col,
                                             float4 v) const {
    if (row >= hid || col >= cw) return;
    *reinterpret_cast<float4*>(dw + static_cast<long long>(row) * vocab + c0 +
                               col) = v;
  }
};

// grid (ceil(T / BM), ceil(cw / BN)): dl for the chunk's columns c0 + c,
// c < cw = min(C, V - c0), in a [T, ld_dl] workspace; A = h (K-major),
// B = W[:, c0:] (N-major), on the f32_gemm loop.
__global__ void __launch_bounds__(Wide::THREADS, 2)
    fce_bwd_dl(const float* __restrict__ h, const float* __restrict__ w,
               const int* __restrict__ labels, const float* __restrict__ lse,
               const float* __restrict__ g, float* __restrict__ dl, int t_len,
               int hid, int vocab, int c0, int cw, int ld_dl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DlTile epi{labels, lse, g, dl, t_len, c0, cw, ld_dl};
  ptf32gemm::gemm<Wide>(
      Mat{h, hid, t_len, hid}, Mat{w + c0, vocab, cw, hid}, blockIdx.x * BM,
      blockIdx.y, blockIdx.y + 1, hid, reinterpret_cast<float*>(smem), epi);
}

// grid (ceil(T / BM), ceil(H / BN)): acc (+)= dl . W[:, chunk]^T; at the
// last chunk the sum goes to dh instead. A = dl (K-major, extent cw: the
// workspace's columns cw.. still hold an earlier chunk's dl and are never
// read), B(k = v, n = j) = W[j][c0 + v] (K-major), on the f32_gemm loop.
__global__ void __launch_bounds__(WideT::THREADS, 2)
    fce_bwd_dh(const float* __restrict__ dl, const float* __restrict__ w,
               float* __restrict__ acc, float* __restrict__ dh, int t_len,
               int hid, int vocab, int c0, int cw, int ld_dl, int first,
               int last) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DhTile epi{acc, dh, t_len, hid, first, last};
  ptf32gemm::gemm<WideT>(
      Mat{dl, ld_dl, t_len, cw}, Mat{w + c0, vocab, hid, cw},
      blockIdx.x * BM, blockIdx.y, blockIdx.y + 1, cw,
      reinterpret_cast<float*>(smem), epi);
}

// fce_bwd_dh on Narrow tiles (64 rows, 8 x 8 a thread): twice the CTAs and
// warps, for a grid of Wide tiles that would leave SMs without a CTA
// (ptf32::query_tile_rows)
__global__ void __launch_bounds__(Narrow::THREADS, 4)
    fce_bwd_dh64(const float* __restrict__ dl, const float* __restrict__ w,
                 float* __restrict__ acc, float* __restrict__ dh, int t_len,
                 int hid, int vocab, int c0, int cw, int ld_dl, int first,
                 int last) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DhTile epi{acc, dh, t_len, hid, first, last};
  ptf32gemm::gemm<Narrow>(
      Mat{dl, ld_dl, t_len, cw}, Mat{w + c0, vocab, hid, cw},
      blockIdx.x * 64, blockIdx.y, blockIdx.y + 1, cw,
      reinterpret_cast<float*>(smem), epi);
}

// grid (ceil(H / BM), ceil(cw / BN)): dW[:, c0 + c] = h^T . dl over all T.
// A(m = j, k = t) = h[t][j] (M-major), B(k = t, n = c) = dl[t][c] (N-major,
// extent cw: the workspace's columns cw.. are never read), on the f32_gemm
// loop; each element's sum runs over t in order.
__global__ void __launch_bounds__(WideMN::THREADS, 2)
    fce_bwd_dw(const float* __restrict__ h, const float* __restrict__ dl,
               float* __restrict__ dw, int t_len, int hid, int vocab, int c0,
               int cw, int ld_dl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DwTile epi{dw, hid, vocab, c0, cw};
  ptf32gemm::gemm<WideMN>(
      Mat{h, hid, hid, t_len}, Mat{dl, ld_dl, cw, t_len}, blockIdx.x * BM,
      blockIdx.y, blockIdx.y + 1, t_len, reinterpret_cast<float*>(smem), epi);
}

// -- bf16, forward and backward: wgmma + TMA ------------------------------

namespace tc {

constexpr int CONSUMERS = 2;                  // consumer warpgroups
constexpr int TM = CONSUMERS * 64;            // output rows of a tile
constexpr int TN = 256;                       // output columns of a tile
constexpr int NB = TN / 128;                  // m64n128 products per k16
constexpr int KSTEP = 64;                     // k of one stage
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int STAGES = 4;
constexpr int BOX = 64 * KSTEP;               // elements of one 64 x 64 box
constexpr uint32_t BOX_BYTES = BOX * 2;
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

// the operand boxes hold 2-byte elements of either type (bf16 storage;
// only TMA writes them and only wgmma reads them)
struct Smem {
  bf16 a[STAGES][CONSUMERS][BOX];   // A: each consumer's 64 M x 64 K
  bf16 b[STAGES][TN / 64][BOX];     // B: TN N x 64 K in 64-wide blocks
  uint64_t full[STAGES], empty[STAGES];
};

// C[M, N] = A[M, K] . B[K, N] in TM x TN tiles, K in KSTEP stages
struct Product {
  int m_tiles, n_tiles, k_steps;
  int b_col;   // B's first column in its map (c0 where B is W)
};

// box `mn` (64 M or N indices), k step `k` of an operand: a K-major one
// holds M/N rows and k columns, an MN-major one k rows and M/N columns
template <bool MN>
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int mn, int k,
                                         int col0) {
  if (MN)
    ptwg::tma_load_2d(dst, map, bar, col0 + mn, k);
  else
    ptwg::tma_load_2d(dst, map, bar, col0 + k, mn);
}

template <bool MN>
__device__ __forceinline__ uint64_t slice_desc(const bf16* box, int kk) {
  return MN ? ptwg::desc_mnslice(box, kk, BOX_BYTES)
            : ptwg::desc_kslice(box, kk, BOX_BYTES);
}

// the first of the two accumulator rows this thread holds, for a
// warpgroup whose 64 rows start at m
__device__ __forceinline__ int acc_row(int m) {
  return m + 16 * ((threadIdx.x / 32) & 3) + (threadIdx.x & 31) / 4;
}

// The shared main loop. One CTA per SM walks tiles blockIdx.x,
// + gridDim.x, ..., M tile fastest (the CTAs running at one time share
// their B tiles); its producer warp keeps STAGES stages of TMA boxes in
// flight (across tile boundaries, so the next tile's loads overlap this
// one's epilogue) and each consumer warpgroup takes 64 rows of the tile
// through two m64n128k16 products per k16 slice, then hands its fp32
// accumulators, in registers, to `epi(first row, first column, acc)`.
// The operands' type is the epilogue's (Epilogue::Elem: bf16 or __half).
template <bool A_MN, bool B_MN, typename Epilogue>
__device__ __forceinline__ void gemm(const CUtensorMap* ta,
                                     const CUtensorMap* tb, const Product p,
                                     const Epilogue& epi) {
  using namespace ptwg;
  Smem& s = aligned_smem<Smem>();
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int tiles = p.m_tiles * p.n_tiles;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      bar_init(&s.full[i], 1);                // the producer's one arrival
      bar_init(&s.empty[i], CONSUMERS * 4);   // every consumer warp
    }
    bar_init_fence();
  }
  __syncthreads();
  int stage = 0;
  uint32_t phase = 0;
  if (wg == CONSUMERS) {   // producer warpgroup: its first warp loads
    regs_dealloc<PRODUCER_REGS>();
    if (warp != CONSUMERS * 4) return;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = t % p.m_tiles * TM, n0 = t / p.m_tiles * TN;
      for (int k = 0; k < p.k_steps; ++k) {
        bar_wait(&s.empty[stage], phase ^ 1);
        if (lane == 0) {
          bar_arrive_tx(&s.full[stage], (CONSUMERS + TN / 64) * BOX_BYTES);
          for (int j = 0; j < CONSUMERS; ++j)
            load_box<A_MN>(s.a[stage][j], ta, &s.full[stage], m0 + 64 * j,
                           k * KSTEP, 0);
          for (int j = 0; j < TN / 64; ++j)
            load_box<B_MN>(s.b[stage][j], tb, &s.full[stage], n0 + 64 * j,
                           k * KSTEP, p.b_col);
        }
        __syncwarp();
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {   // consumer warpgroup wg: rows 64 * wg .. of each tile
    regs_alloc<CONSUMER_REGS>();
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      float acc[NB][64];
      int prev = 0;
      for (int k = 0; k < p.k_steps; ++k) {
        bar_wait(&s.full[stage], phase);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KSTEP / 16; ++kk)
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            wgmma_ss<B_MN, A_MN, typename Epilogue::Elem>(
                acc[nb], slice_desc<A_MN>(s.a[stage][wg], kk),
                slice_desc<B_MN>(s.b[stage][2 * nb], kk), k > 0 || kk > 0);
        wgmma_commit();
        if (k > 0) {   // the previous stage's products are done with it
          wgmma_wait<1>();
          if (lane == 0) bar_arrive(&s.empty[prev]);
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) bar_arrive(&s.empty[prev]);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_regs(acc[nb]);
      epi(t % p.m_tiles * TM + 64 * wg, t / p.m_tiles * TN, acc);
    }
  }
}

// 2^x, flushing results below 2^-126 to 0: the forward's sum-exp has a
// term of 1 (the max), so what the flush drops is far below its ulp
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The forward's partials of one tile: per row, over the tile's 256
// columns, (max, sum of exp(x - max), gold logit) into part[0 / 1 / 2]
// [split = n0 / TN][row], all in registers. A row's columns lie on the four
// lanes of a quad (ptwg::acc_col), so each reduction is the thread's own
// 64 values, then two xor shuffles; lane 0 of the quad writes. Columns >=
// V (TMA zeros) take no part, as the reference's -1e30 would (a tile
// wholly inside the vocab skips the test); rows >= T are not written. The
// max is in the natural log (the combine takes expf(m_i - M) and logf),
// the sum 2^((x - max) * log2(e)).
template <typename T>
struct FwdEpilogue {
  using Elem = T;
  const int* labels;
  float* part;   // [3, splits, T]
  int t_len, vocab, splits;

  __device__ __forceinline__ void operator()(int m, int n0,
                                             const float (&acc)[NB][64]) const {
    const int lane = threadIdx.x & 31;
    const int cols = vocab - n0;   // this tile's columns inside the vocab
    const bool full = cols >= TN;
    int label[2];
    float mx[2], sum[2], gold[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = acc_row(m) + 8 * hi;
      label[hi] = row < t_len ? labels[row] - n0 : -1;
      mx[hi] = NEG_INF;
      sum[hi] = 0.f;
      gold[hi] = 0.f;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 64; ++i) {   // element i is row half (i >> 1) & 1
        const int hi = (i >> 1) & 1, c = 128 * nb + ptwg::acc_col(i, lane);
        if (full || c < cols) mx[hi] = fmaxf(mx[hi], acc[nb][i]);
        if (c == label[hi]) gold[hi] = acc[nb][i];
      }
    float ml[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(~0u, mx[hi], 1));
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(~0u, mx[hi], 2));
      ml[hi] = mx[hi] * LOG2E;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int hi = (i >> 1) & 1, c = 128 * nb + ptwg::acc_col(i, lane);
        if (full || c < cols) sum[hi] += ex2(fmaf(acc[nb][i], LOG2E, -ml[hi]));
      }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {   // the quad's sums, in a fixed order
      sum[hi] += __shfl_xor_sync(~0u, sum[hi], 1);
      sum[hi] += __shfl_xor_sync(~0u, sum[hi], 2);
      gold[hi] += __shfl_xor_sync(~0u, gold[hi], 1);   // one lane's is not 0
      gold[hi] += __shfl_xor_sync(~0u, gold[hi], 2);
    }
    if (lane & 3) return;
    const long long plane = static_cast<long long>(splits) * t_len;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = acc_row(m) + 8 * hi;
      if (row >= t_len) continue;
      const long long i = static_cast<long long>(n0 / TN) * t_len + row;
      part[i] = mx[hi];
      part[plane + i] = sum[hi];
      part[2 * plane + i] = gold[hi];
    }
  }
};

// dl = (exp(acc - lse) - [c == label]) * g, rounded to T, into the
// [T, ld] workspace; columns c >= cw (W's next chunk, or zeros past V)
// get nothing, rows past T neither.
template <typename T>
struct DlEpilogue {
  using Elem = T;
  const int* labels;
  const float* lse;
  const float* g;
  T* dl;
  int t_len, c0, cw, ld;

  __device__ __forceinline__ void operator()(int m, int n0,
                                             const float (&acc)[NB][64]) const {
    const int lane = threadIdx.x & 31;
    float x[2], gt[2];
    int label[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {   // both rows' loads first
      const int row = acc_row(m) + 8 * hi;
      const bool in = row < t_len;
      x[hi] = in ? lse[row] * LOG2E : 0.f;
      gt[hi] = in ? g[row] : 0.f;
      label[hi] = in ? labels[row] - c0 : -1;
    }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = acc_row(m) + 8 * hi;
      if (row >= t_len) continue;
      T* out = dl + static_cast<long long>(row) * ld;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 2 * hi; i < 64; i += 4) {
          const int c = n0 + 128 * nb + ptwg::acc_col(i, lane);
          if (c >= cw) continue;   // cw is even: c + 1 < cw too
          const float p0 = exp2f(fmaf(acc[nb][i], LOG2E, -x[hi]));
          const float p1 = exp2f(fmaf(acc[nb][i + 1], LOG2E, -x[hi]));
          ptwg::store2<T>(out + c,
                          (p0 - (c == label[hi] ? 1.f : 0.f)) * gt[hi],
                          (p1 - (c + 1 == label[hi] ? 1.f : 0.f)) * gt[hi]);
        }
    }
  }
};

// dh (+)= acc: the chunk's sum joins the fp32 [T, H] buffer (first: is
// it); at the last chunk the total goes to dh in T instead. The
// buffer's 16 pairs of a row half load before any is added, so their
// latencies overlap.
template <typename T>
struct DhEpilogue {
  using Elem = T;
  float* buf;
  T* dh;
  int t_len, hid, first, last;

  __device__ __forceinline__ void operator()(int m, int n0,
                                             const float (&acc)[NB][64]) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = acc_row(m) + 8 * hi;
      if (row >= t_len) continue;
      float* brow = buf + static_cast<long long>(row) * hid;
      T* drow = dh + static_cast<long long>(row) * hid;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        float2 old[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = n0 + 128 * nb + ptwg::acc_col(4 * j, lane);
          old[j] = first || col >= hid
                       ? make_float2(0.f, 0.f)
                       : *reinterpret_cast<const float2*>(brow + col);
        }
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int i = 4 * j + 2 * hi;
          const int col = n0 + 128 * nb + ptwg::acc_col(i, lane);
          if (col >= hid) continue;
          const float x = acc[nb][i] + old[j].x, y = acc[nb][i + 1] + old[j].y;
          if (last)
            ptwg::store2<T>(drow + col, x, y);
          else
            *reinterpret_cast<float2*>(brow + col) = make_float2(x, y);
        }
      }
    }
  }
};

// dW[j][c0 + c] = acc rounded to T, for j < H and c < cw
template <typename T>
struct DwEpilogue {
  using Elem = T;
  T* dw;
  int hid, vocab, c0, cw;

  __device__ __forceinline__ void operator()(int m, int n0,
                                             const float (&acc)[NB][64]) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = acc_row(m) + 8 * hi;
      if (row >= hid) continue;
      T* out = dw + static_cast<long long>(row) * vocab + c0;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 2 * hi; i < 64; i += 4) {
          const int c = n0 + 128 * nb + ptwg::acc_col(i, lane);
          if (c < cw) ptwg::store2<T>(out + c, acc[nb][i], acc[nb][i + 1]);
        }
    }
  }
};

// the forward's logits h . W over the whole vocab: A = h (K-major),
// B = W (MN-major)
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    fce_fwd_wgmma(const __grid_constant__ CUtensorMap th,
                  const __grid_constant__ CUtensorMap tw, const Product p,
                  const FwdEpilogue<T> e) {
  gemm<false, true>(&th, &tw, p, e);
}

// dl = h . W[:, chunk]: A = h (K-major), B = W (MN-major, from column c0)
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    fce_bwd_dl_wgmma(const __grid_constant__ CUtensorMap th,
                     const __grid_constant__ CUtensorMap tw, const Product p,
                     const DlEpilogue<T> e) {
  gemm<false, true>(&th, &tw, p, e);
}

// dh (+)= dl . W[:, chunk]^T: A = dl (K-major), B(k = v, n = j) =
// W[j][c0 + v] (K-major)
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    fce_bwd_dh_wgmma(const __grid_constant__ CUtensorMap tl,
                     const __grid_constant__ CUtensorMap tw, const Product p,
                     const DhEpilogue<T> e) {
  gemm<false, false>(&tl, &tw, p, e);
}

// dW[:, chunk] = h^T . dl: A(m = j, k = t) = h[t][j] and B(k = t, n = c)
// = dl[t][c], both MN-major
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    fce_bwd_dw_wgmma(const __grid_constant__ CUtensorMap th,
                     const __grid_constant__ CUtensorMap tl, const Product p,
                     const DwEpilogue<T> e) {
  gemm<true, true>(&th, &tl, p, e);
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// C[m, n] over k: one CTA per SM, or per tile where there are fewer. The
// kernel template's instance is the one whose epilogue is e's: the
// parameter below names its type, so the fce_fwd_wgmma template given a
// FwdEpilogue<T> launches as fce_fwd_wgmma<T>.
template <typename Epilogue>
cudaError_t launch(void (*kernel)(CUtensorMap, CUtensorMap, Product,
                                  Epilogue),
                   const CUtensorMap& ta, const CUtensorMap& tb, int m,
                   int n, int k, int b_col, const Epilogue& e,
                   cudaStream_t s) {
  const Product p{(m + TM - 1) / TM, (n + TN - 1) / TN,
                  (k + KSTEP - 1) / KSTEP, b_col};
  const int smem = static_cast<int>(sizeof(Smem)) + 1024;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = p.m_tiles * p.n_tiles, sms = sm_count();
  kernel<<<tiles < sms ? tiles : sms, THREADS, smem, s>>>(ta, tb, p, e);
  return cudaGetLastError();
}

// one product over the whole vocab, one split per TN-column tile (the
// wrapper passes splits = ceil(V / TN)), then the combine. T (bf16 by
// default, or __half) is h's and W's type, which the tensor maps name.
template <typename T = bf16>
cudaError_t launch_fwd(const void* h, const void* w, const int* labels,
                       float* loss, float* lse, float* part, int t_len,
                       int hid, int vocab, int splits, cudaStream_t s) {
  if (splits != (vocab + TN - 1) / TN) return cudaErrorInvalidValue;
  CUtensorMap th, tw;
  cudaError_t err;
  if ((err = ptwg::matrix_map(&th, h, t_len, hid, hid, 64,
                              ptwg::tma_type<T>)) != cudaSuccess ||
      (err = ptwg::matrix_map(&tw, w, hid, vocab, vocab, 64,
                              ptwg::tma_type<T>)) != cudaSuccess)
    return err;
  const FwdEpilogue<T> e{labels, part, t_len, vocab, splits};
  if ((err = launch(fce_fwd_wgmma, th, tw, t_len, vocab, hid, 0, e, s)) !=
      cudaSuccess)
    return err;
  return combine(part, loss, lse, t_len, splits, s);
}

template <typename T = bf16>
cudaError_t launch_dl(const void* h, const void* w, const int* labels,
                      const float* lse, const float* g, void* dl, int t_len,
                      int hid, int vocab, int c0, int cw, int ld_dl,
                      cudaStream_t s) {
  CUtensorMap th, tw;
  cudaError_t err;
  if ((err = ptwg::matrix_map(&th, h, t_len, hid, hid, 64,
                              ptwg::tma_type<T>)) != cudaSuccess ||
      (err = ptwg::matrix_map(&tw, w, hid, vocab, vocab, 64,
                              ptwg::tma_type<T>)) != cudaSuccess)
    return err;
  const DlEpilogue<T> e{labels, lse, g, static_cast<T*>(dl), t_len, c0, cw,
                        ld_dl};
  return launch(fce_bwd_dl_wgmma, th, tw, t_len, cw, hid, c0, e, s);
}

// the workspace's map stops at column cw: columns cw .. ld_dl - 1 still
// hold an earlier chunk's dl and must read as zeros
template <typename T = bf16>
cudaError_t launch_dh(const void* dl, const void* w, float* acc, void* dh,
                      int t_len, int hid, int vocab, int c0, int cw,
                      int ld_dl, int first, int last, cudaStream_t s) {
  CUtensorMap tl, tw;
  cudaError_t err;
  if ((err = ptwg::matrix_map(&tl, dl, t_len, cw, ld_dl, 64,
                              ptwg::tma_type<T>)) != cudaSuccess ||
      (err = ptwg::matrix_map(&tw, w, hid, vocab, vocab, 64,
                              ptwg::tma_type<T>)) != cudaSuccess)
    return err;
  const DhEpilogue<T> e{acc, static_cast<T*>(dh), t_len, hid, first, last};
  return launch(fce_bwd_dh_wgmma, tl, tw, t_len, hid, cw, c0, e, s);
}

template <typename T = bf16>
cudaError_t launch_dw(const void* h, const void* dl, void* dw, int t_len,
                      int hid, int vocab, int c0, int cw, int ld_dl,
                      cudaStream_t s) {
  CUtensorMap th, tl;
  cudaError_t err;
  if ((err = ptwg::matrix_map(&th, h, t_len, hid, hid, 64,
                              ptwg::tma_type<T>)) != cudaSuccess ||
      (err = ptwg::matrix_map(&tl, dl, t_len, cw, ld_dl, 64,
                              ptwg::tma_type<T>)) != cudaSuccess)
    return err;
  const DwEpilogue<T> e{static_cast<T*>(dw), hid, vocab, c0, cw};
  return launch(fce_bwd_dw_wgmma, th, tl, hid, cw, t_len, 0, e, s);
}

}  // namespace tc

template <typename Kernel>
cudaError_t allow_smem(Kernel k, int bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

dim3 grid_of(int rows, int cols) {
  return dim3((rows + BM - 1) / BM, (cols + BN - 1) / BN);
}

cudaError_t fwd(const void* h, const void* w, const int* labels, float* loss,
                float* lse, float* part, int t_len, int hid, int vocab,
                int splits, cudaStream_t s) {
  cudaError_t err = allow_smem(fce_fwd_partial, FWD_SMEM);
  if (err != cudaSuccess) return err;
  const int v_tiles = (vocab + BN - 1) / BN;
  const int per_split = (v_tiles + splits - 1) / splits;
  fce_fwd_partial<<<dim3((t_len + BM - 1) / BM, splits), Wide::THREADS,
                    FWD_SMEM, s>>>(static_cast<const float*>(h),
                                   static_cast<const float*>(w), labels, part,
                                   t_len, hid, vocab, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return combine(part, loss, lse, t_len, splits, s);
}

cudaError_t bwd_dl(const void* h, const void* w, const int* labels,
                   const float* lse, const float* g, void* dl, int t_len,
                   int hid, int vocab, int c0, int cw, int ld_dl,
                   cudaStream_t s) {
  fce_bwd_dl<<<grid_of(t_len, cw), Wide::THREADS, Wide::SMEM_BYTES, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(w), labels, lse,
      g, static_cast<float*>(dl), t_len, hid, vocab, c0, cw, ld_dl);
  return cudaGetLastError();
}

// 128-row tiles where their grid gives every SM a CTA, else 64-row ones
// (twice the CTAs): ptf32::query_tile_rows, the float32 flash kernels' rule
cudaError_t bwd_dh(const void* dl, const void* w, float* acc, void* dh,
                   int t_len, int hid, int vocab, int c0, int cw, int ld_dl,
                   int first, int last, cudaStream_t s) {
  int rows = BM;
  cudaError_t err = ptf32::query_tile_rows((hid + BN - 1) / BN, t_len, &rows);
  if (err != cudaSuccess) return err;
  const float* l = static_cast<const float*>(dl);
  const float* wf = static_cast<const float*>(w);
  float* d = static_cast<float*>(dh);
  if (rows == BM)
    fce_bwd_dh<<<grid_of(t_len, hid), WideT::THREADS, WideT::SMEM_BYTES, s>>>(
        l, wf, acc, d, t_len, hid, vocab, c0, cw, ld_dl, first, last);
  else
    fce_bwd_dh64<<<dim3((t_len + 63) / 64, (hid + BN - 1) / BN),
                   Narrow::THREADS, Narrow::SMEM_BYTES, s>>>(
        l, wf, acc, d, t_len, hid, vocab, c0, cw, ld_dl, first, last);
  return cudaGetLastError();
}

cudaError_t bwd_dw(const void* h, const void* dl, void* dw, int t_len,
                   int hid, int vocab, int c0, int cw, int ld_dl,
                   cudaStream_t s) {
  fce_bwd_dw<<<grid_of(hid, cw), WideMN::THREADS, WideMN::SMEM_BYTES, s>>>(
      static_cast<const float*>(h), static_cast<const float*>(dl),
      static_cast<float*>(dw), t_len, hid, vocab, c0, cw, ld_dl);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// h [T, H], w [H, V] contiguous, dtype 0 = float32, 1 = bfloat16, 3 =
// float16; labels [T] int32 in [0, V); loss, lse [T] float32; part [3,
// splits, T] float32 scratch, 1 <= splits <= ceil(V / 128) in float32 and
// splits = ceil(V / 256) in bfloat16 and float16. Two launches (partials,
// combine).
int pt_fused_ce_fwd(const void* h, const void* w, const void* labels,
                    void* loss, void* lse, void* part, int t_len, int hid,
                    int vocab, int splits, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  float* pa = static_cast<float*>(part);
  if (dtype == 0)
    return fwd(h, w, lab, lo, ls, pa, t_len, hid, vocab, splits, s);
  if (dtype == 1)
    return tc::launch_fwd(h, w, lab, lo, ls, pa, t_len, hid, vocab, splits,
                          s);
  if (dtype == 3)
    return tc::launch_fwd<__half>(h, w, lab, lo, ls, pa, t_len, hid, vocab,
                                  splits, s);
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
    return bwd_dl(h, w, lab, ls, gt, dl, t_len, hid, vocab, c0, cw, ld_dl,
                  s);
  if (dtype == 1)
    return tc::launch_dl(h, w, lab, ls, gt, dl, t_len, hid, vocab, c0, cw,
                         ld_dl, s);
  if (dtype == 3)
    return tc::launch_dl<__half>(h, w, lab, ls, gt, dl, t_len, hid, vocab,
                                 c0, cw, ld_dl, s);
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
    return bwd_dh(dl, w, a, dh, t_len, hid, vocab, c0, cw, ld_dl, first,
                  last, s);
  if (dtype == 1)
    return tc::launch_dh(dl, w, a, dh, t_len, hid, vocab, c0, cw, ld_dl,
                         first, last, s);
  if (dtype == 3)
    return tc::launch_dh<__half>(dl, w, a, dh, t_len, hid, vocab, c0, cw,
                                 ld_dl, first, last, s);
  return cudaErrorInvalidValue;
}

// dw [H, V] in W's dtype: columns c0 .. c0 + cw - 1 written
int pt_fused_ce_bwd_dw(const void* h, const void* dl, void* dw, int t_len,
                       int hid, int vocab, int c0, int cw, int ld_dl,
                       int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_dw(h, dl, dw, t_len, hid, vocab, c0, cw, ld_dl, s);
  if (dtype == 1)
    return tc::launch_dw(h, dl, dw, t_len, hid, vocab, c0, cw, ld_dl, s);
  if (dtype == 3)
    return tc::launch_dw<__half>(h, dl, dw, t_len, hid, vocab, c0, cw, ld_dl,
                                 s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
