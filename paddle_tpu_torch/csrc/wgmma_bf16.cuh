// bf16 warpgroup tensor-core building blocks for Hopper (sm_90a): wgmma,
// its shared-memory descriptors, mbarriers and TMA tile loads; the
// products, fragment packs and operand tensor maps also take fp16, for
// the float16 modes of the flash attention, fused lm_head + CE and
// int8-weight GEMM kernels (a template parameter or argument, bf16 by
// default, so every bf16 caller compiles as before). Header only: no
// entry points. Used by csrc/flash_attention.cu (the bf16
// forward), csrc/flash_attention_bwd.cu (the bf16 dq and dk/dv kernels),
// csrc/fused_ce.cu (the bf16 lm_head + CE forward and backward products)
// and csrc/mma_probe.cu, which checks every form the kernels use on its own
// (forms 4-7), where a wrong descriptor or fragment layout shows as a
// wrong value of one form.
//
// Shared-memory tiles. Every operand tile is what one TMA load with
// 128-byte swizzle writes: a box of 64 bf16 (128 bytes) by R rows,
// 1024-byte aligned, row r at r * 128 bytes with its eight 16-byte chunks
// permuted by chunk ^= r % 8. A wider operand is several boxes side by
// side (D = 128: two boxes of 64 columns). The descriptor's layout type 1
// (128-byte swizzle) makes wgmma undo the same permutation, which works
// only while the swizzle phase follows the address: tiles 1024-aligned,
// base offset 0.
//   * K-major (the contracted axis is the stored row): rows are M or N
//     indices, 8-row groups 1024 bytes apart (SBO); LBO is unused. A k16
//     slice starts 32 bytes further along the row: desc + 2 per slice,
//     the next box after four.
//   * MN-major (the stored row is the contracted axis): rows are K
//     indices, 8-row groups 1024 bytes apart (SBO), 64-wide M/N blocks
//     `block_bytes` apart (LBO). A k16 slice is 16 rows further: desc +
//     128 (2048 bytes) per slice (desc_mnslice). wgmma reads B MN-major
//     with its transpose bit set, and A MN-major with the transpose-A
//     bit (wgmma_ss<TRANS_B, 1>; A's 64-row M block is one box).
//
// Accumulators (m64nNk16, fp32): thread t of the warpgroup, warp w = t /
// 32, lane l: d[4j + 2h + e] holds row 16w + l/4 + 8h, column 8j + 2(l%4)
// + e. The A fragment from registers (wgmma ...rs) for k16 slice s is
// the m16n8k16 A layout per warp: {d[8s], d[8s+1]}, {d[8s+2], d[8s+3]},
// {d[8s+4], d[8s+5]}, {d[8s+6], d[8s+7]} of an accumulator whose columns
// are the next product's contracted axis, each pair packed to bf16x2
// (acc_to_frag): a product's result feeds the next without leaving
// registers, rounded to bf16 where the pack rounds it.
//
// TMA: the host encodes a rank-4 tensor map (head_dim, heads, rows,
// batch) over the caller's strides (tile_map): a box is 64 columns x R
// rows of one (batch, head); rows past the operand's length read as zeros
// and never reach the next batch row. A plain matrix takes a rank-2 map
// (matrix_map, tma_load_2d) whose extent can stop short of its row
// stride: the columns past it read as zeros. cuTensorMapEncodeTiled is a
// driver function; the build links no libcuda, so the runtime hands its
// address over (cudaGetDriverEntryPoint[ByVersion]). The global address
// and every stride but the innermost must be multiples of 16 bytes (the
// Python wrappers copy an operand that is not; a stride of a length-1
// axis is replaced here, since it is never used).
#pragma once

#include <cuda.h>   // CUtensorMap and the driver's enums (types only)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ptwg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- descriptors --------------------------------------------------------

__device__ __forceinline__ uint64_t desc_field(uint32_t bytes) {
  return static_cast<uint64_t>((bytes & 0x3FFFF) >> 4);
}

// K-major tile at `tile` (1024-aligned box), 128-byte swizzle
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile) {
  return desc_field(smem_u32(tile)) | desc_field(16) << 16 |
         desc_field(1024) << 32 | uint64_t(1) << 62;
}

// MN-major tile: 64-wide M/N blocks `block_bytes` apart
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile,
                                                 uint32_t block_bytes) {
  return desc_field(smem_u32(tile)) | desc_field(block_bytes) << 16 |
         desc_field(1024) << 32 | uint64_t(1) << 62;
}

// the descriptor of k16 slice `s` of a K-major operand stored as boxes of
// 64 columns, `box_bytes` apart
__device__ __forceinline__ uint64_t desc_kslice(const void* tile, int s,
                                                uint32_t box_bytes) {
  return desc_kmajor(static_cast<const char*>(tile) + (s >> 2) * box_bytes) +
         2 * (s & 3);
}

// the descriptor of k16 slice `s` of an MN-major operand, 16 stored rows
// further per slice: B (wgmma's TRANS_B = 1) or A (TRANS_A = 1)
__device__ __forceinline__ uint64_t desc_mnslice(const void* tile, int s,
                                                 uint32_t block_bytes) {
  return desc_mnmajor(tile, block_bytes) + 128 * s;
}

// -- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The operand types of the products: bf16 (every kernel) and fp16 (the
// kernels' float16 modes), both summed in fp32. Each
// product below takes the type as a template parameter, bf16 by default,
// and names its full instruction; the macros carry the operands. The asm
// text of the two types differs only in the type names, so a bf16
// instantiation is the one the kernels had before fp16 was added.
template <typename T>
constexpr bool is_f16 = std::is_same<T, __half>::value;

// the accumulators of an m64n64 (32 registers) or m64n128 (64) product
#define PTWG_ACC32 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define PTWG_ACC64 \
  PTWG_ACC32, \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define PTWG_DST32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7," \
  " %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23," \
  " %24, %25, %26, %27, %28, %29, %30, %31}"
#define PTWG_DST64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7," \
  " %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23," \
  " %24, %25, %26, %27, %28, %29, %30, %31," \
  " %32, %33, %34, %35, %36, %37, %38, %39," \
  " %40, %41, %42, %43, %44, %45, %46, %47," \
  " %48, %49, %50, %51, %52, %53, %54, %55," \
  " %56, %57, %58, %59, %60, %61, %62, %63}"

// the accumulators of an m64n256 product (128 registers): the head-dim-256
// kernels' output rows
#define PTWG_ACC128 \
  PTWG_ACC64, \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
  "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
  "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
  "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
  "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
  "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
  "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
  "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
  "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
#define PTWG_DST128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7," \
  " %8, %9, %10, %11, %12, %13, %14, %15," \
  " %16, %17, %18, %19, %20, %21, %22, %23," \
  " %24, %25, %26, %27, %28, %29, %30, %31," \
  " %32, %33, %34, %35, %36, %37, %38, %39," \
  " %40, %41, %42, %43, %44, %45, %46, %47," \
  " %48, %49, %50, %51, %52, %53, %54, %55," \
  " %56, %57, %58, %59, %60, %61, %62, %63," \
  " %64, %65, %66, %67, %68, %69, %70, %71," \
  " %72, %73, %74, %75, %76, %77, %78, %79," \
  " %80, %81, %82, %83, %84, %85, %86, %87," \
  " %88, %89, %90, %91, %92, %93, %94, %95," \
  " %96, %97, %98, %99, %100, %101, %102, %103," \
  " %104, %105, %106, %107, %108, %109, %110, %111," \
  " %112, %113, %114, %115, %116, %117, %118, %119," \
  " %120, %121, %122, %123, %124, %125, %126, %127}"

// d = A . B (accumulate = 0) or d += A . B, one k16 slice. TRANS_B = 0:
// B K-major; 1: B MN-major. TRANS_A likewise for A (default K-major).
#define PTWG_SS_N64(INSTR)                                                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" INSTR " "     \
               PTWG_DST32 ", %32, %33, p, 1, 1, %36, %35;\n}\n"         \
               : PTWG_ACC32                                               \
               : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B), \
                 "n"(TRANS_A))
#define PTWG_RS_N64(INSTR)                                                \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" INSTR " "     \
               PTWG_DST32 ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n" \
               : PTWG_ACC32                                               \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), \
                 "r"(accumulate), "n"(TRANS_B))
#define PTWG_SS_N128(INSTR)                                               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" INSTR " "     \
               PTWG_DST64 ", %64, %65, p, 1, 1, %68, %67;\n}\n"         \
               : PTWG_ACC64                                               \
               : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B), \
                 "n"(TRANS_A))
#define PTWG_RS_N128(INSTR)                                               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" INSTR " "     \
               PTWG_DST64 ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n" \
               : PTWG_ACC64                                               \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), \
                 "r"(accumulate), "n"(TRANS_B))

#define PTWG_RS_N256(INSTR)                                               \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" INSTR " "    \
               PTWG_DST128 ", {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n" \
               : PTWG_ACC128                                              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), \
                 "r"(accumulate), "n"(TRANS_B))
template <int TRANS_B, int TRANS_A = 0, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  if constexpr (is_f16<T>)
    PTWG_SS_N64("wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16");
  else
    PTWG_SS_N64("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16");
}

template <int TRANS_B, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  if constexpr (is_f16<T>)
    PTWG_RS_N64("wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16");
  else
    PTWG_RS_N64("wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16");
}

template <int TRANS_B, int TRANS_A = 0, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  if constexpr (is_f16<T>)
    PTWG_SS_N128("wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16");
  else
    PTWG_SS_N128("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16");
}

template <int TRANS_B, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  if constexpr (is_f16<T>)
    PTWG_RS_N128("wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16");
  else
    PTWG_RS_N128("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16");
}

template <int TRANS_B, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  if constexpr (is_f16<T>)
    PTWG_RS_N256("wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16");
  else
    PTWG_RS_N256("wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16");
}

#undef PTWG_SS_N64
#undef PTWG_RS_N64
#undef PTWG_SS_N128
#undef PTWG_RS_N128
#undef PTWG_RS_N256
#undef PTWG_ACC128
#undef PTWG_DST128
#undef PTWG_ACC32
#undef PTWG_ACC64
#undef PTWG_DST32
#undef PTWG_DST64

// the column of accumulator element i of this thread within the
// warpgroup's tile (its row is the thread's 16 * (warp % 4) + lane / 4,
// plus 8 when bit 1 of i is set)
__device__ __forceinline__ int acc_col(int i, int lane) {
  return (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two floats rounded to T (bf16 or fp16; fp16 overflows to inf past
// 65504, which no kernel clamps), the first in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (is_f16<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_bf16x2(lo, hi);
  }
}

// two floats rounded to T, stored at p (4-byte aligned)
template <typename T>
__device__ __forceinline__ void store2(T* p, float lo, float hi) {
  if constexpr (is_f16<T>)
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(lo, hi);
  else
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// the A fragments of every k16 slice of an accumulator of N columns,
// rounded to T
template <typename T = __nv_bfloat16, int R>
__device__ __forceinline__ void acc_to_frag(uint32_t (&a)[R / 8][4],
                                            const float (&d)[R]) {
#pragma unroll
  for (int s = 0; s < R / 8; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[s][j] = pack2<T>(d[8 * s + 2 * j], d[8 * s + 2 * j + 1]);
}

// the kernel's dynamic shared memory as an S, 1024-aligned for the
// swizzled tiles (the launch asks for sizeof(S) + 1024 bytes)
template <typename S>
__device__ __forceinline__ S& aligned_smem() {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  return *reinterpret_cast<S*>(smem_raw + pad);
}

// -- warpgroup registers ------------------------------------------------

template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// -- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}
// after every bar_init, before any other thread uses the barriers
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
// one arrival that also announces `bytes` of TMA traffic for this phase
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// -- TMA ------------------------------------------------------------------

// box (c0 column, c1 head, c2 row, c3 batch) of `map` into `dst`,
// completing `bytes` on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// box (c0 column, c1 row) of a rank-2 `map` (matrix_map) into `dst`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the tensor map's element type of an operand of type T
template <typename T>
constexpr CUtensorMapDataType tma_type =
    is_f16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// A 2-byte operand [batch, rows, heads, cols] (bf16, or `type`) with
// element strides sb, sr, sh for its first three axes (the last
// contiguous), read in boxes of 64 columns x box_rows rows of one (batch,
// head), 128-byte swizzle, rows past `rows` zero-filled.
inline cudaError_t tile_map(
    CUtensorMap* map, const void* base, int cols, int heads, int rows,
    int batch, long long sh, long long sr, long long sb, int box_rows,
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  // bytes; a length-1 axis takes the stride that follows the one before
  const cuuint64_t s_h = heads == 1 ? cuuint64_t(cols) * 2 : sh * 2;
  const cuuint64_t s_r = rows == 1 ? s_h * heads : sr * 2;
  const cuuint64_t s_b = batch == 1 ? s_r * rows : sb * 2;
  const cuuint64_t dims[4] = {cuuint64_t(cols), cuuint64_t(heads),
                              cuuint64_t(rows), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {s_h, s_r, s_b};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, type, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 2-byte matrix [rows, cols] (bf16, or `type`) with `ld` elements
// between rows (the columns contiguous), read in boxes of 64 columns x
// box_rows rows, 128-byte swizzle; columns past `cols` and rows past `rows`
// read as zeros, so a map over the first `cols` columns of a wider buffer
// never shows the rest. base and ld * 2 must be multiples of 16 bytes.
inline cudaError_t matrix_map(
    CUtensorMap* map, const void* base, int rows, int cols, long long ld,
    int box_rows, CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(ld) * 2};
  const cuuint32_t box[2] = {64, cuuint32_t(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, type, 2, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace ptwg
