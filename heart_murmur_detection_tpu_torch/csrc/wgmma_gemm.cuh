// Hopper building blocks of the wgmma kernels (swin_wgrad.cu, vit_proj.cu,
// vit_attn.cu, vit_qkv.cu, vit_attn_bwd.cu, swin_attn.cu, swin_mlp.cu), and
// the GEMM core that swin_wgrad and vit_proj share.
//
//  - mbarriers: init, arrive, arrive with an expected transaction count, and
//    a parity wait.
//  - TMA: 2D / 3D tile loads from a CUtensorMap into shared memory that
//    complete on an mbarrier, and 3D tile stores from shared memory in bulk
//    async groups. The maps are encoded on the host with the
//    driver's cuTensorMapEncodeTiled, taken through cudaGetDriverEntryPoint
//    (the library links no libcuda). Every map here reads bf16 boxes of 64
//    columns (128 bytes) with the 128-byte swizzle; rows past the tensor's
//    edge read as zeros.
//  - wgmma: shared-memory matrix descriptors for that swizzle, and
//    m64nNk16 bf16 products with float32 accumulation, both operands from
//    shared memory (K-major or MN-major; N = 48, 64, 96, 128) or A from
//    registers (N = 32, 64, 96).
//  - cluster barriers split into arrive and wait, and distributed shared
//    memory addresses (swin_attn.cu's head outputs, swin_mlp.cu's partial
//    sums).
//  - gemm_core: the 128 MT x 128 float32 tile of a product over a run of
//    K, fed through a ring of slices of K = 64 by TMA. A block is two
//    consumer warpgroups (rows 0 .. 64 MT - 1 and 64 MT .. of the tile) and
//    one producer warp, whose lane 0 keeps the ring full. A and B are row-major
//    bf16 in device memory, each in either major:
//      MN-major  A (K, M), B (K, N): K runs down the rows (swin_wgrad: two
//                token-row operands, K = tokens; wgmma reads both
//                transposed, so nothing is transposed in memory)
//      K-major   A (M, K), B (N, K): K runs along the rows (vit_proj: o_pre
//                and the torch (out, in) weight)
//    and mixed, A K-major with B MN-major (vit_attn_bwd.cu: token rows
//    times a torch (out, in) weight read as (K, N), do = dh1 W_proj and
//    dh = dqkv W_qkv).
//    A stage holds 64 x 64 boxes (8 KB each): A's 2 MT boxes of rows /
//    columns 0-63, 64-127, ..., then B's two.
//  - acc_pairs: the epilogue hook, which hands each (row, column pair) of a
//    warpgroup's accumulator to the caller's store (a float32 row store, a
//    head-major bf16 scatter with or without a bias, a residual sum).
//
// The wgmma accumulator of m64nN (N / 2 floats a thread): thread
// lane = 4 g + t of warp w of the warpgroup holds, for each 8-column block j,
// d[4 j], d[4 j + 1] at row 16 w + g, columns 8 j + 2 t, + 1, and
// d[4 j + 2], d[4 j + 3] at row 16 w + g + 8: the m16n8k16 layout repeated
// over N, so two neighbouring column blocks, rounded to bf16 pairs, are the
// register A operand of the next product.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace hmdt {

using bf16 = __nv_bfloat16;  // as in swin_common.cuh

namespace hop {

constexpr int CONSUMERS = 256;           // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int PRODUCER = CONSUMERS;      // the thread that issues every TMA load
constexpr int BOX = 64;                  // rows and columns of a TMA box
constexpr int BOX_BYTES = BOX * BOX * 2; // 8 KB: 64 rows of 128 swizzled bytes
constexpr uint32_t ATOM = 1024;          // 8 rows of 128 bytes: one swizzle atom

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary at or after p (the 128-byte swizzle repeats
// every 1024 bytes, and the descriptors assume tiles start on one).
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// `count` arrivals of this thread at once.
__device__ __forceinline__ void mbar_arrive_cnt(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// One arrival that also tells the barrier to wait for `bytes` of TMA data.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

constexpr long long WAIT_LIMIT = 1ll << 35;  // clocks (~20 s): a barrier that never completes

// Wait until the phase of parity `parity` has completed. A wait past
// WAIT_LIMIT traps (the launch then fails with an error) instead of hanging
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > WAIT_LIMIT) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The reverse: a box of a 3D tensor from shared memory (in the map's
// swizzled layout) to device memory, as a bulk async group of the issuing
// thread; elements past the tensor's edge are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Wait until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// A wgmma descriptor of a 128-byte-swizzled operand at p: `lbo` and `sbo`
// in bytes. K-major: sbo = the stride of 8-row groups along M / N (1024),
// lbo unused; a k16 step adds 32 bytes to p. MN-major: sbo = the stride of
// 8-row groups along K (1024), lbo = the stride of 64-wide swizzle atoms
// along M / N; a k16 step adds 16 rows (2048 bytes).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin the accumulator registers at this point of the program: the compiler
// may not move their reads or writes across an asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keep register A operands live up to this point of the program: a product
// issued earlier may still read them, and the compiler, which does not see
// the asynchronous read, could otherwise give their registers to other
// values once their last use in the program has passed.
template <int N>
__device__ __forceinline__ void keep_regs(const uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" ::"r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3]) : "memory");
}

// D += A B, m64n128k16, A and B from shared memory (descriptors);
// TA / TB: 1 where the operand is MN-major (transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D += A B, m64n64k16, A and B from shared memory (descriptors);
// TA / TB: 1 where the operand is MN-major (transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D = A B (D not read), m64n64k16, A and B from shared memory (descriptors);
// TA / TB: 1 where the operand is MN-major (transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64_ss_first(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0), "n"(TA), "n"(TB));
}

// D += A B, m64n64k16, A from registers (the m16n8k16 A fragment of each
// warp's 16 rows), B from shared memory; TB: 1 where B is MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// D += A B, m64n96k16, A and B from shared memory (descriptors);
// TA / TB: 1 where the operand is MN-major (transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n96_ss(float (&d)[48], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, "
      "%48, %49, p, 1, 1, %51, %52;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D += A B, m64n48k16, A and B from shared memory (descriptors);
// TA / TB: 1 where the operand is MN-major (transposed).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n48_ss(float (&d)[24], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, "
      "%24, %25, p, 1, 1, %27, %28;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D += A B, m64n32k16, A from registers (the m16n8k16 A fragment of each
// warp's 16 rows), B from shared memory; TB: 1 where B is MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_m64n32_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

// D += A B, m64n96k16, A from registers (the m16n8k16 A fragment of each
// warp's 16 rows), B from shared memory; TB: 1 where B is MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_m64n96_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}


// ---------------------------------------------------------------------------
// the GEMM core
// ---------------------------------------------------------------------------

constexpr int GEMM_COLS = 128;  // output columns a block
constexpr int GEMM_BK = 64;     // K a stage

// A block's tile is 128 MT rows: each consumer warpgroup runs MT m64n128k16
// products a k16 step over its 64 MT rows. MT = 2 halves the bytes a
// product reads from L2 per output (B is shared by twice the rows), at one
// block an SM (four 48 KB stages); MT = 1 fits two blocks an SM (three
// 32 KB stages).
template <int MT>
struct GemmCfg {
  static constexpr int ROWS = 128 * MT;
  static constexpr int A_BOXES = 2 * MT;
  static constexpr int STAGE_BYTES = (A_BOXES + 2) * BOX_BYTES;
  static constexpr int STAGES = MT == 1 ? 3 : 4;
};

template <int MT>
struct GemmSmem {
  uint8_t ring[GemmCfg<MT>::STAGES][GemmCfg<MT>::STAGE_BYTES];
  uint64_t full[GemmCfg<MT>::STAGES];
  uint64_t empty[GemmCfg<MT>::STAGES];
  int flag;
};

template <int MT>
constexpr size_t gemm_smem_bytes() {
  return sizeof(GemmSmem<MT>) + 1024;  // with the alignment slack
}

template <int MT>
__device__ __forceinline__ GemmSmem<MT>& gemm_smem(uint8_t* raw) {
  return *reinterpret_cast<GemmSmem<MT>*>(align_1024(raw));
}

// One thread sets up the ring's barriers; the whole block must sync after.
template <int MT>
__device__ __forceinline__ void gemm_init(GemmSmem<MT>& sm) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < GemmCfg<MT>::STAGES; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], CONSUMERS);
    }
    mbar_fence_init();
  }
}

// acc = the (m0, n0) 128 MT x 128 tile of A B over K = k_beg .. k_beg + 64
// k_steps, A MN-major if MNA (else K-major), B likewise by MNB. Every thread
// of the block calls it; the consumer threads return with their
// accumulators (acc[i] the layout at the top of this file for rows
// 64 (MT w + i) .. of the tile, w = threadIdx.x / 128), the producer warp
// once it has issued every load (its acc is untouched). Nothing of the ring
// is read or written after the consumers return.
template <bool MNA, bool MNB, int MT>
__device__ __forceinline__ void gemm_core(GemmSmem<MT>& sm, const CUtensorMap* ta,
                                          const CUtensorMap* tb, int m0, int n0, int k_beg,
                                          int k_steps, float (&acc)[MT][64]) {
  using Cfg = GemmCfg<MT>;
  const int tid = threadIdx.x;
  if (tid >= CONSUMERS) {
    if (tid == PRODUCER) {
      for (int it = 0; it < k_steps; ++it) {
        const int st = it % Cfg::STAGES;
        mbar_wait(&sm.empty[st], ((it / Cfg::STAGES) & 1) ^ 1);
        mbar_expect_tx(&sm.full[st], Cfg::STAGE_BYTES);
        const int k0 = k_beg + it * GEMM_BK;
        uint8_t* s = sm.ring[st];
#pragma unroll
        for (int j = 0; j < Cfg::A_BOXES; ++j) {
          if (MNA) tma_load_2d(s + j * BOX_BYTES, ta, &sm.full[st], m0 + BOX * j, k0);
          else tma_load_2d(s + j * BOX_BYTES, ta, &sm.full[st], k0, m0 + BOX * j);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint8_t* d = s + (Cfg::A_BOXES + j) * BOX_BYTES;
          if (MNB) tma_load_2d(d, tb, &sm.full[st], n0 + BOX * j, k0);
          else tma_load_2d(d, tb, &sm.full[st], k0, n0 + BOX * j);
        }
      }
    }
    return;
  }
  const int wg = tid / 128;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[i][e] = 0.f;
  for (int it = 0; it < k_steps; ++it) {
    const int st = it % Cfg::STAGES;
    mbar_wait(&sm.full[st], (it / Cfg::STAGES) & 1);
    const uint8_t* s = sm.ring[st];
    const uint8_t* sb = s + Cfg::A_BOXES * BOX_BYTES;
    wg_fence();
#pragma unroll
    for (int i = 0; i < MT; ++i) fence_regs(acc[i]);
#pragma unroll
    for (int kk = 0; kk < GEMM_BK / 16; ++kk) {
      // B: 128 columns (MN-major: two atoms) or rows (K-major)
      const uint64_t db = MNB ? desc_sw128(sb + kk * 2048, BOX_BYTES, ATOM)
                              : desc_sw128(sb + kk * 32, 16, ATOM);
#pragma unroll
      for (int i = 0; i < MT; ++i) {  // A: this warpgroup's i-th 64 columns / rows
        const uint8_t* sa = s + (wg * MT + i) * BOX_BYTES;
        const uint64_t da = MNA ? desc_sw128(sa + kk * 2048, BOX_BYTES, ATOM)
                                : desc_sw128(sa + kk * 32, 16, ATOM);
        wgmma_m64n128_ss<MNA ? 1 : 0, MNB ? 1 : 0>(acc[i], da, db);
      }
    }
    wg_commit();
    // keep this stage's products in flight; the previous stage's are done
    wg_wait<1>();
#pragma unroll
    for (int i = 0; i < MT; ++i) fence_regs(acc[i]);
    if (it > 0) mbar_arrive(&sm.empty[(it - 1) % Cfg::STAGES]);
  }
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < MT; ++i) fence_regs(acc[i]);
}

// The epilogue hook: f(row, col, v0, v1) for each pair of neighbouring
// columns (col, col + 1) that this consumer thread holds of an m64n128
// accumulator whose 64 x 128 tile starts at (r0, c0): the layout at the top
// of this file. The caller's store clips rows and columns at its edges.
template <typename F>
__device__ __forceinline__ void acc_pairs(const float (&acc)[64], int r0, int c0, F&& f) {
  const int lane = threadIdx.x & 31;
  const int r = r0 + ((threadIdx.x / 32) & 3) * 16 + (lane >> 2);
  const int c = c0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) f(r + 8 * h, c + 8 * j, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
}

// Make this thread's ordinary shared-memory stores visible to the async
// proxy (wgmma operands, TMA), before the barrier that publishes them.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A barrier of the `count` threads (a multiple of 32) that name barrier `id`
// (1-15; 0 is __syncthreads): the consumer warpgroups meet without the
// producer warp.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// The two halves of a cluster barrier, which every thread of every block of
// the cluster passes: arrive (release: this thread's shared-memory writes
// become visible to the cluster) and wait (acquire). Not .aligned, so the
// threads of a warp may arrive at different points of their programs.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The address in block `rank`'s shared memory of the variable at p in this
// block's (a generic address, read with ordinary loads).
template <typename T>
__device__ __forceinline__ const T* cluster_map(const T* p, int rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const T*>(out);
}

// ---------------------------------------------------------------------------
// host side: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// A bf16 tensor of `rank` (2 or 3) dims, innermost first (dims[0] elements
// contiguous, the rest row strides of the dense layout), read in boxes of
// box[] elements with the 128-byte swizzle (box[0] = 64). Returns a
// cudaError_t value (0 on success).
static inline int make_tensor_map(CUtensorMap* map, const void* ptr, int rank,
                                  const uint64_t* dims, const uint32_t* box) {
  EncodeTiledFn enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  cuuint64_t gd[3], gs[2];
  cuuint32_t bx[3], es[3] = {1, 1, 1};
  uint64_t stride = 2;
  for (int i = 0; i < rank; ++i) {
    gd[i] = dims[i];
    bx[i] = box[i];
    if (i > 0) gs[i - 1] = stride;
    stride *= dims[i];
  }
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                         const_cast<void*>(ptr), gd, gs, bx, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace hop
}  // namespace hmdt
