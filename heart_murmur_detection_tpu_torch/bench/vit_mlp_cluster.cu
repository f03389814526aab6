// vit_mlp_cluster: HeAR's ViT-L (C = 1024, hidden 4096) MLP half in one
// launch, fc1 computed once a token and passed between the blocks of a
// thread-block cluster through distributed shared memory:
//
//   y = x + (fc2(GELU(fc1(LN2(x)) + b1)) + b2),  x (n_tokens, 1024) bf16.
//
// A panel of 64 token rows is one cluster of four blocks; block (rank) r
// owns the output columns [256 r, 256 r + 256).
//  - x: each rank loads a quarter of the panel's 64-column boxes by TMA
//    multicast to all four, so every rank holds the whole panel (128 KB),
//    then computes LN2 in place (float32 statistics, one rounding).
//  - the hidden dimension runs in chunks of 128, two at a time: warpgroup w
//    of rank r computes fc1 of chunk 2 j + w over the rank's 32 columns of
//    it ([128 c + 32 r, + 32), m64n32 over K = 1024), + b1, the exact GELU
//    in float32, one rounding to bf16 (the plain version's rounding point),
//    into its own slice of the chunk's GELU tile, then copies the 4 KB slice
//    into the same place of the three other ranks' tiles
//    (cp.async.bulk shared::cluster, completing on their mbarriers).
//  - every rank then runs fc2 over both chunks (all 128 hidden columns of
//    each, from its own shared memory) for its 256 output columns, one
//    m64n128 float32 accumulator a warpgroup (64 floats a thread, 80 with
//    fc1's), summed over the chunks in order.
//  - the GELU tiles are double-buffered (one a chunk of the pair): before
//    writing pair j's slices a warpgroup waits until every rank has finished
//    pair j - 1's fc2 (a cluster mbarrier of eight remote arrivals).
//  - W1 and W2 stream through a ring of four 16 KB stages, in the order the
//    consumers take them: a W1 stage holds two 64-column K boxes of both
//    chunks' slices (each warpgroup reads its chunk's half), a W2 stage one
//    warpgroup's 128 output rows by 64 hidden columns.
//  - the epilogue: + b2, + x, one rounding, four columns a thread.
// The GELU tile is K-major with the 64-byte swizzle, so a rank's 32-column
// slice is one contiguous 4 KB box (the bulk copies need contiguous bytes).
// No split of a sum across blocks: two launches agree bitwise.
//
// Not in the port's library: bench/mlp_layouts.py builds this file with
// nvcc (-I csrc) and times it in turns with csrc/vit_rows.cu's route, which
// it loses to at every batch (PERF.md §6). Built with
// -DHMDT_CL_EXCHANGE=0 it skips every wait, arrival and copy of the
// exchange (its output is then wrong): the difference of the two times is
// what the cluster synchronisation costs.
#include "swin_common.cuh"
#include "vit_attn_common.cuh"
#include "wgmma_gemm.cuh"

#ifndef HMDT_CL_EXCHANGE
#define HMDT_CL_EXCHANGE 1
#endif

namespace hmdt {

using namespace hop;

constexpr bool CL_EXCHANGE = HMDT_CL_EXCHANGE;  // 0: a timing probe, see above
constexpr int CL_WIDTH = 1024;                  // C
constexpr int CL_RANKS = 4;                     // blocks of a cluster (a panel)
constexpr int CL_PR = 64;                       // panel rows
constexpr int CL_HN = 128;                      // hidden chunk
constexpr int CL_SL = CL_HN / CL_RANKS;         // a rank's fc1 columns of a chunk
constexpr int CL_NB = CL_WIDTH / CL_RANKS;      // a rank's output columns
constexpr int CL_KB = CL_WIDTH / 64;            // 64-column boxes of the panel
constexpr int CL_STAGE = 16384;                 // bytes a ring stage
constexpr int CL_STAGES = 4;
constexpr int CL_SLICE = CL_PR * CL_SL * 2;     // 4 KB: a rank's GELU slice
constexpr int CL_GTILE = CL_RANKS * CL_SLICE;   // 16 KB: a chunk's GELU tile
constexpr int CL_PANEL = CL_KB * CL_PR * 128;   // 128 KB
constexpr int CL_LDP = CL_NB + 8;               // float32 row of the parked sums
constexpr int CL_RING_OFF = CL_PANEL + 2 * CL_GTILE;
constexpr int CL_BAR_OFF = CL_RING_OFF + CL_STAGES * CL_STAGE;
constexpr int CL_NBARS = 1 + 2 * CL_STAGES + 4;  // x, ring full / empty, tiles full / free
constexpr size_t cl_smem_bytes() { return (size_t)CL_BAR_OFF + 8 * CL_NBARS + 1024; }
static_assert(CL_PR * CL_LDP * 4 <= CL_PANEL, "the parked sums alias the panel");

// A descriptor of a K-major operand with the 64-byte swizzle (rows of 64
// bytes, 8-row groups 512 bytes apart); a k16 step adds 32 bytes to p.
__device__ __forceinline__ uint64_t desc_sw64(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFFu) >> 4) | (1ull << 16) | ((uint64_t)(512 >> 4) << 32) |
         (2ull << 62);
}

__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// One arrival on the mbarrier at bar's offset in block `rank`'s shared memory.
__device__ __forceinline__ void mbar_arrive_rank(uint64_t* bar, int rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                   cluster_addr(bar, rank))
               : "memory");
}

// A parity wait that acquires at cluster scope (arrivals and copies of
// other blocks).
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > WAIT_LIMIT) __trap();
  }
}

// bytes from this block's src to the same offset as dst in block `rank`,
// completing on that block's mbarrier at bar's offset.
__device__ __forceinline__ void bulk_copy_rank(void* dst, const void* src, uint32_t bytes,
                                               uint64_t* bar, int rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(cluster_addr(dst, rank)),
      "r"(smem_u32(src)), "r"(bytes), "r"(cluster_addr(bar, rank))
      : "memory");
}

// A 2D TMA box into the same offset of every block of the cluster in mask,
// completing on each one's mbarrier at bar's offset.
__device__ __forceinline__ void tma_load_2d_mc(void* dst, const CUtensorMap* map, uint64_t* bar,
                                               int c0, int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::"
      "cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// grid: blockIdx.x = panel * 4 + rank, clusters of 4. tx: x in boxes of
// 64 x 64; tw1: W1 (hidden, C) in boxes of 64 x 32; tw2: W2 (C, hidden) in
// boxes of 64 x 128.
__global__ void __launch_bounds__(THREADS, 1)
vit_mlp_cluster_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw1,
                       const __grid_constant__ CUtensorMap tw2, const bf16* __restrict__ x,
                       bf16* __restrict__ out, const float* __restrict__ ln_w,
                       const float* __restrict__ ln_b, const float* __restrict__ b1,
                       const float* __restrict__ b2, int n_tokens, int hidden, float eps) {
  constexpr int PR = CL_PR, KB = CL_KB, S = CL_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  uint8_t* panel = base;
  uint8_t* gtile = base + CL_PANEL;
  uint8_t* ring = base + CL_RING_OFF;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + CL_BAR_OFF);
  uint64_t* xbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + S;
  uint64_t* gfull = bars + 1 + 2 * S;  // [2]: a chunk's tile holds all four slices
  uint64_t* gfree = gfull + 2;         // [2]: every rank is done reading the tile
  float* part = reinterpret_cast<float*>(base);
  const int tid = threadIdx.x;
  const int rank = (int)(blockIdx.x % CL_RANKS);
  const int p0 = (int)(blockIdx.x / CL_RANKS) * PR;
  const int col0 = rank * CL_NB;
  const int pairs = hidden / (2 * CL_HN);
  if (tid == 0) {
    mbar_init(xbar, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&gfull[b], 1);                  // the writing warpgroup's leader, + 3 copies
      mbar_init(&gfree[b], 2 * CL_RANKS);       // both warpgroups of every rank
    }
    mbar_fence_init();
  }
  // every rank's barriers exist before any multicast or copy reaches them
  cluster_arrive();
  cluster_wait();

  if (tid >= CONSUMERS) {
    if (tid == PRODUCER) {
      mbar_expect_tx(xbar, CL_PANEL);
      for (int kb = rank; kb < KB; kb += CL_RANKS)
        tma_load_2d_mc(panel + (size_t)kb * PR * 128, &tx, xbar, kb * BOX, p0, 0xF);
      int it = 0;
      auto stage = [&]() -> uint8_t* {
        const int st = it % S;
        mbar_wait(&empty[st], ((it / S) & 1) ^ 1);
        mbar_expect_tx(&full[st], CL_STAGE);
        return ring + (size_t)st * CL_STAGE;
      };
      for (int j = 0; j < pairs; ++j) {
        const int h0 = 2 * j * CL_HN + CL_SL * rank;  // chunk 2 j's slice; + HN: chunk 2 j + 1
        for (int i = 0; i < KB / 2; ++i, ++it) {
          uint8_t* s = stage();
          for (int c = 0; c < 2; ++c)
            for (int u = 0; u < 2; ++u)
              tma_load_2d(s + c * 8192 + u * 4096, &tw1, &full[it % S], (2 * i + u) * BOX,
                          h0 + c * CL_HN);
        }
        for (int s4 = 0; s4 < 4; ++s4)
          for (int w = 0; w < 2; ++w, ++it)
            tma_load_2d(stage(), &tw2, &full[it % S], 2 * j * CL_HN + 64 * s4, col0 + 128 * w);
      }
    }
  } else {
    const int wg = tid / 128, wtid = tid % 128, warp = tid >> 5, lane = tid & 31;
    // LN2 of the panel in place (csrc/swin_mlp.cu's columns mode)
    {
      float2 w[KB], b[KB];
#pragma unroll
      for (int i = 0; i < KB; ++i) {
        w[i] = *reinterpret_cast<const float2*>(ln_w + 64 * i + 2 * lane);
        b[i] = *reinterpret_cast<const float2*>(ln_b + 64 * i + 2 * lane);
      }
      mbar_wait(xbar, 0);
      for (int r0 = 2 * warp; r0 < PR; r0 += 2 * CONSUMERS / 32) {
        uint8_t* row[2];
        float2 v[2][KB];
        float s[2] = {0.f, 0.f}, q[2] = {0.f, 0.f};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int r = r0 + u;
          row[u] = panel + r * 128 + (((lane >> 2) ^ (r & 7)) * 16 + (lane & 3) * 4);
#pragma unroll
          for (int i = 0; i < KB; ++i) {
            v[u][i] = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(row[u] + (size_t)i * PR * 128));
            s[u] += v[u][i].x + v[u][i].y;
          }
        }
        float mu[2], rstd[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) mu[u] = warp_sum(s[u]) / (float)CL_WIDTH;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int i = 0; i < KB; ++i) {
            const float d0 = v[u][i].x - mu[u], d1 = v[u][i].y - mu[u];
            q[u] += __fmul_rn(d0, d0) + __fmul_rn(d1, d1);
          }
#pragma unroll
        for (int u = 0; u < 2; ++u) rstd[u] = rsqrtf(warp_sum(q[u]) / (float)CL_WIDTH + eps);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int i = 0; i < KB; ++i)
            *reinterpret_cast<__nv_bfloat162*>(row[u] + (size_t)i * PR * 128) =
                __floats2bfloat162_rn(ln_affine(v[u][i].x, mu[u], rstd[u], w[i].x, b[i].x),
                                      ln_affine(v[u][i].y, mu[u], rstd[u], w[i].y, b[i].y));
      }
    }
    fence_async_smem();
    named_sync(1, CONSUMERS);

    // the ring, as in csrc/swin_mlp.cu: a stage is released once the next
    // committed group is issued and the products reading it are done; a W1
    // stage takes an arrival of each consumer thread, a W2 stage (one
    // warpgroup's) two of each of its threads, and the other warpgroup
    // steps over it
    int it = 0, pending = -1, pending_n = 1;
    auto take = [&]() -> const uint8_t* {
      const int st = it % S;
      mbar_wait(&full[st], (it / S) & 1);
      return ring + (size_t)st * CL_STAGE;
    };
    auto release = [&]() {
      if (pending >= 0) mbar_arrive_cnt(&empty[pending], pending_n);
      pending = -1;
    };
    auto committed = [&](int n) {
      wg_wait<1>();
      release();
      pending = it % S;
      pending_n = n;
      ++it;
    };
    auto drain = [&]() {
      wg_wait<0>();
      release();
    };

    const int g = lane >> 2, t = lane & 3;
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    float a1[16];
    uint8_t* mine = gtile + wg * CL_GTILE + rank * CL_SLICE;  // this warpgroup's slice
    for (int j = 0; j < pairs; ++j) {
      // fc1 of chunk 2 j + wg over this rank's 32 columns of it
#pragma unroll
      for (int e = 0; e < 16; ++e) a1[e] = 0.f;
      for (int i = 0; i < KB / 2; ++i) {
        const uint8_t* sb = take() + wg * 8192;
        wg_fence();
        fence_regs(a1);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n32_ss<0, 0>(a1,
                                  desc_sw128(panel + (size_t)(2 * i + u) * PR * 128 + kk * 32, 16, ATOM),
                                  desc_sw128(sb + u * 4096 + kk * 32, 16, ATOM));
        wg_commit();
        fence_regs(a1);
        committed(1);
        if (CL_EXCHANGE && i == 0 && j > 0) {
          // the group before this one, pair j - 1's last fc2 products, is
          // done: both tiles are free here; tell every rank
          named_sync(2 + wg, 128);
          if (wtid < CL_RANKS) {
            mbar_arrive_rank(&gfree[0], wtid);
            mbar_arrive_rank(&gfree[1], wtid);
          }
        }
      }
      drain();
      fence_regs(a1);
      // + b1, exact GELU, one rounding: element (16 (warp % 4) + g + 8 hr,
      // 8 q + 2 t + e) of the slice is a1[4 q + 2 hr + e]
      const int hc0 = (2 * j + wg) * CL_HN + CL_SL * rank;
      uint32_t gp[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 bv = *reinterpret_cast<const float2*>(b1 + hc0 + 8 * q + 2 * t);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          gp[q][hr] = pack_bf16(gelu_exact(a1[4 * q + 2 * hr] + bv.x),
                                gelu_exact(a1[4 * q + 2 * hr + 1] + bv.y));
      }
      // every rank has read the tile's pair j - 1 chunk
      if (CL_EXCHANGE && j > 0) mbar_wait_cluster(&gfree[wg], (j - 1) & 1);
      // the slice in the 64-byte swizzle: row rr at 64 rr, 16-byte chunk
      // q ^ ((rr / 2) % 4)
      const int r = 16 * (warp & 3) + g;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int rr = r + 8 * hr;
          *reinterpret_cast<uint32_t*>(mine + rr * 64 + ((q ^ ((rr >> 1) & 3)) << 4) + t * 4) =
              gp[q][hr];
        }
      fence_async_smem();
      named_sync(2 + wg, 128);
      if (CL_EXCHANGE && wtid == 0) {
        mbar_expect_tx(&gfull[wg], (CL_RANKS - 1) * CL_SLICE);
        for (int q = 1; q < CL_RANKS; ++q)
          bulk_copy_rank(mine, mine, CL_SLICE, &gfull[wg], (rank + q) % CL_RANKS);
      }

      // fc2 of both chunks: k-slices of 64 hidden columns, two a chunk;
      // warpgroup 0's W2 box, then warpgroup 1's
#pragma unroll 1
      for (int s4 = 0; s4 < 4; ++s4) {
        const int b = s4 >> 1;
        if (CL_EXCHANGE && (s4 & 1) == 0) mbar_wait_cluster(&gfull[b], j & 1);
        const uint8_t* ga = gtile + b * CL_GTILE + (s4 & 1) * 2 * CL_SLICE;
        it += wg;
        const uint8_t* sb = take();
        wg_fence();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128_ss<0, 0>(acc, desc_sw64(ga + (kk >> 1) * CL_SLICE + (kk & 1) * 32),
                                 desc_sw128(sb + kk * 32, 16, ATOM));
        wg_commit();
        fence_regs(acc);
        committed(2);
        it += 1 - wg;
      }
    }
    drain();
    fence_regs(acc);
    // park the sums over the panel: float32 rows of the rank's 256 columns
    named_sync(1, CONSUMERS);
    const int r = 16 * (warp & 3) + g;
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<float2*>(part + (r + 8 * hr) * CL_LDP + wg * 128 + 8 * q + 2 * t) =
            make_float2(acc[4 * q + 2 * hr], acc[4 * q + 2 * hr + 1]);
  }
  // every copy into this block has landed (its fc2 waited for them) and no
  // block still needs another's shared memory
  cluster_arrive();
  cluster_wait();
  constexpr int V4 = CL_NB / 4;
  for (int i = tid; i < PR * V4; i += THREADS) {
    const int rr = i / V4, c = 4 * (i % V4);
    const int tok = p0 + rr;
    if (tok >= n_tokens) continue;
    const float4 s = *reinterpret_cast<const float4*>(part + rr * CL_LDP + c);
    const int gc = col0 + c;
    const float4 bv = *reinterpret_cast<const float4*>(b2 + gc);
    const size_t off = (size_t)tok * CL_WIDTH + gc;
    const uint2 xr = *reinterpret_cast<const uint2*>(x + off);
    const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.x));
    const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.y));
    uint2 o;
    o.x = pack_bf16(__fadd_rn(x01.x, s.x + bv.x), __fadd_rn(x01.y, s.y + bv.y));
    o.y = pack_bf16(__fadd_rn(x23.x, s.z + bv.z), __fadd_rn(x23.y, s.w + bv.w));
    *reinterpret_cast<uint2*>(out + off) = o;
  }
}

}  // namespace hmdt

// C interface for ctypes. Returns cudaGetLastError() after the launch (0 on
// success), or the error that stopped it before. x and out are distinct
// (n_tokens, C) bf16 buffers; w1 (hidden, C), w2 (C, hidden) bf16; b1, b2,
// ln_w, ln_b float32; C 1024, hidden a multiple of 256; eps LN2's epsilon.
extern "C" int vit_mlp_cluster_launch(const void* x, void* out, const void* ln_w, const void* ln_b,
                                      const void* w_fc1, const void* b_fc1, const void* w_fc2,
                                      const void* b_fc2, int n_tokens, int C, int hidden, float eps,
                                      void* stream) {
  using namespace hmdt;
  if (C != CL_WIDTH || n_tokens <= 0 || hidden <= 0 || hidden % (2 * CL_HN))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = cl_smem_bytes();
  static_assert(smem <= SMEM_LIMIT, "shared memory over the sm_90 limit");
  CUtensorMap mx, m1, m2;
  const uint64_t dx[2] = {(uint64_t)C, (uint64_t)n_tokens};
  const uint64_t d1[2] = {(uint64_t)C, (uint64_t)hidden}, d2[2] = {(uint64_t)hidden, (uint64_t)C};
  const uint32_t bx[2] = {BOX, (uint32_t)CL_PR}, b1x[2] = {BOX, (uint32_t)CL_SL},
                 b2x[2] = {BOX, 128};
  int err = make_tensor_map(&mx, x, 2, dx, bx);
  if (!err) err = make_tensor_map(&m1, w_fc1, 2, d1, b1x);
  if (!err) err = make_tensor_map(&m2, w_fc2, 2, d2, b2x);
  if (err) return err;
  auto kernel = vit_mlp_cluster_kernel;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long blocks = (long)((n_tokens + CL_PR - 1) / CL_PR) * CL_RANKS;
  if (blocks > 2147483647L) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL_RANKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, mx, m1, m2, static_cast<const bf16*>(x),
                         static_cast<bf16*>(out), static_cast<const float*>(ln_w),
                         static_cast<const float*>(ln_b), static_cast<const float*>(b_fc1),
                         static_cast<const float*>(b_fc2), n_tokens, hidden, eps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
