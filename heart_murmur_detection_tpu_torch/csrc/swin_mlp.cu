// swin_mlp: the MLP half of an HTS-AT swin block, per token,
//   y = x + k[tok / hw] * (fc2(GELU(fc1(LN2(x)) + b1)) + b2),  x (n_tokens, C) bf16;
//   k is an optional per-sample multiplier of the training forward (null: 1).
//   LN2's eps is an argument: 1e-5 for the swin blocks, 1e-6 for ViT.
//
// Replaces the MLP body `_strip_mlp` (heart_murmur_detection_tpu/ops/
// pallas_swin.py:388) that the TPU kernels fused_swin_block (:480),
// fused_swin_pair (:847) and fused_swin_block_split (:618, MLP half) run,
// the MLP half of `_train_fwd_kernel` (ops/pallas_swin_train.py:233, K8),
// and, as `vit_mlp`, the ViT MLP body `_mlp_half` (ops/pallas_vit.py:149)
// of fused_vit_block (:296, K5) and fused_vit_mlp (:373, K7) at C 384 and
// 768 (HeAR's C 1024 runs csrc/vit_rows.cu): the same token-wise LN, fc1,
// exact GELU, fc2 and residual. As in the TPU body, GELU(fc1) never leaves
// the chip.
//
// Bound on this card: 16 C^2 operations a token against 4 C bytes, so the
// products bind at every width (about 10 us a stage at B = 16, whatever the
// stage); at C = 96 the exact GELU (4 C erf a token on the SIMT units)
// costs about as much as the products. Design (wgmma_gemm.cuh's pieces; one
// producer warp and two consumer warpgroups a block):
//  - a block owns a panel of token rows: 128 at C <= 192 (each warpgroup 64
//    rows and every output column), 64 at C >= 384 (the warpgroups split the
//    output columns: a 64 x C float32 accumulator would not fit in
//    registers). The producer loads the panel's x rows by TMA in the
//    128-byte-swizzle K-major A layout (rows past n_tokens and the columns
//    past C = 96 or 192 of the last 64-column box read as zeros); the
//    consumers compute LN2 in place, float32 statistics rounded to bf16.
//  - W1 and W2 stream through one TMA ring of 16 KB stages, in the order the
//    consumers take them: for each hidden chunk of HN (128; 64 at C = 192),
//    the W1 boxes (HN rows x 64 of K) over K = C, then the W2 boxes (96
//    output rows x 64 hidden columns) over the chunk.
//  - fc1 of a chunk runs on wgmma over the valid k16 steps of C (no product
//    over the zero-filled columns); + b1 and the exact erf GELU in float32,
//    rounded to bf16 (the plain version's rounding point).
//    Rows mode (C <= 192): the rounded chunk is the register A operand of fc2
//    (the accumulator layout is the m16n8k16 A fragment), so it never
//    touches shared memory. Columns mode (C >= 384): each warpgroup computes
//    half of the chunk's columns and writes them to a double-buffered
//    shared-memory A tile, and both read the whole chunk for their halves of
//    the output columns.
//  - fc2 accumulates in float32 across the chunks in registers (m64n96
//    accumulators: 48, 96 or 96 floats a thread).
//  - at C = 768 the block's output columns are half of C (the other half is
//    another block, which recomputes fc1: 1.5x the products of that stage);
//    where the panels alone would leave the card idle (a plan computed by
//    the wrapper, ops/swin_plan.py, from the grid and the SM count), the
//    hidden chunks split over a cluster of ks blocks. Every block parks its
//    fc2 sums as float32 rows in shared memory; each block then sums its
//    share of the rows over the cluster in rank order through distributed
//    shared memory (no atomics: two launches agree bitwise), adds b2,
//    multiplies by k, adds x and rounds once to bf16, four columns a thread.
#include "swin_common.cuh"
#include "vit_attn_common.cuh"
#include "wgmma_gemm.cuh"

namespace hmdt {

using namespace hop;

constexpr int MLP_STAGE = 16384;  // bytes a ring stage
constexpr int W2_ROWS = 96;       // output rows of a W2 box
constexpr int PART_PAD = 8;       // float32 padding of a parked row

template <int C>
struct MlpCfg {
  static constexpr bool ROWS = C <= 192;        // rows mode, else columns mode
  static constexpr int PR = ROWS ? 128 : 64;    // panel rows
  static constexpr int HN = C == 192 ? 64 : 128;  // hidden chunk
  // C = 96: fc2 of a chunk still runs while the next chunk's fc1 is issued
  static constexpr bool OVERLAP = C == 96;
  // output columns of a block
  static constexpr int NB = C <= 384 ? C : 384;
  static constexpr int NS = C / NB;               // blocks over the output columns
  static constexpr int T2 = NB / W2_ROWS;         // W2 boxes of a 64-column k-slice
  static constexpr int NA = ROWS ? T2 : T2 / 2;   // fc2 accumulators of a warpgroup
  static constexpr int FN = ROWS ? HN : HN / 2;   // fc1 columns of a warpgroup
  static constexpr int KB = (C + 63) / 64;        // 64-column boxes of K = C
  static constexpr int KS16 = C / 16;             // k16 steps of K = C
  static constexpr int PANEL = KB * PR * 128;
  static constexpr int G_BYTES = ROWS ? 0 : 2 * (HN / 64) * 64 * 128;  // two GELU chunks
  static constexpr int LDP = NB + PART_PAD;       // float32 row of the parked sums
  static_assert(NB % W2_ROWS == 0 && (ROWS || T2 % 2 == 0), "whole W2 boxes a warpgroup");
  static_assert(FN == 64 || FN == 128, "fc1 on m64n64 or m64n128");
};

// Layout of the dynamic shared memory (from a 1024-byte boundary); the
// parked sums alias the panel and the ring once every product is done.
template <int C>
__host__ __device__ constexpr size_t mlp_ring_off() {
  return (size_t)MlpCfg<C>::PANEL + MlpCfg<C>::G_BYTES;
}
template <int C>
__host__ __device__ constexpr size_t mlp_smem_bytes(int stages) {
  return mlp_ring_off<C>() + (size_t)stages * MLP_STAGE + 8 * (1 + 2 * (size_t)stages) + 1024;
}

// grid: blockIdx.x = (panel * NS + ns) * ks + rank, clusters of ks blocks.
// tx: x (n_tokens, C) in boxes of 64 x PR; tw1: W1 (hidden, C) in boxes of
// 64 x HN; tw2: W2 (C, hidden) in boxes of 64 x W2_ROWS.
template <int C>
__global__ void __launch_bounds__(THREADS, 1)
swin_mlp_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw1,
                const __grid_constant__ CUtensorMap tw2, const bf16* __restrict__ x,
                bf16* __restrict__ out, const float* __restrict__ ln_w,
                const float* __restrict__ ln_b, const float* __restrict__ b1,
                const float* __restrict__ b2, const float* __restrict__ kmul, int n_tokens,
                int hidden, int hw, int ks, int stages, float eps) {
  using Cfg = MlpCfg<C>;
  constexpr int PR = Cfg::PR, HN = Cfg::HN, KB = Cfg::KB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  uint8_t* panel = base;
  uint8_t* gbuf = base + Cfg::PANEL;
  uint8_t* ring = base + mlp_ring_off<C>();
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + (size_t)stages * MLP_STAGE);
  uint64_t* xbar = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + stages;
  float* part = reinterpret_cast<float*>(base);
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(xbar, 1);
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int rank = (int)(blockIdx.x % ks);
  const int ns = (int)(blockIdx.x / ks) % Cfg::NS;
  const int p0 = (int)(blockIdx.x / ks / Cfg::NS) * PR;
  const int col0 = ns * Cfg::NB;
  const int h_beg = rank * (hidden / ks), h_end = h_beg + hidden / ks;

  if (tid >= CONSUMERS) {
    if (tid == PRODUCER) {
      mbar_expect_tx(xbar, Cfg::PANEL);
      for (int kb = 0; kb < KB; ++kb)
        tma_load_2d(panel + (size_t)kb * PR * 128, &tx, xbar, kb * BOX, p0);
      int it = 0;
      auto push = [&](const CUtensorMap* map, int c0, int c1, uint32_t bytes) {
        const int st = it % stages;
        mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);
        mbar_expect_tx(&full[st], bytes);
        tma_load_2d(ring + (size_t)st * MLP_STAGE, map, &full[st], c0, c1);
        ++it;
      };
      for (int h0 = h_beg; h0 < h_end; h0 += HN) {
        for (int kb = 0; kb < KB; ++kb) push(&tw1, kb * BOX, h0, HN * 128);
        for (int s = 0; s < HN / 64; ++s)
          for (int t = 0; t < Cfg::T2; ++t)
            push(&tw2, h0 + 64 * s, col0 + W2_ROWS * t, W2_ROWS * 128);
      }
    }
  } else {
    const int wg = tid / 128, warp = tid >> 5, lane = tid & 31;
    // LN2 of the panel in place: the TMA boxes hold x in the swizzled
    // K-major layout, element (r, c) in the box of columns 64 (c / 64) at
    // row r, 16-byte chunk (c % 64) / 8 ^ (r % 8); lane l takes columns
    // 64 i + 2 l, + 1 (those < C) of two rows at a time
    {
      float2 w[KB], b[KB];
#pragma unroll
      for (int i = 0; i < KB; ++i) {
        const bool ok = 64 * i + 2 * lane < C;
        w[i] = ok ? *reinterpret_cast<const float2*>(ln_w + 64 * i + 2 * lane) : make_float2(0.f, 0.f);
        b[i] = ok ? *reinterpret_cast<const float2*>(ln_b + 64 * i + 2 * lane) : make_float2(0.f, 0.f);
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
            v[u][i] = 64 * i + 2 * lane < C
                          ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                row[u] + (size_t)i * PR * 128))
                          : make_float2(0.f, 0.f);
            s[u] += v[u][i].x + v[u][i].y;
          }
        }
        float mu[2], rstd[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) mu[u] = warp_sum(s[u]) / (float)C;
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int i = 0; i < KB; ++i)
            if (64 * i + 2 * lane < C) {
              const float d0 = v[u][i].x - mu[u], d1 = v[u][i].y - mu[u];
              q[u] += __fmul_rn(d0, d0) + __fmul_rn(d1, d1);
            }
#pragma unroll
        for (int u = 0; u < 2; ++u) rstd[u] = rsqrtf(warp_sum(q[u]) / (float)C + eps);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int i = 0; i < KB; ++i)
            if (64 * i + 2 * lane < C)
              *reinterpret_cast<__nv_bfloat162*>(row[u] + (size_t)i * PR * 128) =
                  __floats2bfloat162_rn(ln_affine(v[u][i].x, mu[u], rstd[u], w[i].x, b[i].x),
                                        ln_affine(v[u][i].y, mu[u], rstd[u], w[i].y, b[i].y));
      }
    }
    fence_async_smem();
    named_sync(1, CONSUMERS);

    // the ring, in the producer's order; a stage is released once the
    // products of the next committed group have been issued and the ones
    // reading it are done (wg_wait<1>). A stage that both warpgroups read
    // takes an arrival of each consumer thread; a W2 box that one
    // warpgroup alone reads (columns mode) takes two of each of its
    // threads, and the other warpgroup steps over it without waiting.
    int it = 0, pending = -1, pending_n = 1;
    auto take = [&]() -> const uint8_t* {
      const int st = it % stages;
      mbar_wait(&full[st], (it / stages) & 1);
      return ring + (size_t)st * MLP_STAGE;
    };
    auto release = [&]() {
      if (pending >= 0) mbar_arrive_cnt(&empty[pending], pending_n);
      pending = -1;
    };
    auto committed = [&](int n) {  // after the commit of the group reading stage `it`
      wg_wait<1>();
      release();
      pending = it % stages;
      pending_n = n;
      ++it;
    };
    auto drain = [&]() {  // every product done, every stage released
      wg_wait<0>();
      release();
    };

    const uint8_t* pa = panel + (Cfg::ROWS ? wg * 64 * 128 : 0);  // this warpgroup's rows
    const int g = lane >> 2, t = lane & 3;
    float acc[Cfg::NA][W2_ROWS / 2];
#pragma unroll
    for (int a = 0; a < Cfg::NA; ++a)
#pragma unroll
      for (int e = 0; e < W2_ROWS / 2; ++e) acc[a][e] = 0.f;
    float a1[Cfg::FN / 2];
    // the rounded GELU chunk: in rows mode the register A operand of fc2.
    // At C = 96 fc2's last products still read it while the next chunk's
    // fc1 is issued, so it stays live (keep_regs) until the drain after
    // that fc1; at C = 192 fc2 is drained at the end of the chunk instead
    // (its 96 accumulator floats leave no room for the fragments to
    // outlive it)
    uint32_t gp[Cfg::FN / 16][4] = {};
    for (int h0 = h_beg, chunk = 0; h0 < h_end; h0 += HN, ++chunk) {
      // fc1: this warpgroup's FN columns of the chunk (rows FN wg of a
      // W1 box of HN rows in columns mode)
#pragma unroll
      for (int e = 0; e < Cfg::FN / 2; ++e) a1[e] = 0.f;
      const int boff = Cfg::ROWS ? 0 : wg * Cfg::FN * 128;
      for (int kb = 0; kb < KB; ++kb) {
        const uint8_t* sb = take() + boff;
        wg_fence();
        fence_regs(a1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (4 * kb + kk >= Cfg::KS16) break;
          const uint64_t da = desc_sw128(pa + (size_t)kb * PR * 128 + kk * 32, 16, ATOM);
          const uint64_t db = desc_sw128(sb + kk * 32, 16, ATOM);
          if constexpr (Cfg::FN == 128) wgmma_m64n128_ss<0, 0>(a1, da, db);
          else wgmma_m64n64_ss<0, 0>(a1, da, db);
        }
        wg_commit();
        fence_regs(a1);
        committed(1);
      }
      drain();
      fence_regs(a1);
      if constexpr (Cfg::OVERLAP) keep_regs(gp);
      // + b1, exact GELU, one rounding: element (16 (warp % 4) + g + 8 hr,
      // 8 j + 2 t + e) of the warpgroup's tile is a1[4 j + 2 hr + e]
      const int hc0 = h0 + (Cfg::ROWS ? 0 : wg * Cfg::FN);
#pragma unroll
      for (int j = 0; j < Cfg::FN / 8; ++j) {
        const float2 bv = *reinterpret_cast<const float2*>(b1 + hc0 + 8 * j + 2 * t);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          gp[j / 2][2 * (j & 1) + hr] = pack_bf16(gelu_exact(a1[4 * j + 2 * hr] + bv.x),
                                                  gelu_exact(a1[4 * j + 2 * hr + 1] + bv.y));
      }
      if constexpr (Cfg::ROWS) {
        // fc2 from registers: k16 step kk of the chunk is gp[kk]
#pragma unroll
        for (int s = 0; s < HN / 64; ++s)
#pragma unroll
          for (int a = 0; a < Cfg::NA; ++a) {
            const uint8_t* sb = take();
            wg_fence();
            fence_regs(acc[a]);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              wgmma_m64n96_rs<0>(acc[a], gp[4 * s + kk], desc_sw128(sb + kk * 32, 16, ATOM));
            wg_commit();
            fence_regs(acc[a]);
            committed(1);
          }
        if (!Cfg::OVERLAP) drain();
      } else {
        // the GELU chunk to shared memory (buffer chunk % 2, this
        // warpgroup's 64 columns in its box), then fc2 from there
        uint8_t* gt = gbuf + (chunk & 1) * (HN / 64) * 64 * 128;
        uint8_t* mine = gt + wg * 64 * 128;
        const int r = 16 * (warp & 3) + g;
#pragma unroll
        for (int j = 0; j < Cfg::FN / 8; ++j)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int rr = r + 8 * hr;
            *reinterpret_cast<uint32_t*>(mine + rr * 128 + ((j ^ (rr & 7)) << 4) + t * 4) =
                gp[j / 2][2 * (j & 1) + hr];
          }
        fence_async_smem();
        named_sync(1, CONSUMERS);
        // a k-slice's W2 boxes: warpgroup 0's NA, then warpgroup 1's NA
#pragma unroll
        for (int s = 0; s < HN / 64; ++s) {
          it += wg * Cfg::NA;
#pragma unroll
          for (int a = 0; a < Cfg::NA; ++a) {
            const uint8_t* sb = take();
            wg_fence();
            fence_regs(acc[a]);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint64_t da = desc_sw128(gt + s * 64 * 128 + kk * 32, 16, ATOM);
              const uint64_t db = desc_sw128(sb + kk * 32, 16, ATOM);
              wgmma_m64n96_ss<0, 0>(acc[a], da, db);
            }
            wg_commit();
            fence_regs(acc[a]);
            committed(2);
          }
          it += (1 - wg) * Cfg::NA;
        }
      }
    }
    drain();
    if constexpr (Cfg::OVERLAP) keep_regs(gp);
#pragma unroll
    for (int a = 0; a < Cfg::NA; ++a) fence_regs(acc[a]);
    // every product of both warpgroups is done: park the sums over the
    // panel and the ring, float32 rows of NB columns
    named_sync(1, CONSUMERS);
    const int r = (Cfg::ROWS ? 64 * wg : 0) + 16 * (warp & 3) + g;
    const int cw = Cfg::ROWS ? 0 : wg * Cfg::NA * W2_ROWS;
#pragma unroll
    for (int a = 0; a < Cfg::NA; ++a)
#pragma unroll
      for (int j = 0; j < W2_ROWS / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<float2*>(part + (r + 8 * hr) * Cfg::LDP + cw + W2_ROWS * a + 8 * j +
                                     2 * t) =
              make_float2(acc[a][4 * j + 2 * hr], acc[a][4 * j + 2 * hr + 1]);
  }

  // sum the parked rows over the cluster in rank order (this block: rows
  // [rank PR / ks, (rank + 1) PR / ks)), + b2, times k, + x, one rounding
  if (ks > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  const int r_beg = rank * PR / ks, r_end = (rank + 1) * PR / ks;
  constexpr int V4 = Cfg::NB / 4;
  for (int i = tid; i < (r_end - r_beg) * V4; i += THREADS) {
    const int rr = r_beg + i / V4, c = 4 * (i % V4);
    const int tok = p0 + rr;
    if (tok >= n_tokens) continue;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < ks; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(cluster_map(part, q) + rr * Cfg::LDP + c);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    const int gc = col0 + c;
    const float4 bv = *reinterpret_cast<const float4*>(b2 + gc);
    const size_t off = (size_t)tok * C + gc;
    const uint2 xr = *reinterpret_cast<const uint2*>(x + off);
    const float2 x01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.x));
    const float2 x23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr.y));
    const float k = kmul ? kmul[tok / hw] : 1.f;
    uint2 o;
    o.x = pack_bf16(add_scaled(x01.x, k, s.x + bv.x), add_scaled(x01.y, k, s.y + bv.y));
    o.y = pack_bf16(add_scaled(x23.x, k, s.z + bv.z), add_scaled(x23.y, k, s.w + bv.w));
    *reinterpret_cast<uint2*>(out + off) = o;
  }
  if (ks > 1) {  // no block leaves while another still reads its sums
    cluster_arrive();
    cluster_wait();
  }
}

template <int C>
static int launch_mlp(const void* x, void* out, const void* ln_w, const void* ln_b,
                      const void* w1, const void* b1, const void* w2, const void* b2,
                      const void* kmul, int n_tokens, int hidden, int hw, int ks, int stages,
                      float eps, cudaStream_t stream) {
  using Cfg = MlpCfg<C>;
  if (hidden % (Cfg::HN * ks)) return (int)cudaErrorInvalidValue;
  const size_t smem = mlp_smem_bytes<C>(stages);
  // the parked sums must fit over the panel, the GELU chunks and the ring
  if (smem > SMEM_LIMIT || (size_t)Cfg::PR * Cfg::LDP * 4 > mlp_ring_off<C>() + (size_t)stages * MLP_STAGE)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mx, m1, m2;
  const uint64_t dx[2] = {(uint64_t)C, (uint64_t)n_tokens};
  const uint64_t d1[2] = {(uint64_t)C, (uint64_t)hidden}, d2[2] = {(uint64_t)hidden, (uint64_t)C};
  const uint32_t bx[2] = {BOX, (uint32_t)Cfg::PR}, b1x[2] = {BOX, (uint32_t)Cfg::HN},
                 b2x[2] = {BOX, (uint32_t)W2_ROWS};
  int err = make_tensor_map(&mx, x, 2, dx, bx);
  if (!err) err = make_tensor_map(&m1, w1, 2, d1, b1x);
  if (!err) err = make_tensor_map(&m2, w2, 2, d2, b2x);
  if (err) return err;
  auto kernel = swin_mlp_kernel<C>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long blocks = (long)((n_tokens + Cfg::PR - 1) / Cfg::PR) * Cfg::NS * ks;
  if (blocks > 2147483647L) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, mx, m1, m2, static_cast<const bf16*>(x),
                         static_cast<bf16*>(out), static_cast<const float*>(ln_w),
                         static_cast<const float*>(ln_b), static_cast<const float*>(b1),
                         static_cast<const float*>(b2), static_cast<const float*>(kmul), n_tokens,
                         hidden, hw, ks, stages, eps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace hmdt

// C interface for ctypes. Returns cudaGetLastError() after the launch (0 on
// success), or the error that stopped it before. x and out are distinct
// (n_tokens, C) bf16 buffers; kmul (one float per sample of hw tokens) may be
// null; eps is LN2's epsilon. The launch plan (ops/swin_plan.py::mlp_plan):
// panel_rows must be the kernel's for C (a check that the two agree), ks the
// blocks of a cluster over the hidden chunks, stages the ring's depth.
extern "C" int swin_mlp_launch(const void* x, void* out, const void* ln_w, const void* ln_b,
                               const void* w_fc1, const void* b_fc1, const void* w_fc2,
                               const void* b_fc2, const void* kmul, int n_tokens, int C,
                               int hidden, int hw, int panel_rows, int ks, int stages, float eps,
                               void* stream) {
  using namespace hmdt;
  if (n_tokens <= 0 || hidden <= 0 || hw <= 0 || ks < 1 || ks > 8 || stages < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HMDT_MLP_CASE(CC)                                                                    \
  case CC:                                                                                   \
    if (panel_rows != MlpCfg<CC>::PR) return (int)cudaErrorInvalidValue;                     \
    return launch_mlp<CC>(x, out, ln_w, ln_b, w_fc1, b_fc1, w_fc2, b_fc2, kmul, n_tokens,    \
                          hidden, hw, ks, stages, eps, s);
  switch (C) {
    HMDT_MLP_CASE(96)
    HMDT_MLP_CASE(192)
    HMDT_MLP_CASE(384)
    HMDT_MLP_CASE(768)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HMDT_MLP_CASE
}
