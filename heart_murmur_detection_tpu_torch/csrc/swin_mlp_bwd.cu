// swin_mlp_bwd: backward of the MLP half of a training block,
//   y = h1 + k2[b] * fc2(GELU(fc1(LN2(h1)))),  h1, dy (n_tokens, C) bf16,
// given dy: dh1 = dy + LN2^T(dm), where with a1 = LN2(h1) W1^T + b1,
//   dyk = k2 dy,  da1 = (dyk W2) * GELU'(a1),  dm = da1 W1.
// The LN eps is an argument: 1e-5 for the HTS-AT swin blocks, 1e-6 for the
// MAE ViT blocks, which have no DropPath (a null k2 means k2 = 1).
//
// Replaces the MLP half of the TPU backwards: `_bwd_mlp_kernel`
// (heart_murmur_detection_tpu/ops/pallas_swin_train.py:271) of
// fused_swin_block_train (:606, K8), and `_bwd_mlp_common` as
// `_bwd_mlp_acc_kernel` / `_bwd_mlp_emit_kernel` run it
// (heart_murmur_detection_tpu/ops/pallas_vit_train.py:163-238) in
// fused_vit_block_train (:703, K9).
//
// Outputs, besides dh1:
//   - the per-token operands of the two weight products, bf16 rows:
//     m_g = LN2(h1), g_g = GELU(a1), dyk_g = k2 dy (not written without a
//     k2: dy itself is the operand), da1_g = da1, from which swin_wgrad.cu
//     forms dW1 = da1^T LN2(h1) and dW2 = dyk^T GELU(a1);
//   - float32 partial rows [db1 (4C) | db2 (C) | dLN2 w (C) | dLN2 b (C)],
//     summed later in row order by swin_reduce: one a warp of a chunk-kernel
//     block (db1: the warp's rows of each panel the block walks, in order),
//     whose other columns are one row-pass block's (db2, dLN2: its run of
//     tiles in order). No atomics: every column of a row has one owner
//     thread and one order.
//
// Bound on this card: 6 n C hidden operations (the fc1 recompute, dg and
// dm) against ~6 n C bytes in and out, so the products bind at every
// width; the design's own traffic (the four operand rows, 20 n C bytes, and
// dm's float32 round trip, 8 n C) puts C = 96 and 192 on the bytes side.
// Design: three grid launches on the caller's stream (one call), each kernel
// named swin_mlp_bwd_* so that a profile groups them:
//  1. swin_mlp_bwd_chunk_kernel: one producer warp and two consumer
//     warpgroups. A block walks a contiguous run of (panel, hidden chunk)
//     units in panel order; a panel is 128 token rows at C <= 192 (each
//     warpgroup 64 rows and every column of a chunk of 64) or 64 at
//     C >= 384 (both warpgroups on the 64 rows, each 64 columns of a chunk
//     of 128: two 128-row panels at C = 384 would fill shared memory).
//     h1 and dy arrive by TMA as 128-byte-swizzled K-major panels; LN2 runs
//     in place once a panel (written out as m_g), k2 dy is rounded in place
//     (dyk_g). At C = 768 the two panels would leave no ring, so dy streams
//     through the ring beside the weights instead (the ViT has no k2). W1
//     and W2 stream by a TMA ring, read once a panel: for each k-slice of
//     64, the W1 box (chunk rows x 64 of K) and the W2 boxes (64 rows of K
//     x the chunk, read MN-major). a1 = LN2 W1[chunk]^T and dg = dyk
//     W2[:, chunk] accumulate on wgmma in the same fragment layout, so
//     da1 = dg GELU'(a1 + b1) is elementwise in registers; GELU(a1 + b1)
//     and da1, rounded, go out as operand rows straight from the registers;
//     db1 of the warp's 16 rows by a shuffle tree, added to its partial row.
//  2. swin_mlp_bwd_mm_kernel: dm = da1_g W1 (K = 4C) on the GEMM core of
//     wgmma_gemm.cuh (A K-major, W1 (4C, C) read as (K, N)), float32 rows.
//  3. swin_mlp_bwd_rows_kernel: the LN2 backward dh1 = dy + LN2^T(dm) and
//     the column sums db2, dLN2 w, dLN2 b (swin_bwd_common.cuh), a block
//     for each partial row of the chunk kernel.
// dm stays out of registers: m64 x C floats is 192 a thread at C = 384, and
// a 288-thread block gets 168 registers; splitting dm's columns instead
// (over the warpgroups or a cluster) would compute a1 and dg twice or move
// the da1 chunk through distributed shared memory (PERF.md §6 compares).
// Rounded to bf16 where the plain version (ops/swin_train.py::
// swin_mlp_bwd_ref) rounds: LN2(h1), k2 dy, GELU(a1), da1 and dh1.
#include "swin_bwd_common.cuh"

namespace hmdt {

template <int C>
struct MlpBwdCfg {
  static constexpr bool ROWS = C <= 192;      // rows mode, else columns mode
  static constexpr int PR = ROWS ? 128 : 64;  // panel rows
  static constexpr int HN = ROWS ? 64 : 128;  // hidden chunk
  static constexpr bool STREAM = C == 768;    // dy streamed through the ring
  static constexpr int KB = (C + 63) / 64;    // 64-column boxes of K = C
  static constexpr int KS16 = C / 16;         // k16 steps of K = C
  static constexpr int PANEL = KB * PR * 128;
  static constexpr int HELD = STREAM ? 1 : 2;  // panels held: LN2(h1) and k2 dy
  static constexpr int W_BYTES = HN * 128;     // a W1 box, and the W2 boxes of a k-slice
  static constexpr int STAGE = 2 * W_BYTES + (STREAM ? PR * 128 : 0);
  static constexpr int RPB = ROWS ? 8 : 4;  // db1 partial rows a block: a warp's 16 rows
};

template <int C>
__host__ __device__ constexpr size_t mlp_bwd_smem(int stages) {
  using Cfg = MlpBwdCfg<C>;
  return (size_t)Cfg::HELD * Cfg::PANEL + (size_t)stages * Cfg::STAGE + 8 * (2 + 2 * (size_t)stages) +
         1024;
}

// grid: block b walks units [b U / G, (b + 1) U / G) of the U = panels x
// chunks (panel, chunk) units, panel-major. th: h1 (n, C) and tdy: dy in
// boxes of 64 x PR; tw1: W1 (hidden, C) in boxes of 64 x HN; tw2: W2 (C,
// hidden) in boxes of 64 x 64. part: RPB rows a block, L floats each.
template <int C>
__global__ void __launch_bounds__(THREADS, 1)
swin_mlp_bwd_chunk_kernel(const __grid_constant__ CUtensorMap th, const __grid_constant__ CUtensorMap tdy,
                          const __grid_constant__ CUtensorMap tw1, const __grid_constant__ CUtensorMap tw2,
                          const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                          const float* __restrict__ b1, const float* __restrict__ kmul,
                          bf16* __restrict__ m_g, bf16* __restrict__ g_g, bf16* __restrict__ dyk_g,
                          bf16* __restrict__ da1_g, float* __restrict__ part, int n_tokens,
                          int hidden, int hw, int stages, int L, float eps) {
  using Cfg = MlpBwdCfg<C>;
  constexpr int PR = Cfg::PR, HN = Cfg::HN, KB = Cfg::KB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  uint8_t* xp = base;                // LN2(h1)
  uint8_t* yp = base + Cfg::PANEL;   // k2 dy (held)
  uint8_t* ring = base + (size_t)Cfg::HELD * Cfg::PANEL;
  uint64_t* pfull = reinterpret_cast<uint64_t*>(ring + (size_t)stages * Cfg::STAGE);
  uint64_t* pempty = pfull + 1;
  uint64_t* full = pfull + 2;
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(pfull, 1);
    mbar_init(pempty, CONSUMERS);
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int chunks = hidden / HN;
  const long units = (long)((n_tokens + PR - 1) / PR) * chunks;
  const int u_beg = (int)(units * blockIdx.x / gridDim.x);
  const int u_end = (int)(units * (blockIdx.x + 1) / gridDim.x);

  if (tid >= CONSUMERS) {
    if (tid == PRODUCER) {
      int it = 0, loads = 0;
      auto load_panel = [&](int p) {
        if (loads > 0) mbar_wait(pempty, (loads - 1) & 1);  // the last panel's products are done
        mbar_expect_tx(pfull, Cfg::HELD * Cfg::PANEL);
        for (int kb = 0; kb < KB; ++kb)
          tma_load_2d(xp + (size_t)kb * PR * 128, &th, pfull, kb * BOX, p * PR);
        if (!Cfg::STREAM)
          for (int kb = 0; kb < KB; ++kb)
            tma_load_2d(yp + (size_t)kb * PR * 128, &tdy, pfull, kb * BOX, p * PR);
        ++loads;
      };
      // the stages of unit u's k-slices; a new panel is loaded once the
      // ring holds the first stages of its first unit (or all of them)
      int pushed_in_panel = 0, next_panel = -1;
      auto push = [&](int p, int h0, int kb) {
        const int st = it % stages;
        mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);
        mbar_expect_tx(&full[st], Cfg::STAGE);
        uint8_t* s = ring + (size_t)st * Cfg::STAGE;
        tma_load_2d(s, &tw1, &full[st], kb * BOX, h0);
        for (int j = 0; j < HN / 64; ++j)
          tma_load_2d(s + Cfg::W_BYTES + j * BOX_BYTES, &tw2, &full[st], h0 + 64 * j, kb * BOX);
        if (Cfg::STREAM) tma_load_2d(s + 2 * Cfg::W_BYTES, &tdy, &full[st], kb * BOX, p * PR);
        ++it;
        if (next_panel >= 0 && ++pushed_in_panel == stages) {
          load_panel(next_panel);
          next_panel = -1;
        }
      };
      int cur = -1;
      for (int u = u_beg; u < u_end; ++u) {
        const int p = u / chunks, c = u % chunks;
        if (p != cur) {
          if (next_panel >= 0) load_panel(next_panel);  // a panel of fewer units than stages
          if (cur < 0) {
            load_panel(p);
          } else {
            next_panel = p;
            pushed_in_panel = 0;
          }
          cur = p;
        }
        for (int kb = 0; kb < KB; ++kb) push(p, c * HN, kb);
      }
      if (next_panel >= 0) load_panel(next_panel);
    }
    return;
  }

  const int wg = tid / 128, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rbase = Cfg::ROWS ? 64 * wg : 0;  // this warpgroup's rows of the panel
  const int cw = Cfg::ROWS ? 0 : 64 * wg;     // and its columns of a chunk
  float* prow = part + ((size_t)blockIdx.x * Cfg::RPB + (Cfg::ROWS ? warp : (warp & 3))) * L;
  // the db1 columns of the block's partial rows start at zero; each then
  // has one owner thread, which adds each panel's sums in order (the row
  // pass writes the other columns)
  for (int i = tid; i < Cfg::RPB * hidden; i += CONSUMERS)
    part[((size_t)blockIdx.x * Cfg::RPB + i / hidden) * L + i % hidden] = 0.f;

  int it = 0, pending = -1, loads = 0, cur = -1;
  auto take = [&]() -> const uint8_t* {
    const int st = it % stages;
    mbar_wait(&full[st], (it / stages) & 1);
    return ring + (size_t)st * Cfg::STAGE;
  };
  auto committed = [&]() {  // after the commit of the group reading stage `it`
    wg_wait<1>();
    if (pending >= 0) mbar_arrive(&empty[pending]);
    pending = it % stages;
    ++it;
  };
  auto drain = [&]() {
    wg_wait<0>();
    if (pending >= 0) mbar_arrive(&empty[pending]);
    pending = -1;
  };

  for (int u = u_beg; u < u_end; ++u) {
    const int p = u / chunks, c = u % chunks;
    const int p0 = p * PR;
    if (p != cur) {
      // a new panel: LN2(h1) in place (-> m_g), then k2 dy in place (->
      // dyk_g). The TMA boxes hold the rows in the swizzled K-major layout,
      // element (r, c) in the box of columns 64 (c / 64) at row r, 16-byte
      // chunk (c % 64) / 8 ^ (r % 8); lane l takes columns 64 i + 2 l, + 1
      // (those < C) of two rows at a time
      if (cur >= 0) mbar_arrive(pempty);  // every product reading the last panel is done
      cur = p;
      float2 lw[KB], lb[KB];
#pragma unroll
      for (int i = 0; i < KB; ++i) {
        const bool ok = 64 * i + 2 * lane < C;
        lw[i] = ok ? *reinterpret_cast<const float2*>(ln_w + 64 * i + 2 * lane) : make_float2(0.f, 0.f);
        lb[i] = ok ? *reinterpret_cast<const float2*>(ln_b + 64 * i + 2 * lane) : make_float2(0.f, 0.f);
      }
      mbar_wait(pfull, loads & 1);
      ++loads;
      for (int r0 = 2 * warp; r0 < PR; r0 += 2 * CONSUMERS / 32) {
        uint8_t* row[2];
        float2 v[2][KB];
        float s[2] = {0.f, 0.f}, q[2] = {0.f, 0.f};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + h;
          row[h] = xp + r * 128 + (((lane >> 2) ^ (r & 7)) * 16 + (lane & 3) * 4);
#pragma unroll
          for (int i = 0; i < KB; ++i) {
            v[h][i] = 64 * i + 2 * lane < C
                          ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                row[h] + (size_t)i * PR * 128))
                          : make_float2(0.f, 0.f);
            s[h] += v[h][i].x + v[h][i].y;
          }
        }
        float mu[2], rstd[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) mu[h] = warp_sum(s[h]) / (float)C;
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < KB; ++i)
            if (64 * i + 2 * lane < C) {
              const float d0 = v[h][i].x - mu[h], d1 = v[h][i].y - mu[h];
              q[h] += __fmul_rn(d0, d0) + __fmul_rn(d1, d1);
            }
#pragma unroll
        for (int h = 0; h < 2; ++h) rstd[h] = rsqrtf(warp_sum(q[h]) / (float)C + eps);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int tok = p0 + r0 + h;
#pragma unroll
          for (int i = 0; i < KB; ++i)
            if (64 * i + 2 * lane < C) {
              const uint32_t m = pack_bf16(ln_affine(v[h][i].x, mu[h], rstd[h], lw[i].x, lb[i].x),
                                           ln_affine(v[h][i].y, mu[h], rstd[h], lw[i].y, lb[i].y));
              *reinterpret_cast<uint32_t*>(row[h] + (size_t)i * PR * 128) = m;
              if (tok < n_tokens)
                *reinterpret_cast<uint32_t*>(m_g + (size_t)tok * C + 64 * i + 2 * lane) = m;
            }
        }
      }
      if (!Cfg::STREAM && kmul) {
        for (int r = warp; r < PR; r += CONSUMERS / 32) {
          const int tok = p0 + r;
          const float k = tok < n_tokens ? kmul[tok / hw] : 0.f;
          uint8_t* row = yp + r * 128 + (((lane >> 2) ^ (r & 7)) * 16 + (lane & 3) * 4);
#pragma unroll
          for (int i = 0; i < KB; ++i)
            if (64 * i + 2 * lane < C) {
              uint32_t* a = reinterpret_cast<uint32_t*>(row + (size_t)i * PR * 128);
              const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a));
              const uint32_t y = pack_bf16(k * f.x, k * f.y);
              *a = y;
              if (dyk_g && tok < n_tokens)
                *reinterpret_cast<uint32_t*>(dyk_g + (size_t)tok * C + 64 * i + 2 * lane) = y;
            }
        }
      }
      fence_async_smem();
      named_sync(1, CONSUMERS);
    }

    // the chunk: a1 = LN2 W1[h0 .. h0 + HN]^T and dg = dyk W2[:, h0 ..] over
    // K = C, this warpgroup's 64 rows and 64 columns of each
    const int hc = c * HN + cw;  // this warpgroup's first hidden column
    // the partial db1 pair this lane adds to: column block g of the 8
    const float2 prev = *reinterpret_cast<const float2*>(prow + hc + 8 * g + 2 * t);
    float a1[32], dg[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) a1[e] = dg[e] = 0.f;
    for (int kb = 0; kb < KB; ++kb) {
      const uint8_t* s = take();
      const uint8_t* ya = Cfg::STREAM ? s + 2 * Cfg::W_BYTES : yp + (size_t)kb * PR * 128 + rbase * 128;
      const uint8_t* xa = xp + (size_t)kb * PR * 128 + rbase * 128;
      wg_fence();
      fence_regs(a1);
      fence_regs(dg);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (4 * kb + kk >= Cfg::KS16) break;
        wgmma_m64n64_ss<0, 0>(a1, desc_sw128(xa + kk * 32, 16, ATOM),
                              desc_sw128(s + cw * 128 + kk * 32, 16, ATOM));
        wgmma_m64n64_ss<0, 1>(dg, desc_sw128(ya + kk * 32, 16, ATOM),
                              desc_sw128(s + Cfg::W_BYTES + (cw / 64) * BOX_BYTES + kk * 2048,
                                         BOX_BYTES, ATOM));
      }
      wg_commit();
      fence_regs(a1);
      fence_regs(dg);
      committed();
    }
    drain();
    fence_regs(a1);
    fence_regs(dg);

    // + b1, GELU and GELU' from one erf; da1 = dg GELU'(a1). Element
    // (16 (warp % 4) + g + 8 hr, 8 j + 2 t + e) of the warpgroup's tile is
    // a1[4 j + 2 hr + e]. db1 of the warp's 16 rows: the two rows of the
    // thread, then a shuffle tree over g; lane g adds column block g.
    const int r0 = p0 + rbase + 16 * (warp & 3) + g;
    float2 mine = make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = hc + 8 * j + 2 * t;
      const float2 bv = *reinterpret_cast<const float2*>(b1 + col);
      float2 cs = make_float2(0.f, 0.f);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int tok = r0 + 8 * hr;
        float g0, g1, d0, d1;
        gelu_and_grad(a1[4 * j + 2 * hr] + bv.x, g0, d0);
        gelu_and_grad(a1[4 * j + 2 * hr + 1] + bv.y, g1, d1);
        d0 *= dg[4 * j + 2 * hr];
        d1 *= dg[4 * j + 2 * hr + 1];
        cs.x += d0;
        cs.y += d1;
        if (tok < n_tokens) {
          const size_t off = (size_t)tok * hidden + col;
          *reinterpret_cast<uint32_t*>(g_g + off) = pack_bf16(g0, g1);
          *reinterpret_cast<uint32_t*>(da1_g + off) = pack_bf16(d0, d1);
        }
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        cs.x += __shfl_xor_sync(0xffffffffu, cs.x, o);
        cs.y += __shfl_xor_sync(0xffffffffu, cs.y, o);
      }
      if (g == j) mine = cs;
    }
    *reinterpret_cast<float2*>(prow + hc + 8 * g + 2 * t) = make_float2(prev.x + mine.x, prev.y + mine.y);
  }
  if (cur >= 0) mbar_arrive(pempty);
}

__global__ void __launch_bounds__(THREADS, 2)
swin_mlp_bwd_mm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                       float* __restrict__ out, int M, int N, int K) {
  rows_mm_body(&ta, &tb, out, M, N, K);
}

template <int C>
__global__ void __launch_bounds__(RP_THREADS)
swin_mlp_bwd_rows_kernel(const bf16* __restrict__ h1, const bf16* __restrict__ dy,
                         const float* __restrict__ kmul, const float* __restrict__ dm,
                         const float* __restrict__ ln_w, bf16* __restrict__ dh1,
                         float* __restrict__ part, int L, int col0, int n_tokens, int hw,
                         float eps) {
  ln_bwd_rows_body<C>(h1, dy, kmul, dm, ln_w, dh1, part, L, col0, n_tokens, eps,
                      RowMap{0, 0, 0, hw});
}

template <int C>
static int launch_mlp_bwd(const void* h1, const void* dy, const void* kmul, void* dh1,
                          const void* ln_w, const void* ln_b, const void* w1, const void* b1,
                          const void* w2, void* m_g, void* g_g, void* dyk_g, void* da1_g,
                          void* part, void* dm_ws, int n_tokens, int hidden, int hw, int stages,
                          int grid, float eps, cudaStream_t stream) {
  using Cfg = MlpBwdCfg<C>;
  const long units = (long)((n_tokens + Cfg::PR - 1) / Cfg::PR) * (hidden / Cfg::HN);
  const size_t smem = mlp_bwd_smem<C>(stages);
  if (hidden % Cfg::HN || (Cfg::STREAM && kmul) || grid < 1 || grid > units || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int L = hidden + 3 * C;
  float* part_f = static_cast<float*>(part);
  CUtensorMap mh, my, m1, m2;
  const uint64_t dx[2] = {(uint64_t)C, (uint64_t)n_tokens};
  const uint64_t d1[2] = {(uint64_t)C, (uint64_t)hidden}, d2[2] = {(uint64_t)hidden, (uint64_t)C};
  const uint32_t bx[2] = {BOX, (uint32_t)Cfg::PR}, b1x[2] = {BOX, (uint32_t)Cfg::HN},
                 b2x[2] = {BOX, BOX};
  int err = make_tensor_map(&mh, h1, 2, dx, bx);
  if (!err) err = make_tensor_map(&my, dy, 2, dx, bx);
  if (!err) err = make_tensor_map(&m1, w1, 2, d1, b1x);
  if (!err) err = make_tensor_map(&m2, w2, 2, d2, b2x);
  if (err) return err;
  auto kernel = swin_mlp_bwd_chunk_kernel<C>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, smem, stream>>>(
      mh, my, m1, m2, static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
      static_cast<const float*>(b1), static_cast<const float*>(kmul), static_cast<bf16*>(m_g),
      static_cast<bf16*>(g_g), static_cast<bf16*>(dyk_g), static_cast<bf16*>(da1_g), part_f,
      n_tokens, hidden, hw, stages, L, eps);
  err = (int)cudaGetLastError();
  if (!err)
    err = launch_rows_mm(swin_mlp_bwd_mm_kernel, da1_g, w1, static_cast<float*>(dm_ws), n_tokens, C,
                         hidden, stream);
  if (!err) {  // a row-pass block for each of the chunk kernel's partial rows
    swin_mlp_bwd_rows_kernel<C><<<grid * Cfg::RPB, RP_THREADS, 0, stream>>>(
        static_cast<const bf16*>(h1), static_cast<const bf16*>(dy), static_cast<const float*>(kmul),
        static_cast<const float*>(dm_ws), static_cast<const float*>(ln_w), static_cast<bf16*>(dh1),
        part_f, L, hidden, n_tokens, hw, eps);
    err = (int)cudaGetLastError();
  }
  return err;
}

}  // namespace hmdt

// C interface for ctypes. Returns the first launch error (0 on success), or
// the error that stopped it before. h1, dy, dh1 (n_tokens, C) bf16 with
// n_tokens a multiple of 64; kmul one float per sample of hw tokens, or null
// (no multiplier; dyk_g is then null too); m_g, dyk_g (n_tokens, C) and g_g,
// da1_g (n_tokens, hidden) bf16; dm_ws (n_tokens, C) f32 scratch; part
// (grid RPB, hidden + 3 C) f32, RPB = 8 at C <= 192, else 4; eps the
// LayerNorm epsilon. The launch plan (ops/swin_plan.py::mlp_bwd_plan):
// panel_rows must be the kernel's for C (a check that the two agree),
// stages the ring's depth, grid the chunk kernel's blocks.
extern "C" int swin_mlp_bwd_launch(const void* h1, const void* dy, const void* kmul, void* dh1,
                                   const void* ln_w, const void* ln_b, const void* w_fc1,
                                   const void* b_fc1, const void* w_fc2, void* m_g, void* g_g,
                                   void* dyk_g, void* da1_g, void* part, void* dm_ws, int n_tokens,
                                   int C, int hidden, int hw, int panel_rows, int stages, int grid,
                                   float eps, void* stream) {
  using namespace hmdt;
  if (n_tokens <= 0 || n_tokens % 64 || hidden != 4 * C || hw <= 0 || stages < 2 || stages > 8 ||
      (!kmul && dyk_g))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HMDT_MLP_BWD_CASE(CC)                                                                   \
  case CC:                                                                                      \
    if (panel_rows != MlpBwdCfg<CC>::PR) return (int)cudaErrorInvalidValue;                     \
    return launch_mlp_bwd<CC>(h1, dy, kmul, dh1, ln_w, ln_b, w_fc1, b_fc1, w_fc2, m_g, g_g,     \
                              dyk_g, da1_g, part, dm_ws, n_tokens, hidden, hw, stages, grid,    \
                              eps, s);
  switch (C) {
    HMDT_MLP_BWD_CASE(96)
    HMDT_MLP_BWD_CASE(192)
    HMDT_MLP_BWD_CASE(384)
    HMDT_MLP_BWD_CASE(768)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HMDT_MLP_BWD_CASE
}
