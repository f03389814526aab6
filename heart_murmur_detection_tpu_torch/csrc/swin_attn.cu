// swin_attn: the attention half of an HTS-AT swin block,
//   h1 = x + k[b] * (proj(concat_h softmax(q_h k_h^T / sqrt(hd) + bias_h (+ mask)) v_h) + b_proj),
//   q, k, v = LN1(x) W_qkv + b_qkv, over 8x8 windows of x (B, H, W, C) bf16;
//   k is an optional per-sample multiplier (DropPath keep multipliers of the
//   training forward); without it (null) the eval block, k = 1.
//
// Replaces the attention body `_strip_attn` (heart_murmur_detection_tpu/ops/
// pallas_swin.py:97) that the TPU kernels fused_swin_block (:480),
// fused_swin_pair (:847) and fused_swin_block_split (:618, attention half)
// run, and the attention half of the training forward `_train_fwd_kernel`
// (ops/pallas_swin_train.py:233, K8). As in the TPU body, q, k, v, the
// scores, P and the head outputs never leave the chip.
//
// Bound on this card: about 8 C^2 + 256 C operations a token (qkv with hd
// padded to 32, the window products, proj) against 4 C bytes, so the
// operations bind; W_qkv and W_proj (0.1 to 1.8 MB) stay in L2 and are read
// once a block. Design (wgmma_gemm.cuh's pieces; one producer warp and two
// consumer warpgroups a block):
//  - a block owns two windows at C <= 192 (128 token rows, a warpgroup a
//    window, both on the same head at a time, so each W_qkv / W_proj box fed
//    by TMA serves 128 rows), or one window at C >= 384 (the warpgroups take
//    two heads at a time, then split proj's output columns). Where the
//    windows alone would leave the card idle (the plan of ops/swin_plan.py,
//    from the grid and the SM count), the heads of a window spread over a
//    cluster of cs blocks; C = 768 always takes cs >= 2, whose head outputs
//    fit beside the 96 KB LN1 panel.
//  - LN1: 16 or 32 lanes a token, four tokens' loads in flight at once, the
//    token's C channels read as 16-byte vectors at its place in x: the
//    cyclic shift stays in the addressing, token (r, c)
//    of rolled window (i, j) being x[(8i+r+s) mod H, (8j+c+s) mod W], and
//    the mask is indexed by (i, j) in the rolled frame. Float32 statistics,
//    rounded to bf16 into the 128-byte-swizzle K-major A panel.
//  - qkv of a head: m64n96 wgmma (q, k, v of the head, hd padded to 32 with
//    zero weight rows: three TMA boxes of 32 rows a 64-column step of K;
//    columns past C = 96 or 192 of the last box read as zeros and are never
//    multiplied). + b_qkv and one rounding to bf16, then q times the bf16
//    constant hd^-0.5, rounded again: the plain version's points. q stays in
//    registers as the A operand of the scores; k goes to shared memory as a
//    K-major B tile (64 keys), v transposed as a K-major B tile (32 dims).
//  - S = q k^T (m64n64, A from registers), + bias[h] (+ mask[window]; both
//    read into registers while the head's qkv product runs), the
//    softmax in registers (row max and sum over the quad of threads that
//    holds a row), P rounded to bf16 as the register A operand of P V
//    (m64n32). fast_softmax: e = exp(s) unnormalised, P v times 1 / sum(e).
//  - o: the hd real columns of each head, rounded to bf16, into a 64 x C A
//    panel; with a cluster, each block's heads are gathered from the other
//    blocks' shared memory (16-byte copies) into the freed LN1 panel.
//  - proj (m64n96 or m64n48 over K = C, W_proj streamed by TMA), + b_proj,
//    times k, + x (read while the product runs), one rounding, written at
//    the token's place in x as 4-byte column pairs from the accumulator.
//  - no atomics; every sum has one order, so two launches agree bitwise.
#include "swin_common.cuh"
#include "vit_attn_common.cuh"
#include "wgmma_gemm.cuh"

namespace hmdt {

using namespace hop;

constexpr int QKV_ROWS = 3 * HDP;                // q, k, v rows of a head in W_qkv
constexpr int HEADBUF = NTOK * 128 + HDP * 128;  // k (64 keys) and v^T (32 dims): 12 KB

template <int C, int WPB>
struct AttnCfg {
  static constexpr int ROWS = NTOK * WPB;        // token rows of the block
  static constexpr int KB = (C + 63) / 64;       // 64-column boxes of K = C
  static constexpr int KS16 = C / 16;            // k16 steps of K = C
  static constexpr int HPS = WPB == 2 ? 1 : 2;   // heads of a qkv stage
  static constexpr int STAGE = HPS * QKV_ROWS * 128;
  static constexpr int PANEL = KB * ROWS * 128;
  static constexpr int LPR = C == 96 ? 16 : 32;  // lanes of a token in LN1
  static constexpr int NVL = (C / 8 + LPR - 1) / LPR;  // 16-byte vectors of a lane
};

// Layout of the dynamic shared memory (from a 1024-byte boundary): the LN1
// panel, the head outputs o (the block's C / cs columns), the two
// warpgroups' k / v^T tiles, the ring, its barriers.
template <int C, int WPB>
__host__ __device__ constexpr size_t attn_o_bytes(int cs) {
  return (size_t)((C / cs + 63) / 64) * AttnCfg<C, WPB>::ROWS * 128;
}
template <int C, int WPB>
__host__ __device__ constexpr size_t attn_smem_bytes(int cs, int stages) {
  return (size_t)AttnCfg<C, WPB>::PANEL + attn_o_bytes<C, WPB>(cs) + 2 * HEADBUF +
         (size_t)stages * AttnCfg<C, WPB>::STAGE + 16 * (size_t)stages + 1024;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Byte offset of element (r, c) in a 128-byte-swizzle K-major panel of
// `rows` rows (boxes of 64 columns).
__device__ __forceinline__ uint32_t sw_off(int r, int c, int rows) {
  return (uint32_t)((c >> 6) * rows * 128 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
                    (c & 7) * 2);
}

// grid: blockIdx.x = window group (two windows, or one) * cs + rank, in
// clusters of cs blocks. twq: W_qkv (3 heads 32, C) in boxes of 64 x 32;
// twp: W_proj (C, C) in boxes of 64 x (PW, or 2 PW at one window a block).
template <int C, int WPB, int PW>
__global__ void __launch_bounds__(THREADS, 1)
swin_attn_kernel(const __grid_constant__ CUtensorMap twq, const __grid_constant__ CUtensorMap twp,
                 const bf16* __restrict__ x, bf16* __restrict__ out,
                 const float* __restrict__ b_qkv, const float* __restrict__ b_proj,
                 const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                 const float* __restrict__ bias, const float* __restrict__ mask,
                 const float* __restrict__ kmul, int B, int H, int W, int heads, int shift,
                 int fast_softmax, int cs, int stages) {
  using Cfg = AttnCfg<C, WPB>;
  constexpr int ROWS = Cfg::ROWS, KB = Cfg::KB;
  constexpr int PROWS = WPB == 2 ? PW : 2 * PW;  // W_proj rows a stage
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  uint8_t* panel = base;
  uint8_t* obuf = panel + Cfg::PANEL;
  uint8_t* headbuf = obuf + attn_o_bytes<C, WPB>(cs);
  uint8_t* ring = headbuf + 2 * HEADBUF;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)stages * Cfg::STAGE);
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int nww = W / WIN, nw = (H / WIN) * nww, windows = B * nw;
  const int hd = C / heads, Cp = heads * HDP, hpb = heads / cs;
  const int rank = (int)(blockIdx.x % cs);
  const int group = (int)(blockIdx.x / cs);
  const int cb = C / cs;  // output columns of the block, and its head columns
  // element offset of token t of global window gw (in the rolled frame)
  auto tok_off = [&](int gw, int t) -> size_t {
    const int b = gw / nw, win = gw % nw;
    const int r = ((win / nww) * WIN + t / WIN + shift) % H;
    const int c = ((win % nww) * WIN + t % WIN + shift) % W;
    return (((size_t)b * H + r) * W + c) * C;
  };

  if (tid >= CONSUMERS) {
    // the producer warp; lane 0 issues every load, the whole warp takes
    // part in the cluster barriers
    const int lane = tid & 31;
    int it = 0;
    auto push = [&](uint32_t bytes) -> uint8_t* {
      const int st = it % stages;
      mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);
      mbar_expect_tx(&full[st], bytes);
      ++it;
      return ring + (size_t)st * Cfg::STAGE;
    };
    if (lane == 0) {
      for (int step = 0; step < hpb / Cfg::HPS; ++step)
        for (int kb = 0; kb < KB; ++kb) {
          const int st = it % stages;
          uint8_t* s = push(Cfg::STAGE);
          for (int hh = 0; hh < Cfg::HPS; ++hh) {
            const int h = rank * hpb + step * Cfg::HPS + hh;
            for (int which = 0; which < 3; ++which)
              tma_load_2d(s + (hh * 3 + which) * HDP * 128, &twq, &full[st], kb * BOX,
                          which * Cp + h * HDP);
          }
        }
    }
    __syncwarp();
    if (cs > 1) cluster_arrive();
    if (lane == 0) {
      for (int pass = 0; pass < cb / PROWS; ++pass)
        for (int kb = 0; kb < KB; ++kb) {
          const int st = it % stages;
          uint8_t* s = push(PROWS * 128);
          tma_load_2d(s, &twp, &full[st], kb * BOX, rank * cb + pass * PROWS);
        }
    }
    __syncwarp();
    if (cs > 1) cluster_wait();
  } else {
    const int wg = tid / 128, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // 1. LN1 of the block's rows into the panel: LPR lanes a token, lane l
    // of a token takes the 16-byte vectors l, l + LPR, ... of its C channels
    {
      constexpr int LPR = Cfg::LPR, NVL = Cfg::NVL, NV = C / 8;
      const int sub = lane % LPR;
      float w[NVL][8], b[NVL][8];
#pragma unroll
      for (int i = 0; i < NVL; ++i) {
        const int vi = sub + LPR * i;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          w[i][e] = vi < NV ? ln_w[8 * vi + e] : 0.f;
          b[i][e] = vi < NV ? ln_b[8 * vi + e] : 0.f;
        }
      }
      // PF tokens a lane group at a time, their loads all issued first
      constexpr int RSTEP = (CONSUMERS / 32) * (32 / LPR), PF = 4;
      static_assert(ROWS % (PF * RSTEP) == 0, "whole groups of tokens");
      for (int rb = warp * (32 / LPR) + lane / LPR; rb < ROWS; rb += PF * RSTEP) {
        int4 raw[PF][NVL];
#pragma unroll
        for (int p = 0; p < PF; ++p) {
          const int r = rb + p * RSTEP;
          const int gw = WPB == 2 ? 2 * group + r / NTOK : group;
          const bool ok = gw < windows;
          const bf16* src = ok ? x + tok_off(gw, r % NTOK) : x;
#pragma unroll
          for (int i = 0; i < NVL; ++i) {
            const int vi = sub + LPR * i;
            raw[p][i] = ok && vi < NV ? *reinterpret_cast<const int4*>(src + 8 * vi)
                                      : make_int4(0, 0, 0, 0);
          }
        }
#pragma unroll
        for (int p = 0; p < PF; ++p) {
          const int r = rb + p * RSTEP;
          float v[NVL][8];
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < NVL; ++i) {
            const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw[p][i]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(p2[e]);
              v[i][2 * e] = f.x;
              v[i][2 * e + 1] = f.y;
              s += f.x + f.y;
            }
          }
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          const float mu = s / (float)C;
          float q = 0.f;
#pragma unroll
          for (int i = 0; i < NVL; ++i)
            if (sub + LPR * i < NV)
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                const float d = v[i][e] - mu;
                q += __fmul_rn(d, d);
              }
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
          const float rstd = rsqrtf(q / (float)C + 1e-5f);
#pragma unroll
          for (int i = 0; i < NVL; ++i) {
            const int vi = sub + LPR * i;
            if (vi >= NV) continue;
            uint4 packed;
            uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              pw[e] = pack_bf16(ln_affine(v[i][2 * e], mu, rstd, w[i][2 * e], b[i][2 * e]),
                                ln_affine(v[i][2 * e + 1], mu, rstd, w[i][2 * e + 1],
                                          b[i][2 * e + 1]));
            *reinterpret_cast<uint4*>(panel + sw_off(r, 8 * vi, ROWS)) = packed;
          }
        }
      }
    }
    fence_async_smem();
    named_sync(1, CONSUMERS);

    // the ring, in the producer's order (as swin_mlp.cu)
    int it = 0, pending = -1;
    auto take = [&]() -> const uint8_t* {
      const int st = it % stages;
      mbar_wait(&full[st], (it / stages) & 1);
      return ring + (size_t)st * Cfg::STAGE;
    };
    auto committed = [&]() {
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

    const int rowoff = WPB == 2 ? NTOK * wg : 0;  // this warpgroup's rows of the panel
    const int gw = WPB == 2 ? 2 * group + wg : group;  // and its window
    const bool valid = gw < windows;
    const int r0 = 16 * (warp & 3) + g;  // its rows r0, r0 + 8 (tokens of the window)
    uint8_t* kbuf = headbuf + wg * HEADBUF;
    uint8_t* vbuf = kbuf + NTOK * 128;
    const float qscale = round_bf16(1.0f / sqrtf((float)hd));
    const float* mask_w = mask && valid ? mask + (size_t)(gw % nw) * NTOK * NTOK : nullptr;
    // element (r0 + 8 hr, 8 j + 2 t + e) of a 64 x 64 score tile is
    // s[4 j + 2 hr + e]; the window's mask in that layout, read once
    float2 mk[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        mk[2 * j + hr] = mask_w ? __ldg(reinterpret_cast<const float2*>(
                                      mask_w + (r0 + 8 * hr) * NTOK + 8 * j + 2 * t))
                                : make_float2(0.f, 0.f);

    // 2. the heads: two windows on one head, or one window on two heads
    for (int step = 0; step < hpb / Cfg::HPS; ++step) {
      const int hl = step * Cfg::HPS + (WPB == 1 ? wg : 0);  // the head among the block's
      const int h = rank * hpb + hl;
      // the head's rel-pos bias, loaded while the qkv product runs
      const float* bias_h = bias + (size_t)h * NTOK * NTOK;
      float2 bb[16];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          bb[2 * j + hr] = __ldg(reinterpret_cast<const float2*>(
              bias_h + (r0 + 8 * hr) * NTOK + 8 * j + 2 * t));
      float acc[48];
#pragma unroll
      for (int e = 0; e < 48; ++e) acc[e] = 0.f;
      for (int kb = 0; kb < KB; ++kb) {
        const uint8_t* sb = take() + (WPB == 1 ? wg * QKV_ROWS * 128 : 0);
        wg_fence();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (4 * kb + kk >= Cfg::KS16) break;
          wgmma_m64n96_ss<0, 0>(
              acc, desc_sw128(panel + (size_t)kb * ROWS * 128 + rowoff * 128 + kk * 32, 16, ATOM),
              desc_sw128(sb + kk * 32, 16, ATOM));
        }
        wg_commit();
        fence_regs(acc);
        committed();
      }
      drain();
      fence_regs(acc);
      // + b_qkv, rounded; q scaled and rounded again into the A fragments
      // of the scores; k and v^T into this warpgroup's tiles. Element
      // (r0 + 8 hr, 8 j + 2 t + e) of the 64 x 96 tile is acc[4 j + 2 hr + e]:
      // columns 0-31 q, 32-63 k, 64-95 v.
      uint32_t qa[2][4];
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const int which = j / 4, d = 8 * (j % 4) + 2 * t;
        const float2 bv = *reinterpret_cast<const float2*>(b_qkv + which * Cp + h * HDP + d);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = r0 + 8 * hr;
          const float v0 = round_bf16(acc[4 * j + 2 * hr] + bv.x);
          const float v1 = round_bf16(acc[4 * j + 2 * hr + 1] + bv.y);
          if (which == 0) {
            qa[j / 2][2 * (j & 1) + hr] = pack_bf16(v0 * qscale, v1 * qscale);
          } else if (which == 1) {
            *reinterpret_cast<uint32_t*>(kbuf + sw_off(r, d, NTOK)) = pack_bf16(v0, v1);
          } else {
            *reinterpret_cast<bf16*>(vbuf + sw_off(d, r, HDP)) = __float2bfloat16(v0);
            *reinterpret_cast<bf16*>(vbuf + sw_off(d + 1, r, HDP)) = __float2bfloat16(v1);
          }
        }
      }
      fence_async_smem();
      named_sync(2 + wg, 128);

      // 3. scores: s = q k^T (K = 32, two k16 steps)
      float s[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = 0.f;
      wg_fence();
      fence_regs(s);
      wgmma_m64n64_rs<0>(s, qa[0], desc_sw128(kbuf, 16, ATOM));
      wgmma_m64n64_rs<0>(s, qa[1], desc_sw128(kbuf + 32, 16, ATOM));
      wg_commit();
      wg_wait<0>();
      fence_regs(s);

      // 4. + bias[h] (+ mask), softmax over each row in float32 -> P (bf16)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          s[4 * j + 2 * hr] += bb[2 * j + hr].x;
          s[4 * j + 2 * hr + 1] += bb[2 * j + hr].y;
          if (mask_w) {
            s[4 * j + 2 * hr] += mk[2 * j + hr].x;
            s[4 * j + 2 * hr + 1] += mk[2 * j + hr].y;
          }
        }
      float scale[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float m = 0.f;
        if (!fast_softmax) {
          m = s[2 * hr];
#pragma unroll
          for (int j = 0; j < 8; ++j) m = fmaxf(m, fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        }
        float l = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float ev = expf(s[4 * j + 2 * hr + e] - m);
            s[4 * j + 2 * hr + e] = ev;
            l += ev;
          }
        // times 1 / sum rather than divided: the masked scores' exp (about
        // e^-100) are denormal, and IEEE division takes its slow path on
        // them (2x the launch time of a shifted block on an H100)
        const float inv = 1.f / quad_sum(l);
        if (fast_softmax) {
          scale[hr] = inv;  // the row sum divides P v instead
        } else {
          scale[hr] = 1.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[4 * j + 2 * hr] *= inv;
            s[4 * j + 2 * hr + 1] *= inv;
          }
        }
      }
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // 5. P v (K = 64 keys), the hd real columns rounded into o
      float o[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) o[e] = 0.f;
      wg_fence();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n32_rs<0>(o, pa[kk], desc_sw128(vbuf + kk * 32, 16, ATOM));
      wg_commit();
      wg_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j) {
        if (8 * j >= hd) break;
        const int oc = hl * hd + 8 * j + 2 * t;  // column among the block's heads
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<uint32_t*>(obuf + sw_off(rowoff + r0 + 8 * hr, oc, ROWS)) =
              pack_bf16(o[4 * j + 2 * hr] * scale[hr], o[4 * j + 2 * hr + 1] * scale[hr]);
      }
      named_sync(2 + wg, 128);  // the tiles are free for the next head
    }

    // 6. proj's A operand: o, or, with a cluster, every block's head
    // columns gathered into the LN1 panel (no longer read)
    const uint8_t* pa_proj = obuf;
    if (cs > 1) {
      cluster_arrive();
      cluster_wait();  // every block's o is complete
      const int nch = cb / 8;  // 16-byte chunks of a row of a block's o
      for (int q = 0; q < cs; ++q) {
        const uint8_t* src = cluster_map(obuf, q);
        for (int i = tid; i < NTOK * nch; i += CONSUMERS) {
          const int r = i / nch, lc = 8 * (i % nch);
          *reinterpret_cast<int4*>(panel + sw_off(r, q * cb + lc, ROWS)) =
              *reinterpret_cast<const int4*>(src + sw_off(r, lc, ROWS));
        }
      }
      pa_proj = panel;
    }
    fence_async_smem();
    named_sync(1, CONSUMERS);

    // 7. proj of the block's output columns, in passes of PROWS (the two
    // warpgroups' rows, or their PW columns each), + b_proj, times k, + x
    const int wgcol = WPB == 1 ? wg * PW : 0;
    size_t roff[2] = {0, 0};
    float kv = 1.f;
    if (valid) {
      roff[0] = tok_off(gw, r0);
      roff[1] = tok_off(gw, r0 + 8);
      if (kmul) kv = kmul[gw / nw];
    }
    for (int pass = 0; pass < cb / PROWS; ++pass) {
      const int c0 = rank * cb + pass * PROWS + wgcol;
      // the residual's x pairs, loaded while the product runs
      __nv_bfloat162 xr[PW / 8][2];
#pragma unroll
      for (int j = 0; j < PW / 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          xr[j][hr] = *reinterpret_cast<const __nv_bfloat162*>(x + roff[hr] + c0 + 8 * j + 2 * t);
      float acc[PW / 2];
#pragma unroll
      for (int e = 0; e < PW / 2; ++e) acc[e] = 0.f;
      for (int kb = 0; kb < KB; ++kb) {
        const uint8_t* sb = take() + wgcol * 128;
        wg_fence();
        fence_regs(acc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (4 * kb + kk >= Cfg::KS16) break;
          const uint64_t da =
              desc_sw128(pa_proj + (size_t)kb * ROWS * 128 + rowoff * 128 + kk * 32, 16, ATOM);
          const uint64_t db = desc_sw128(sb + kk * 32, 16, ATOM);
          if constexpr (PW == 96) wgmma_m64n96_ss<0, 0>(acc, da, db);
          else wgmma_m64n48_ss<0, 0>(acc, da, db);
        }
        wg_commit();
        fence_regs(acc);
        committed();
      }
      drain();
      fence_regs(acc);
      if (!valid) continue;
#pragma unroll
      for (int j = 0; j < PW / 8; ++j) {
        const int c = c0 + 8 * j + 2 * t;
        const float2 bp = *reinterpret_cast<const float2*>(b_proj + c);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const size_t off = roff[hr] + c;
          const float2 xv = __bfloat1622float2(xr[j][hr]);
          *reinterpret_cast<uint32_t*>(out + off) =
              pack_bf16(add_scaled(xv.x, kv, acc[4 * j + 2 * hr] + bp.x),
                        add_scaled(xv.y, kv, acc[4 * j + 2 * hr + 1] + bp.y));
        }
      }
    }
  }
  if (cs > 1) {  // no block leaves while another still reads its o
    cluster_arrive();
    cluster_wait();
  }
}

template <int C, int WPB, int PW>
static int launch_attn(const void* x, void* out, const void* w_qkv, const void* b_qkv,
                       const void* w_proj, const void* b_proj, const void* ln_w, const void* ln_b,
                       const void* bias, const void* mask, const void* kmul, int B, int H, int W,
                       int heads, int shift, int fast_softmax, int cs, int stages,
                       cudaStream_t stream) {
  using Cfg = AttnCfg<C, WPB>;
  constexpr int PROWS = WPB == 2 ? PW : 2 * PW;
  const int hpb = heads / cs;
  // whole head steps and proj passes a block; 16-byte chunks of a block's o
  if (heads % cs || hpb % Cfg::HPS || (C / cs) % PROWS || ((C / heads) * hpb) % 8 ||
      (WPB == 2 && cs != 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = attn_smem_bytes<C, WPB>(cs, stages);
  // the gathered o must fit over the LN1 panel
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mp;
  const uint64_t dq[2] = {(uint64_t)C, (uint64_t)3 * heads * HDP}, dp[2] = {(uint64_t)C, (uint64_t)C};
  const uint32_t bq[2] = {BOX, (uint32_t)HDP}, bp[2] = {BOX, (uint32_t)PROWS};
  int err = make_tensor_map(&mq, w_qkv, 2, dq, bq);
  if (!err) err = make_tensor_map(&mp, w_proj, 2, dp, bp);
  if (err) return err;
  auto kernel = swin_attn_kernel<C, WPB, PW>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long windows = (long)B * (H / WIN) * (W / WIN);
  const long blocks = (windows + WPB - 1) / WPB * cs;
  if (blocks > 2147483647L) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, mq, mp, static_cast<const bf16*>(x),
                         static_cast<bf16*>(out), static_cast<const float*>(b_qkv),
                         static_cast<const float*>(b_proj), static_cast<const float*>(ln_w),
                         static_cast<const float*>(ln_b), static_cast<const float*>(bias),
                         static_cast<const float*>(mask), static_cast<const float*>(kmul), B, H, W,
                         heads, shift, fast_softmax, cs, stages);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace hmdt

// C interface for ctypes. Returns cudaGetLastError() after the launch (0 on
// success), or the error that stopped it before. x and out are distinct
// (B, H, W, C) bf16 buffers; mask and kmul (B floats) may be null. The
// launch plan (ops/swin_plan.py::attn_plan): windows_per_block (2 at
// C <= 192, else 1: a check that the two agree), cs the blocks of a cluster
// over a window's heads, proj_width the output columns of a warpgroup's
// proj pass (96 or 48), stages the ring's depth.
extern "C" int swin_attn_launch(const void* x, void* out, const void* w_qkv, const void* b_qkv,
                                const void* w_proj, const void* b_proj, const void* ln_w,
                                const void* ln_b, const void* bias, const void* mask,
                                const void* kmul, int B, int H, int W, int C, int heads,
                                int shift, int fast_softmax, int windows_per_block, int cs,
                                int proj_width, int stages, void* stream) {
  using namespace hmdt;
  if (B <= 0 || H % WIN || W % WIN || H <= 0 || W <= 0 || heads <= 0 || C % heads ||
      C / heads > HDP || (C / heads) % 8 || shift < 0 || shift >= WIN || cs < 1 || cs > 8 ||
      stages < 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int wpb = C <= 192 ? 2 : 1;
  if (windows_per_block != wpb) return (int)cudaErrorInvalidValue;
#define HMDT_ATTN_CASE(CC, WPB, PW)                                                          \
  if (C == CC && proj_width == PW)                                                           \
    return launch_attn<CC, WPB, PW>(x, out, w_qkv, b_qkv, w_proj, b_proj, ln_w, ln_b, bias,  \
                                    mask, kmul, B, H, W, heads, shift, fast_softmax, cs,     \
                                    stages, s);
  HMDT_ATTN_CASE(96, 2, 96)
  HMDT_ATTN_CASE(192, 2, 96)
  HMDT_ATTN_CASE(384, 1, 96)
  HMDT_ATTN_CASE(384, 1, 48)
  HMDT_ATTN_CASE(768, 1, 96)
  HMDT_ATTN_CASE(768, 1, 48)
#undef HMDT_ATTN_CASE
  return (int)cudaErrorInvalidValue;
}
