// swin_attn_bwd: backward of the attention half of an HTS-AT training swin
// block, h1 = x + k1[b] * attn(x) over 8x8 windows of x (B, H, W, C) bf16,
// given dh1: dx = dh1 + LN1^T(dh), with per window and head
//   dw = k1 dh1,  do = dw W_proj,  dP = do_h v^T,  dv = P^T do_h,
//   dS = P (dP - rowsum(dP P)),  dq = dS k / sqrt(hd),  dk = dS^T q_scaled,
//   dh = [dq | dk | dv] W_qkv.
//
// Replaces the attention half of the TPU backward, `_bwd_attn_kernel`
// (heart_murmur_detection_tpu/ops/pallas_swin_train.py:320) of
// fused_swin_block_train (:606, K8).
//
// Outputs, besides dx:
//   - the per-token operands of the two weight products, bf16 rows in window
//     order: h_g = LN1(x), dw_g = k1 dh1, opre_g = the attention output
//     before proj (hd real columns a head), dqkv_g = [dq | dk | dv] in the
//     padded qkv layout (zero padded columns); swin_wgrad.cu forms
//     dW_qkv = dqkv^T LN1(x) and dW_proj = dw^T o_pre from them;
//   - float32 partial rows [dbias (heads, 64, 64) | db_qkv (3 heads 32) |
//     db_proj (C) | dLN1 w (C) | dLN1 b (C)], summed later in row order by
//     swin_reduce: RPB (4, 2, 1 at C = 96, 192, 384) a window-kernel block,
//     the first with its dbias and db_qkv over its windows in order, the
//     others zeros there; the last 3 C columns of each are one row-pass
//     block's (its run of tiles in order). A persistent grid's rows, not one
//     a block of a 512-block grid as before: at C = 384, 36 MB a call
//     instead of 70. No atomics: every element of a row has one owner.
//
// Bound on this card: ~14 C^2 + 768 C operations a token (the qkv recompute,
// do and dh, head dims unpadded, and the six window products) against
// ~6 C bytes in and out, so the operations bind; the design's own traffic
// (the operand rows, 12 C bytes a token, and dh's float32 round trip) is of
// the same size. Design: four grid launches on the caller's stream (one
// call), each kernel named swin_attn_bwd_* so that a profile groups them:
//  1. swin_attn_bwd_wpt_kernel: W_proj's columns regrouped by head into the
//     K-major rows that a head's do_h = dw W_proj[:, head] needs (heads x 32
//     rows of C, zero padded from hd = 24), a few microseconds.
//  2. swin_attn_bwd_window_kernel: one producer warp and two consumer
//     warpgroups; a persistent block walks a contiguous run of windows, the
//     warpgroups on two heads at a time. Per window, LN1(x) and dw = k1 dh1
//     are computed once into 128-byte-swizzled K-major panels (their rows
//     also go out as h_g and dw_g); the cyclic shift stays in the
//     addressing. Per head, a TMA ring brings the head's q, k, v rows of
//     W_qkv and its 32 rows of W_proj^T (16 KB): qkv_h (m64n96 over K = C,
//     the forward's rounding points) and do_h (m64n32 over K = C) on
//     wgmma. q and do_h stay in registers as A operands; k and v go to one
//     K-major tile ([k | v], 64 keys), and k^T, v^T, q_scaled^T and do_h^T
//     to a stacked K-major tile. S = q k^T and dP = do_h v^T (m64n64, A
//     from registers), the softmax in registers (times 1 / sum: no IEEE
//     division of denormal exponentials), dS = P (dP - rowsum(dP P)); P and
//     dS rounded into shared tiles, then o_pre = P v and dq = dS k with A
//     from registers, dv = P^T do_h and dk = dS^T q_scaled with A read
//     MN-major from those tiles. dbias is added in place to the block's
//     partial row (its elements owned by the threads that hold them in
//     the score layout), db_qkv by a shuffle tree and four warps in order.
//  3. swin_attn_bwd_mm_kernel: dh = dqkv_g W_qkv (K = 3 heads 32) on the
//     GEMM core of wgmma_gemm.cuh (A K-major, B MN-major), float32 rows in
//     window order: a window's dqkv is 64 x 3 heads 32 bf16, 192 KB at
//     C = 384, so dh cannot be formed from shared memory.
//  4. swin_attn_bwd_rows_kernel: dx = dh1 + LN1^T(dh) at each token's place
//     (the shift undone in the addressing) and the column sums db_proj,
//     dLN1 w, dLN1 b (swin_bwd_common.cuh), a block for each partial row of
//     the window kernel.
// Rounded to bf16 where the plain version (ops/swin_train.py::
// swin_attn_bwd_ref) rounds: LN1(x), q, k, v, q scaled, k1 dh1, do, P, dS,
// o_pre, dq / dk / dv and dx.
#include "swin_bwd_common.cuh"

namespace hmdt {

constexpr int HSTAGE = 4 * HDP * 128;  // a head's ring stage: q, k, v and W_proj^T boxes (16 KB)
// a warpgroup's tiles: [k | v] (64 keys x 128 bytes), [k^T; v^T; q_s^T;
// do^T] (128 rows x 64), P and dS (64 x 64), all K-major, 128-byte swizzled
constexpr int T_KV = 0, T_TT = 8192, T_P = 24576, T_S = 32768, TILES = 40960;

template <int C>
struct AttnBwdCfg {
  // partial rows a block: the first holds the block's dbias and db_qkv, the
  // rest zeros there; each has a row-pass block (more at C <= 192, where
  // the row pass has more tokens to cover)
  static constexpr int RPB = C == 96 ? 4 : C == 192 ? 2 : 1;
  static constexpr int KB = (C + 63) / 64;            // 64-column boxes of K = C
  static constexpr int KS16 = C / 16;                 // k16 steps of K = C
  static constexpr int PANEL = KB * NTOK * 128;       // a window's rows of LN1(x) or dw
  static constexpr int LPR = C == 96 ? 16 : 32;       // lanes of a token in LN1
  static constexpr int NVL = (C / 8 + LPR - 1) / LPR;  // 16-byte vectors of a lane
};

template <int C>
__host__ __device__ constexpr size_t attn_bwd_smem(int stages) {
  return 2 * (size_t)AttnBwdCfg<C>::PANEL + 2 * (size_t)TILES + (size_t)stages * HSTAGE +
         16 * (size_t)stages + 1024;
}

__global__ void swin_attn_bwd_wpt_kernel(const bf16* __restrict__ w_proj, bf16* __restrict__ wpt,
                                         int C, int heads) {
  const int hd = C / heads;
  const long n = (long)heads * HDP * C;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (long)gridDim.x * blockDim.x) {
    const int row = (int)(i / C), c = (int)(i % C), h = row / HDP, d = row % HDP;
    wpt[i] = d < hd ? w_proj[(size_t)c * C + h * hd + d] : __float2bfloat16(0.f);
  }
}

// grid: block b walks windows [b nW / G, (b + 1) nW / G) (nW = B windows a
// clip), the warpgroups on heads 2 s and 2 s + 1. twq: W_qkv (3 heads 32,
// C) and twp: W_proj^T (heads 32, C), both in boxes of 64 x 32. part: one
// row a block, L floats.
template <int C>
__global__ void __launch_bounds__(THREADS, 1)
swin_attn_bwd_window_kernel(const __grid_constant__ CUtensorMap twq,
                            const __grid_constant__ CUtensorMap twp, const bf16* __restrict__ x,
                            const bf16* __restrict__ dh1, const float* __restrict__ kmul,
                            const float* __restrict__ b_qkv, const float* __restrict__ ln_w,
                            const float* __restrict__ ln_b, const float* __restrict__ bias,
                            const float* __restrict__ mask, bf16* __restrict__ h_g,
                            bf16* __restrict__ dw_g, bf16* __restrict__ opre_g,
                            bf16* __restrict__ dqkv_g, float* __restrict__ part, int B, int H,
                            int W, int heads, int shift, int stages, int L) {
  using Cfg = AttnBwdCfg<C>;
  constexpr int KB = Cfg::KB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  uint8_t* panel = base;              // LN1(x)
  uint8_t* dwp = base + Cfg::PANEL;   // k1 dh1
  uint8_t* ring = base + 2 * Cfg::PANEL + 2 * TILES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + (size_t)stages * HSTAGE);
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
  const int hd = C / heads, Cp = heads * HDP, steps = heads / 2;
  const int w_beg = (int)((long)windows * blockIdx.x / gridDim.x);
  const int w_end = (int)((long)windows * (blockIdx.x + 1) / gridDim.x);
  // element offset of token t of window gw (in the rolled frame)
  auto tok_off = [&](int gw, int t) -> size_t {
    const int b = gw / nw, win = gw % nw;
    const int r = ((win / nww) * WIN + t / WIN + shift) % H;
    const int c = ((win % nww) * WIN + t % WIN + shift) % W;
    return (((size_t)b * H + r) * W + c) * C;
  };

  if (tid >= CONSUMERS) {
    if (tid == PRODUCER) {
      int it = 0;
      for (int w = w_beg; w < w_end; ++w)
        for (int s = 0; s < steps; ++s)
          for (int kb = 0; kb < KB; ++kb)
            for (int hh = 0; hh < 2; ++hh) {
              const int h = 2 * s + hh;
              const int st = it % stages;
              mbar_wait(&empty[st], ((it / stages) & 1) ^ 1);
              mbar_expect_tx(&full[st], HSTAGE);
              uint8_t* sb = ring + (size_t)st * HSTAGE;
              for (int which = 0; which < 3; ++which)
                tma_load_2d(sb + which * HDP * 128, &twq, &full[st], kb * BOX, which * Cp + h * HDP);
              tma_load_2d(sb + 3 * HDP * 128, &twp, &full[st], kb * BOX, h * HDP);
              ++it;
            }
    }
    return;
  }

  const int wg = tid / 128, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3) + g;  // this thread's rows r0, r0 + 8 (tokens of the window)
  uint8_t* kv = base + 2 * Cfg::PANEL + wg * TILES + T_KV;
  uint8_t* tt = kv - T_KV + T_TT;
  uint8_t* pt = kv - T_KV + T_P;
  uint8_t* st_ = kv - T_KV + T_S;
  float* scr = reinterpret_cast<float*>(pt);  // the db_qkv sums of the 4 warps, once P is read
  const float qscale = round_bf16(1.0f / sqrtf((float)hd));
  float* prow = part + (size_t)blockIdx.x * Cfg::RPB * L;
  const int own = heads * NTOK * NTOK + 3 * Cp;  // this kernel's columns of a row
  for (int i = tid; i < (Cfg::RPB - 1) * own; i += CONSUMERS)
    prow[(size_t)(1 + i / own) * L + i % own] = 0.f;

  // the ring, in the producer's order: stage 2 (kb + KB s) + wg of a window
  // is this warpgroup's; it takes two arrivals of each of its threads, and
  // the other warpgroup steps over it
  int it = 0, pending = -1;
  auto take = [&]() -> const uint8_t* {
    const int st = it % stages;
    mbar_wait(&full[st], (it / stages) & 1);
    return ring + (size_t)st * HSTAGE;
  };
  auto committed = [&]() {
    wg_wait<1>();
    if (pending >= 0) mbar_arrive_cnt(&empty[pending], 2);
    pending = it % stages;
    ++it;
  };
  auto drain = [&]() {
    wg_wait<0>();
    if (pending >= 0) mbar_arrive_cnt(&empty[pending], 2);
    pending = -1;
  };

  for (int w = w_beg; w < w_end; ++w) {
    const bool first = w == w_beg;
    const size_t row0 = (size_t)w * NTOK;  // first operand row of this window
    // 1. LN1(x) -> panel and h_g, k1 dh1 -> dwp and dw_g: LPR lanes a token,
    // lane l of a token takes the 16-byte vectors l, l + LPR, ... of its C
    // channels (x and dh1 read together); both warpgroups are done with the
    // last window's panels
    named_sync(1, CONSUMERS);
    {
      constexpr int LPR = Cfg::LPR, NVL = Cfg::NVL, NV = C / 8;
      constexpr int RSTEP = (CONSUMERS / 32) * (32 / LPR), PF = 4;
      static_assert(NTOK % (PF * RSTEP) == 0, "whole groups of tokens");
      const int sub = lane % LPR;
      float lw[NVL][8], lb[NVL][8];
#pragma unroll
      for (int i = 0; i < NVL; ++i) {
        const int vi = sub + LPR * i;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          lw[i][e] = vi < NV ? ln_w[8 * vi + e] : 0.f;
          lb[i][e] = vi < NV ? ln_b[8 * vi + e] : 0.f;
        }
      }
      const float k1 = kmul[w / nw];
      for (int rb = warp * (32 / LPR) + lane / LPR; rb < NTOK; rb += PF * RSTEP) {
        // the x and dh1 rows of PF tokens, every load issued first
        int4 raw[PF][NVL], rawd[PF][NVL];
#pragma unroll
        for (int p = 0; p < PF; ++p) {
          const size_t off = tok_off(w, rb + p * RSTEP);
#pragma unroll
          for (int i = 0; i < NVL; ++i) {
            const int vi = sub + LPR * i;
            raw[p][i] = vi < NV ? *reinterpret_cast<const int4*>(x + off + 8 * vi) : make_int4(0, 0, 0, 0);
            rawd[p][i] = vi < NV ? *reinterpret_cast<const int4*>(dh1 + off + 8 * vi) : make_int4(0, 0, 0, 0);
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
            uint4 packed, dpk;
            uint32_t* pw = reinterpret_cast<uint32_t*>(&packed);
            uint32_t* dw = reinterpret_cast<uint32_t*>(&dpk);
            const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&rawd[p][i]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              pw[e] = pack_bf16(ln_affine(v[i][2 * e], mu, rstd, lw[i][2 * e], lb[i][2 * e]),
                                ln_affine(v[i][2 * e + 1], mu, rstd, lw[i][2 * e + 1],
                                          lb[i][2 * e + 1]));
              const float2 f = __bfloat1622float2(d2[e]);
              dw[e] = pack_bf16(k1 * f.x, k1 * f.y);
            }
            const uint32_t so = sw_off(r, 8 * vi, NTOK);
            *reinterpret_cast<uint4*>(panel + so) = packed;
            *reinterpret_cast<uint4*>(h_g + (row0 + r) * C + 8 * vi) = packed;
            *reinterpret_cast<uint4*>(dwp + so) = dpk;
            *reinterpret_cast<uint4*>(dw_g + (row0 + r) * C + 8 * vi) = dpk;
          }
        }
      }
    }
    fence_async_smem();
    named_sync(1, CONSUMERS);

    const float* mask_w = mask ? mask + (size_t)(w % nw) * NTOK * NTOK : nullptr;

    // 2. the heads, two at a time: warpgroup wg takes head 2 s + wg
    for (int s = 0; s < steps; ++s) {
      const int h = 2 * s + wg;
      // the head's rel-pos bias plus the window's mask, loaded while its
      // products run (the mask's 0 and -100 make score + (bias + mask)
      // the plain version's (score + bias) + mask up to an ulp of a masked
      // logit, whose probability is below 1e-40). Element (r0 + 8 hr,
      // 8 j + 2 t + e) of a 64 x 64 tile is s[4 j + 2 hr + e]
      const float* bias_h = bias + (size_t)h * NTOK * NTOK;
      float2 bb[16];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int e = (r0 + 8 * hr) * NTOK + 8 * j + 2 * t;
          bb[2 * j + hr] = __ldg(reinterpret_cast<const float2*>(bias_h + e));
          if (mask_w) {
            const float2 mv = __ldg(reinterpret_cast<const float2*>(mask_w + e));
            bb[2 * j + hr].x += mv.x;
            bb[2 * j + hr].y += mv.y;
          }
        }
      // qkv_h = LN1 W_qkv[head]^T (m64n96) and do_h = dw W_proj^T[head]^T
      // (m64n32), K = C
      float acc[48], dacc[16];
#pragma unroll
      for (int e = 0; e < 48; ++e) acc[e] = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) dacc[e] = 0.f;
      for (int kb = 0; kb < KB; ++kb) {
        it += wg;
        const uint8_t* sb = take();
        wg_fence();
        fence_regs(acc);
        fence_regs(dacc);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (4 * kb + kk >= Cfg::KS16) break;
          const size_t ka = (size_t)kb * NTOK * 128 + kk * 32;
          wgmma_m64n96_ss<0, 0>(acc, desc_sw128(panel + ka, 16, ATOM), desc_sw128(sb + kk * 32, 16, ATOM));
          wgmma_m64n32_ss<0, 0>(dacc, desc_sw128(dwp + ka, 16, ATOM),
                                desc_sw128(sb + 3 * HDP * 128 + kk * 32, 16, ATOM));
        }
        wg_commit();
        fence_regs(acc);
        fence_regs(dacc);
        committed();
        it += 1 - wg;
      }
      drain();
      fence_regs(acc);
      fence_regs(dacc);
      // the block's dbias and db_qkv partials of this head, read now and
      // added to once this head's sums are known
      float* pdb = prow + (size_t)h * NTOK * NTOK;
      float2 old[16];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          old[2 * j + hr] = first ? make_float2(0.f, 0.f)
                                  : *reinterpret_cast<const float2*>(pdb + (r0 + 8 * hr) * NTOK + 8 * j + 2 * t);
      const int wt = tid & 127;
      float* pqkv = prow + (size_t)heads * NTOK * NTOK + (wt / HDP) * Cp + h * HDP + wt % HDP;
      const float oldq = first || wt >= 3 * HDP ? 0.f : *pqkv;
      // + b_qkv, rounded; q scaled and rounded again. Element (r0 + 8 hr,
      // 8 j + 2 t + e) of the 64 x 96 tile is acc[4 j + 2 hr + e]: columns
      // 0-31 q, 32-63 k, 64-95 v. q and do_h into the A fragments of S and
      // dP; k, v into [k | v]; k^T, v^T, q_s^T, do^T into the stack
      uint32_t qa[2][4], da[2][4];
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
            const uint32_t qp = pack_bf16(v0 * qscale, v1 * qscale);
            qa[(j % 4) / 2][2 * (j & 1) + hr] = qp;
            const __nv_bfloat162 q2 = *reinterpret_cast<const __nv_bfloat162*>(&qp);
            *reinterpret_cast<bf16*>(tt + sw_off(64 + d, r, 128)) = q2.x;
            *reinterpret_cast<bf16*>(tt + sw_off(65 + d, r, 128)) = q2.y;
          } else {
            const int o = which == 1 ? 0 : 32;  // k, v: columns of [k | v], rows of the stack
            *reinterpret_cast<uint32_t*>(kv + sw_off(r, o + d, NTOK)) = pack_bf16(v0, v1);
            *reinterpret_cast<bf16*>(tt + sw_off(o + d, r, 128)) = __float2bfloat16(v0);
            *reinterpret_cast<bf16*>(tt + sw_off(o + d + 1, r, 128)) = __float2bfloat16(v1);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = 8 * j + 2 * t;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = r0 + 8 * hr;
          const uint32_t dp2 = pack_bf16(dacc[4 * j + 2 * hr], dacc[4 * j + 2 * hr + 1]);
          da[j / 2][2 * (j & 1) + hr] = dp2;
          const __nv_bfloat162 d2 = *reinterpret_cast<const __nv_bfloat162*>(&dp2);
          *reinterpret_cast<bf16*>(tt + sw_off(96 + d, r, 128)) = d2.x;
          *reinterpret_cast<bf16*>(tt + sw_off(97 + d, r, 128)) = d2.y;
        }
      }
      fence_async_smem();
      named_sync(2 + wg, 128);

      // 3. S = q k^T and dP = do_h v^T (K = 32, A from registers)
      float sc[32], dp[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = dp[e] = 0.f;
      wg_fence();
      fence_regs(sc);
      fence_regs(dp);
      wgmma_m64n64_rs<0>(sc, qa[0], desc_sw128(kv, 16, ATOM));
      wgmma_m64n64_rs<0>(sc, qa[1], desc_sw128(kv + 32, 16, ATOM));
      wgmma_m64n64_rs<0>(dp, da[0], desc_sw128(kv + 64, 16, ATOM));
      wgmma_m64n64_rs<0>(dp, da[1], desc_sw128(kv + 96, 16, ATOM));
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // 4. + bias[h] (+ mask), the softmax in float32, P; dS = P (dP -
      // rowsum(dP P)); the block's dbias partial += dS
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          sc[4 * j + 2 * hr] += bb[2 * j + hr].x;
          sc[4 * j + 2 * hr + 1] += bb[2 * j + hr].y;
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float m = sc[2 * hr];
#pragma unroll
        for (int j = 0; j < 8; ++j) m = fmaxf(m, fmaxf(sc[4 * j + 2 * hr], sc[4 * j + 2 * hr + 1]));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        float l = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float ev = expf(sc[4 * j + 2 * hr + e] - m);
            sc[4 * j + 2 * hr + e] = ev;
            l += ev;
          }
        // times 1 / sum rather than divided: the masked scores' exp (about
        // e^-100) are denormal, and IEEE division takes its slow path on them
        const float inv = 1.f / quad_sum(l);
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hr + e;
            sc[i] *= inv;
            rs += sc[i] * dp[i];
          }
        rs = quad_sum(rs);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * hr + e;
            dp[i] = sc[i] * (dp[i] - rs);
          }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<float2*>(pdb + (r0 + 8 * hr) * NTOK + 8 * j + 2 * t) =
              make_float2(old[2 * j + hr].x + dp[4 * j + 2 * hr], old[2 * j + hr].y + dp[4 * j + 2 * hr + 1]);
      uint32_t pa[4][4], sa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // register q of k16 step kk: column block j = 2 kk + q / 2, row half q % 2
          const int j = 2 * kk + q / 2, hr = q % 2, i = 4 * j + 2 * hr;
          pa[kk][q] = pack_bf16(sc[i], sc[i + 1]);
          sa[kk][q] = pack_bf16(dp[i], dp[i + 1]);
          const uint32_t o = sw_off(r0 + 8 * hr, 8 * j + 2 * t, NTOK);
          *reinterpret_cast<uint32_t*>(pt + o) = pa[kk][q];
          *reinterpret_cast<uint32_t*>(st_ + o) = sa[kk][q];
        }
      fence_async_smem();
      named_sync(2 + wg, 128);

      // 5. o_pre = P v and dq = dS k (A from registers), dv = P^T do_h and
      // dk = dS^T q_s (A MN-major from the P and dS tiles), K = 64 each
      float o[16], dq[16], dv[16], dk[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) o[e] = dq[e] = dv[e] = dk[e] = 0.f;
      wg_fence();
      fence_regs(o);
      fence_regs(dq);
      fence_regs(dv);
      fence_regs(dk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n32_rs<0>(o, pa[kk], desc_sw128(tt + 32 * 128 + kk * 32, 16, ATOM));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n32_rs<0>(dq, sa[kk], desc_sw128(tt + kk * 32, 16, ATOM));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n32_ss<1, 0>(dv, desc_sw128(pt + kk * 2048, BOX_BYTES, ATOM),
                              desc_sw128(tt + 96 * 128 + kk * 32, 16, ATOM));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n32_ss<1, 0>(dk, desc_sw128(st_ + kk * 2048, BOX_BYTES, ATOM),
                              desc_sw128(tt + 64 * 128 + kk * 32, 16, ATOM));
      wg_commit();
      wg_wait<0>();
      fence_regs(o);
      fence_regs(dq);
      fence_regs(dv);
      fence_regs(dk);

      // 6. o_pre's hd real columns and [dq | dk | dv] (dq times the scale,
      // all 32 columns: the padded ones are exact zeros) out as bf16 rows;
      // db_qkv of the window: the thread's two rows, a shuffle tree over g,
      // then the four warps in order (their sums parked over the P tile)
      const int Cp3 = 3 * Cp;
      float2 cs[3][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = 8 * j + 2 * t;
#pragma unroll
        for (int q = 0; q < 3; ++q) cs[q][j] = make_float2(0.f, 0.f);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const size_t grow = row0 + r0 + 8 * hr;
          const int i = 4 * j + 2 * hr;
          if (d < hd)
            *reinterpret_cast<uint32_t*>(opre_g + grow * C + h * hd + d) = pack_bf16(o[i], o[i + 1]);
          const float2 vq = make_float2(dq[i] * qscale, dq[i + 1] * qscale);
          const float2 vk = make_float2(dk[i], dk[i + 1]), vv = make_float2(dv[i], dv[i + 1]);
          bf16* dst = dqkv_g + grow * Cp3 + h * HDP + d;
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(vq.x, vq.y);
          *reinterpret_cast<uint32_t*>(dst + Cp) = pack_bf16(vk.x, vk.y);
          *reinterpret_cast<uint32_t*>(dst + 2 * Cp) = pack_bf16(vv.x, vv.y);
          cs[0][j].x += vq.x;
          cs[0][j].y += vq.y;
          cs[1][j].x += vk.x;
          cs[1][j].y += vk.y;
          cs[2][j].x += vv.x;
          cs[2][j].y += vv.y;
        }
      }
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int ofs = 4; ofs < 32; ofs <<= 1) {
            cs[q][j].x += __shfl_xor_sync(0xffffffffu, cs[q][j].x, ofs);
            cs[q][j].y += __shfl_xor_sync(0xffffffffu, cs[q][j].y, ofs);
          }
      if (g == 0)
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float2*>(scr + (warp & 3) * 96 + q * HDP + 8 * j + 2 * t) = cs[q][j];
      named_sync(2 + wg, 128);
      if (wt < 3 * HDP) *pqkv = oldq + (((scr[wt] + scr[96 + wt]) + scr[192 + wt]) + scr[288 + wt]);
    }
    drain();
  }
}

__global__ void __launch_bounds__(THREADS, 2)
swin_attn_bwd_mm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                        float* __restrict__ out, int M, int N, int K) {
  rows_mm_body(&ta, &tb, out, M, N, K);
}

template <int C>
__global__ void __launch_bounds__(RP_THREADS)
swin_attn_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dh1,
                          const float* __restrict__ kmul, const float* __restrict__ dh,
                          const float* __restrict__ ln_w, bf16* __restrict__ dx,
                          float* __restrict__ part, int L, int col0, int n_rows, int H, int W,
                          int shift) {
  ln_bwd_rows_body<C>(x, dh1, kmul, dh, ln_w, dx, part, L, col0, n_rows, 1e-5f,
                      RowMap{H, W, shift, 1});
}

template <int C>
static int launch_attn_bwd(const void* x, const void* dh1, const void* kmul, void* dx,
                           const void* w_qkv, const void* b_qkv, const void* w_proj,
                           const void* ln_w, const void* ln_b, const void* bias, const void* mask,
                           void* h_g, void* dw_g, void* opre_g, void* dqkv_g, void* part,
                           void* dh_ws, void* wpt_ws, int B, int H, int W, int heads, int shift,
                           int stages, int grid, cudaStream_t stream) {
  const int windows = B * (H / WIN) * (W / WIN);
  const int Cp = heads * HDP, n = windows * NTOK;
  const size_t smem = attn_bwd_smem<C>(stages);
  if (heads % 2 || grid < 1 || grid > windows || smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int L = heads * NTOK * NTOK + 3 * Cp + 3 * C;
  float* part_f = static_cast<float*>(part);
  const int wpt_n = Cp * C;
  swin_attn_bwd_wpt_kernel<<<(wpt_n + 255) / 256 < 1024 ? (wpt_n + 255) / 256 : 1024, 256, 0, stream>>>(
      static_cast<const bf16*>(w_proj), static_cast<bf16*>(wpt_ws), C, heads);
  int err = (int)cudaGetLastError();
  if (err) return err;
  CUtensorMap mq, mp;
  const uint64_t dq[2] = {(uint64_t)C, (uint64_t)3 * Cp}, dp[2] = {(uint64_t)C, (uint64_t)Cp};
  const uint32_t bq[2] = {BOX, (uint32_t)HDP};
  err = make_tensor_map(&mq, w_qkv, 2, dq, bq);
  if (!err) err = make_tensor_map(&mp, wpt_ws, 2, dp, bq);
  if (err) return err;
  auto kernel = swin_attn_bwd_window_kernel<C>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, smem, stream>>>(
      mq, mp, static_cast<const bf16*>(x), static_cast<const bf16*>(dh1),
      static_cast<const float*>(kmul), static_cast<const float*>(b_qkv),
      static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
      static_cast<const float*>(bias), static_cast<const float*>(mask), static_cast<bf16*>(h_g),
      static_cast<bf16*>(dw_g), static_cast<bf16*>(opre_g), static_cast<bf16*>(dqkv_g), part_f, B,
      H, W, heads, shift, stages, L);
  err = (int)cudaGetLastError();
  if (!err)
    err = launch_rows_mm(swin_attn_bwd_mm_kernel, dqkv_g, w_qkv, static_cast<float*>(dh_ws), n, C,
                         3 * Cp, stream);
  if (!err) {  // a row-pass block for each of the window kernel's partial rows
    swin_attn_bwd_rows_kernel<C><<<grid * AttnBwdCfg<C>::RPB, RP_THREADS, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dh1), static_cast<const float*>(kmul),
        static_cast<const float*>(dh_ws), static_cast<const float*>(ln_w), static_cast<bf16*>(dx),
        part_f, L, heads * NTOK * NTOK + 3 * Cp, n, H, W, shift);
    err = (int)cudaGetLastError();
  }
  return err;
}

}  // namespace hmdt

// C interface for ctypes. Returns the first launch error (0 on success), or
// the error that stopped it before. x, dh1, dx (B, H, W, C) bf16; kmul B
// floats; w_qkv (3 heads 32, C) bf16 in the padded layout, b_qkv its f32
// bias; w_proj (C, C) bf16; mask (nW, 64, 64) f32 or null; h_g, dw_g, opre_g
// (B H W, C) and dqkv_g (B H W, 3 heads 32) bf16; dh_ws (B H W, C) f32 and
// wpt_ws (heads 32, C) bf16 scratch; part (grid RPB, heads 4096 + 3 heads
// 32 + 3 C) f32, RPB = 4, 2, 1 at C = 96, 192, 384. The launch plan (ops/swin_plan.py::attn_bwd_plan): stages the
// ring's depth, grid the window kernel's blocks.
extern "C" int swin_attn_bwd_launch(const void* x, const void* dh1, const void* kmul, void* dx,
                                    const void* w_qkv, const void* b_qkv, const void* w_proj,
                                    const void* ln_w, const void* ln_b, const void* bias,
                                    const void* mask, void* h_g, void* dw_g, void* opre_g,
                                    void* dqkv_g, void* part, void* dh_ws, void* wpt_ws, int B,
                                    int H, int W, int C, int heads, int shift, int stages,
                                    int grid, void* stream) {
  using namespace hmdt;
  if (B <= 0 || H <= 0 || W <= 0 || H % WIN || W % WIN || heads <= 0 || C % heads ||
      C / heads > HDP || (C / heads) % 8 || shift < 0 || shift >= WIN || stages < 2 ||
      stages > 8 || !kmul)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HMDT_ATTN_BWD_CASE(CC)                                                                 \
  case CC:                                                                                     \
    return launch_attn_bwd<CC>(x, dh1, kmul, dx, w_qkv, b_qkv, w_proj, ln_w, ln_b, bias, mask, \
                               h_g, dw_g, opre_g, dqkv_g, part, dh_ws, wpt_ws, B, H, W, heads, \
                               shift, stages, grid, s);
  switch (C) {
    HMDT_ATTN_BWD_CASE(96)
    HMDT_ATTN_BWD_CASE(192)
    HMDT_ATTN_BWD_CASE(384)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HMDT_ATTN_BWD_CASE
}
