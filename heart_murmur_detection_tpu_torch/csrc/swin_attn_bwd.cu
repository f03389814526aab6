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
//   - one float32 partial row per block: [dbias (heads, 64, 64) | db_qkv
//     (3 heads 32) | db_proj (C) | dLN1 w (C) | dLN1 b (C)], the sums over
//     the block's windows, summed later in block order by swin_reduce. No
//     atomics: the block owns its row, each element has one owner thread.
//
// Design. A block walks a contiguous run of `wpb` windows. Per window: LN1
// (statistics kept) into shared memory, k1 dh1 as bf16, do = dw W_proj (WMMA,
// K = C) into shared memory as bf16; then per head: q, k, v recomputed as the
// forward computes them (hd padded to 32 with zero weight rows, q scaled by
// the bf16 constant), the scores and dP = do_h v^T (K = 32), one warp a row
// for the softmax and dS (P stays in registers in float32; its bf16 copy and
// dS feed the products), then o_pre, dv, dq and dk (K = 64) into a float32
// tile whose column sums and bf16 copy go out. After the heads, dh =
// dqkv W_qkv (K = 3 heads 32, A read back from the rows this block just
// wrote) lands in float32 over LN1(x) and do, and the LN backward runs one
// warp a token. The cyclic shift of a shifted block is in the addressing, as
// in swin_attn.cu. At C = 384 the shared memory holds 222 KB of the 227.
//
// Bound on this card: ~30 C^2 + 1.4 C heads 32 FLOPs a token against ~14 C
// bytes of traffic, so the products dominate; this first version runs the
// heads of a window one after another on one block, bound by the latency of
// the weight reads from L2 and by WMMA issue with small tiles.
#include "swin_common.cuh"

namespace hmdt {

template <int C>
struct AttnBwdSmem {
  static constexpr int LDX = C + PAD;      // bf16 rows: LN1(x), do, k1 dh1
  static constexpr int LDF = C + 4;        // f32 rows of dh (over LN1(x) and do)
  static constexpr int LDH = HDP + PAD;    // bf16 rows of q, k, v, do_h
  static constexpr int LDS = NTOK + 4;     // f32 rows of the scores and dP
  static constexpr int LDP = NTOK + PAD;   // bf16 rows of P and dS
  static constexpr int LDQ = 3 * HDP + 4;  // f32 rows of dq | dk | dv
  static constexpr int MAX_CP = 2 * C;     // heads * 32 <= 2 C (hd >= 16)
  static constexpr size_t XN = (size_t)NTOK * LDX * 2;
  static constexpr size_t HB = (size_t)NTOK * LDH * 2;
  static constexpr size_t SF = (size_t)NTOK * LDS * 4;
  static constexpr size_t PB = (size_t)NTOK * LDP * 2;
  static constexpr size_t DQ = (size_t)NTOK * LDQ * 4;
  static constexpr size_t STAGE = (size_t)NWARPS * 256 * 4;
  static constexpr size_t COLS = (size_t)(3 * MAX_CP + 3 * C) * 4;
  static constexpr size_t off_xn = 0;
  static constexpr size_t off_do = XN;
  static constexpr size_t off_head = 2 * XN;  // per-head scratch; k1 dh1 before the heads
  static constexpr size_t off_q = off_head;
  static constexpr size_t off_k = off_q + HB;
  static constexpr size_t off_v = off_k + HB;
  static constexpr size_t off_doh = off_v + HB;
  static constexpr size_t off_s = off_doh + HB;
  static constexpr size_t off_dp = off_s + SF;
  static constexpr size_t off_pb = off_dp + SF;
  static constexpr size_t off_dsb = off_pb + PB;
  static constexpr size_t off_dq = off_dsb + PB;
  static constexpr size_t off_stage = off_dq + DQ;
  static constexpr size_t off_cols = off_stage + STAGE;
  static constexpr size_t off_stats = off_cols + COLS;
  static constexpr size_t bytes = off_stats + 2 * NTOK * 4;
  static_assert((size_t)NTOK * LDF * 4 <= 2 * XN, "dh must fit over LN1(x) and do");
  static_assert(XN <= off_stage - off_head, "k1 dh1 must fit in the per-head scratch");
  static_assert(XN % 128 == 0 && HB % 128 == 0 && SF % 128 == 0 && PB % 128 == 0 &&
                    DQ % 128 == 0 && COLS % 128 == 0,
                "shared-memory regions must stay 128-byte aligned");
  static_assert(bytes <= SMEM_LIMIT, "shared memory over the sm_90 limit");
};

template <int C>
__global__ void __launch_bounds__(NTHREADS, 1)
swin_attn_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dh1,
                     const float* __restrict__ kmul, bf16* __restrict__ dx,
                     const bf16* __restrict__ w_qkv, const float* __restrict__ b_qkv,
                     const bf16* __restrict__ w_proj, const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b, const float* __restrict__ bias,
                     const float* __restrict__ mask, bf16* __restrict__ h_g,
                     bf16* __restrict__ dw_g, bf16* __restrict__ opre_g,
                     bf16* dqkv_g,  // written, then read back by this block
                     float* __restrict__ part, int H, int W, int heads, int shift,
                     int n_win, int wpb) {
  using L = AttnBwdSmem<C>;
  constexpr int PER = C / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xn = reinterpret_cast<bf16*>(smem + L::off_xn);
  bf16* dob = reinterpret_cast<bf16*>(smem + L::off_do);
  float* dhf = reinterpret_cast<float*>(smem + L::off_xn);  // after the heads
  bf16* dwb = reinterpret_cast<bf16*>(smem + L::off_head);  // before the heads
  bf16* qs = reinterpret_cast<bf16*>(smem + L::off_q);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::off_k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::off_v);
  bf16* doh = reinterpret_cast<bf16*>(smem + L::off_doh);
  float* sf = reinterpret_cast<float*>(smem + L::off_s);
  float* dpf = reinterpret_cast<float*>(smem + L::off_dp);
  bf16* pb = reinterpret_cast<bf16*>(smem + L::off_pb);
  bf16* dsb = reinterpret_cast<bf16*>(smem + L::off_dsb);
  float* dqf = reinterpret_cast<float*>(smem + L::off_dq);
  float* cols = reinterpret_cast<float*>(smem + L::off_cols);
  float* mu = reinterpret_cast<float*>(smem + L::off_stats);
  float* rstd = mu + NTOK;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* stage = reinterpret_cast<float*>(smem + L::off_stage) + warp * 256;
  const int hd = C / heads;
  const int Cp = heads * HDP;
  const int Cp3 = 3 * Cp;
  const int nww = W / WIN;
  const int nws = (H / WIN) * nww;  // windows a clip
  const float qscale = __bfloat162float(__float2bfloat16(1.0f / sqrtf((float)hd)));
  const size_t nbias = (size_t)heads * NTOK * NTOK;
  float* pbias = part + (size_t)blockIdx.x * (nbias + Cp3 + 3 * C);

  // this block's sums: bias in its partial row, [db_qkv | db_proj | dLN1 w |
  // dLN1 b] in shared memory; every element has one owner thread
  for (size_t i = threadIdx.x; i < nbias; i += NTHREADS) pbias[i] = 0.f;
  for (int i = threadIdx.x; i < Cp3 + 3 * C; i += NTHREADS) cols[i] = 0.f;
  __syncthreads();

  const int w_end = min(n_win, (int)(blockIdx.x + 1) * wpb);
  for (int w = blockIdx.x * wpb; w < w_end; ++w) {
    const int b = w / nws;
    const int win = w % nws;  // window index in the rolled frame
    const int wi = win / nww;
    const int wj = win % nww;
    const size_t row0 = (size_t)w * NTOK;  // first operand row of this window
    const float k1 = kmul[b];
    const float* mask_w = mask ? mask + (size_t)win * NTOK * NTOK : nullptr;
    auto tok_off = [&](int t) -> size_t {
      const int r = (wi * WIN + t / WIN + shift) % H;
      const int c = (wj * WIN + t % WIN + shift) % W;
      return (((size_t)b * H + r) * W + c) * C;
    };

    // 1. LN1(x) -> xn with its statistics; dw = k1 dh1 -> dwb, db_proj sums
    for (int t = warp; t < NTOK; t += NWARPS)
      ln_token<C>(x + tok_off(t), ln_w, ln_b, xn + t * L::LDX, lane, mu + t, rstd + t);
    for (int c = threadIdx.x; c < C; c += NTHREADS) {
      float s = 0.f;
      for (int t = 0; t < NTOK; ++t) {
        const float v = k1 * __bfloat162float(dh1[tok_off(t) + c]);
        s += v;
        dwb[t * L::LDX + c] = __float2bfloat16(v);
      }
      cols[Cp3 + c] += s;
    }
    __syncthreads();
    copy_rows_out(xn, L::LDX, h_g + row0 * C, NTOK, C);
    copy_rows_out(dwb, L::LDX, dw_g + row0 * C, NTOK, C);

    // 2. do = dw W_proj (64 x C, K = C) -> dob (bf16)
    constexpr int NCT = C / 16;
    constexpr int PG = row_group(4, NCT);
    for (int u = warp; u < NCT * (4 / PG); u += NWARPS) {
      const int n0 = (u % NCT) * 16;
      const int rt0 = (u / NCT) * PG;
      FragC acc[PG];
#pragma unroll
      for (int r = 0; r < PG; ++r) wmma::fill_fragment(acc[r], 0.f);
#pragma unroll 2
      for (int k0 = 0; k0 < C; k0 += 16) {
        FragBr bw;
        wmma::load_matrix_sync(bw, w_proj + (size_t)k0 * C + n0, C);
#pragma unroll
        for (int r = 0; r < PG; ++r) {
          FragA a;
          wmma::load_matrix_sync(a, dwb + (rt0 + r) * 16 * L::LDX + k0, L::LDX);
          wmma::mma_sync(acc[r], a, bw, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < PG; ++r) {
        wmma::store_matrix_sync(stage, acc[r], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32)
          dob[((rt0 + r) * 16 + e / 16) * L::LDX + n0 + e % 16] = __float2bfloat16(stage[e]);
        __syncwarp();
      }
    }
    __syncthreads();  // dob complete; the per-head scratch (dwb) is free

    for (int h = 0; h < heads; ++h) {
      // 3a. q, k, v of head h as the forward computes them: 6 column tiles of
      // 16 (q, k, v times two halves of 32), each against all 4 row tiles
      for (int u = warp; u < 6; u += NWARPS) {
        const int which = u / 2;  // 0 q, 1 k, 2 v
        const int ct = u % 2;
        const int n0 = which * Cp + h * HDP + ct * 16;
        FragC acc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) wmma::fill_fragment(acc[r], 0.f);
#pragma unroll 2
        for (int k0 = 0; k0 < C; k0 += 16) {
          FragBc bw;
          wmma::load_matrix_sync(bw, w_qkv + (size_t)n0 * C + k0, C);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            FragA a;
            wmma::load_matrix_sync(a, xn + r * 16 * L::LDX + k0, L::LDX);
            wmma::mma_sync(acc[r], a, bw, acc[r]);
          }
        }
        bf16* dst = which == 0 ? qs : (which == 1 ? ks : vs);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          wmma::store_matrix_sync(stage, acc[r], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int c = e % 16;
            bf16 v = __float2bfloat16(stage[e] + b_qkv[n0 + c]);
            if (which == 0) v = __float2bfloat16(__bfloat162float(v) * qscale);
            dst[(r * 16 + e / 16) * L::LDH + ct * 16 + c] = v;
          }
          __syncwarp();
        }
      }
      // 3b. do_h: the head's hd columns of do, zero padded to 32
      for (int i = threadIdx.x; i < NTOK * HDP; i += NTHREADS) {
        const int r = i / HDP;
        const int d = i % HDP;
        doh[r * L::LDH + d] = d < hd ? dob[r * L::LDX + h * hd + d] : __float2bfloat16(0.f);
      }
      __syncthreads();

      // 3c. scores q k^T -> sf and dP = do_h v^T -> dpf (64 x 64, K = 32)
      for (int tile = warp; tile < 32; tile += NWARPS) {
        const bool second = tile >= 16;
        const int rt = (tile % 16) / 4;
        const int ct = tile % 4;
        const bf16* A = second ? doh : qs;
        const bf16* Bm = second ? vs : ks;
        FragC acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int k0 = 0; k0 < HDP; k0 += 16) {
          FragA a;
          FragBc bk;
          wmma::load_matrix_sync(a, A + rt * 16 * L::LDH + k0, L::LDH);
          wmma::load_matrix_sync(bk, Bm + ct * 16 * L::LDH + k0, L::LDH);
          wmma::mma_sync(acc, a, bk, acc);
        }
        wmma::store_matrix_sync((second ? dpf : sf) + rt * 16 * L::LDS + ct * 16, acc,
                                L::LDS, wmma::mem_row_major);
      }
      __syncthreads();

      // 3d. one warp a row: P = softmax(S + bias (+ mask)) in f32 -> pb (bf16);
      // dS = P (dP - rowsum(dP P)) -> dsb (bf16) and the bias sums (f32)
      const float* bias_h = bias + (size_t)h * NTOK * NTOK;
      float* pbias_h = pbias + (size_t)h * NTOK * NTOK;
      for (int r = warp; r < NTOK; r += NWARPS) {
        float a0 = sf[r * L::LDS + lane] + bias_h[r * NTOK + lane];
        float a1 = sf[r * L::LDS + lane + 32] + bias_h[r * NTOK + lane + 32];
        if (mask_w) {
          a0 += mask_w[r * NTOK + lane];
          a1 += mask_w[r * NTOK + lane + 32];
        }
        const float m = warp_max(fmaxf(a0, a1));
        const float e0 = expf(a0 - m);
        const float e1 = expf(a1 - m);
        const float s = warp_sum(e0 + e1);
        const float p0 = e0 / s;
        const float p1 = e1 / s;
        pb[r * L::LDP + lane] = __float2bfloat16(p0);
        pb[r * L::LDP + lane + 32] = __float2bfloat16(p1);
        const float d0 = dpf[r * L::LDS + lane];
        const float d1 = dpf[r * L::LDS + lane + 32];
        const float dot = warp_sum(p0 * d0 + p1 * d1);
        const float s0 = p0 * (d0 - dot);
        const float s1 = p1 * (d1 - dot);
        dsb[r * L::LDP + lane] = __float2bfloat16(s0);
        dsb[r * L::LDP + lane + 32] = __float2bfloat16(s1);
        pbias_h[r * NTOK + lane] += s0;
        pbias_h[r * NTOK + lane + 32] += s1;
      }
      __syncthreads();

      // 3e. 32 tiles of 16 x 16 (K = 64): o_pre = P v (8, out to opre_g),
      // dv = P^T do_h, dq = dS k * qscale, dk = dS^T q_scaled (8 each, to dqf)
      for (int tile = warp; tile < 32; tile += NWARPS) {
        const int kind = tile / 8;
        const int rt = (tile % 8) / 2;
        const int ct = tile % 2;
        FragC acc;
        wmma::fill_fragment(acc, 0.f);
        if (kind == 0 || kind == 2) {  // row-major A: P or dS
          const bf16* A = kind == 0 ? pb : dsb;
          const bf16* Bm = kind == 0 ? vs : ks;
#pragma unroll
          for (int k0 = 0; k0 < NTOK; k0 += 16) {
            FragA a;
            FragBr bv;
            wmma::load_matrix_sync(a, A + rt * 16 * L::LDP + k0, L::LDP);
            wmma::load_matrix_sync(bv, Bm + k0 * L::LDH + ct * 16, L::LDH);
            wmma::mma_sync(acc, a, bv, acc);
          }
        } else {  // transposed A: P^T or dS^T
          const bf16* A = kind == 1 ? pb : dsb;
          const bf16* Bm = kind == 1 ? doh : qs;
#pragma unroll
          for (int k0 = 0; k0 < NTOK; k0 += 16) {
            FragAc a;
            FragBr bv;
            wmma::load_matrix_sync(a, A + k0 * L::LDP + rt * 16, L::LDP);
            wmma::load_matrix_sync(bv, Bm + k0 * L::LDH + ct * 16, L::LDH);
            wmma::mma_sync(acc, a, bv, acc);
          }
        }
        if (kind == 0) {
          wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int c = ct * 16 + e % 16;
            if (c < hd)
              opre_g[(row0 + rt * 16 + e / 16) * C + h * hd + c] = __float2bfloat16(stage[e]);
          }
          __syncwarp();
        } else {
          if (kind == 2)
            for (int i = 0; i < acc.num_elements; ++i) acc.x[i] *= qscale;
          const int col = (kind == 2 ? 0 : (kind == 3 ? HDP : 2 * HDP)) + ct * 16;
          wmma::store_matrix_sync(dqf + rt * 16 * L::LDQ + col, acc, L::LDQ,
                                  wmma::mem_row_major);
        }
      }
      __syncthreads();

      // 3f. db_qkv sums of the head's 96 columns (token order), and their bf16
      // copy -> dqkv_g in the padded layout
      if (threadIdx.x < 3 * HDP) {
        const int j = threadIdx.x;
        float s = 0.f;
        for (int t = 0; t < NTOK; ++t) s += dqf[t * L::LDQ + j];
        cols[(j / HDP) * Cp + h * HDP + j % HDP] += s;
      }
      for (int i = threadIdx.x; i < NTOK * 3 * HDP; i += NTHREADS) {
        const int r = i / (3 * HDP);
        const int j = i % (3 * HDP);
        dqkv_g[(row0 + r) * Cp3 + (j / HDP) * Cp + h * HDP + j % HDP] =
            __float2bfloat16(dqf[r * L::LDQ + j]);
      }
      __syncthreads();
    }

    // 4. dh = dqkv W_qkv (64 x C, K = 3 Cp; A is this window's dqkv_g rows)
    // -> dhf (f32, over LN1(x) and do)
    for (int u = warp; u < NCT * (4 / PG); u += NWARPS) {
      const int n0 = (u % NCT) * 16;
      const int rt0 = (u / NCT) * PG;
      FragC acc[PG];
#pragma unroll
      for (int r = 0; r < PG; ++r) wmma::fill_fragment(acc[r], 0.f);
#pragma unroll 2
      for (int k0 = 0; k0 < Cp3; k0 += 16) {
        FragBr bw;
        wmma::load_matrix_sync(bw, w_qkv + (size_t)k0 * C + n0, C);
#pragma unroll
        for (int r = 0; r < PG; ++r) {
          FragA a;
          wmma::load_matrix_sync(a, dqkv_g + (row0 + (rt0 + r) * 16) * Cp3 + k0, Cp3);
          wmma::mma_sync(acc[r], a, bw, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < PG; ++r)
        wmma::store_matrix_sync(dhf + (rt0 + r) * 16 * L::LDF + n0, acc[r], L::LDF,
                                wmma::mem_row_major);
    }
    __syncthreads();

    // 5. dLN1 sums (one thread a column); dx = dh1 + LN1 backward (one warp a token)
    for (int c = threadIdx.x; c < C; c += NTHREADS) {
      float sw = 0.f, sb = 0.f;
      for (int t = 0; t < NTOK; ++t) {
        const float xh = (__bfloat162float(x[tok_off(t) + c]) - mu[t]) * rstd[t];
        const float d = dhf[t * L::LDF + c];
        sw += d * xh;
        sb += d;
      }
      cols[Cp3 + C + c] += sw;
      cols[Cp3 + 2 * C + c] += sb;
    }
    for (int t = warp; t < NTOK; t += NWARPS) {
      const size_t off = tok_off(t);
      float xh[PER], dxh[PER];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int c = lane + 32 * i;
        xh[i] = (__bfloat162float(x[off + c]) - mu[t]) * rstd[t];
        dxh[i] = dhf[t * L::LDF + c] * ln_w[c];
        s1 += dxh[i];
        s2 += dxh[i] * xh[i];
      }
      const float m1 = warp_sum(s1) / (float)C;
      const float m2 = warp_sum(s2) / (float)C;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int c = lane + 32 * i;
        dx[off + c] = __float2bfloat16(__bfloat162float(dh1[off + c]) +
                                       rstd[t] * (dxh[i] - m1 - xh[i] * m2));
      }
    }
    __syncthreads();
  }
  // 6. this block's column sums -> its partial row, after the bias sums
  for (int i = threadIdx.x; i < Cp3 + 3 * C; i += NTHREADS) pbias[nbias + i] = cols[i];
}

template <int C>
static cudaError_t launch_attn_bwd(const void* x, const void* dh1, const void* kmul,
                                   void* dx, const void* w_qkv, const void* b_qkv,
                                   const void* w_proj, const void* ln_w,
                                   const void* ln_b, const void* bias,
                                   const void* mask, void* h_g, void* dw_g,
                                   void* opre_g, void* dqkv_g, void* part, int B,
                                   int H, int W, int heads, int shift, int wpb,
                                   cudaStream_t stream) {
  const size_t smem = AttnBwdSmem<C>::bytes;
  auto kernel = swin_attn_bwd_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_win = B * (H / WIN) * (W / WIN);
  const int grid = (n_win + wpb - 1) / wpb;
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dh1),
      static_cast<const float*>(kmul), static_cast<bf16*>(dx),
      static_cast<const bf16*>(w_qkv), static_cast<const float*>(b_qkv),
      static_cast<const bf16*>(w_proj), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<bf16*>(h_g), static_cast<bf16*>(dw_g),
      static_cast<bf16*>(opre_g), static_cast<bf16*>(dqkv_g), static_cast<float*>(part),
      H, W, heads, shift, n_win, wpb);
  return cudaGetLastError();
}

}  // namespace hmdt

// C interface for ctypes. Returns cudaGetLastError() after the launch (0 on
// success). x, dh1, dx (B, H, W, C) bf16; kmul B floats; mask (nW, 64, 64)
// f32 or null; h_g, dw_g, opre_g (B H W, C) and dqkv_g (B H W, 3 heads 32)
// bf16; part (ceil(nW B / wpb), heads 4096 + 3 heads 32 + 3 C) f32.
extern "C" int swin_attn_bwd_launch(const void* x, const void* dh1, const void* kmul,
                                    void* dx, const void* w_qkv, const void* b_qkv,
                                    const void* w_proj, const void* ln_w,
                                    const void* ln_b, const void* bias,
                                    const void* mask, void* h_g, void* dw_g,
                                    void* opre_g, void* dqkv_g, void* part, int B,
                                    int H, int W, int C, int heads, int shift, int wpb,
                                    void* stream) {
  using namespace hmdt;
  if (B <= 0 || H % WIN || W % WIN || heads <= 0 || C % heads || C / heads > HDP ||
      heads * HDP > 2 * C || shift < 0 || shift >= WIN || wpb <= 0 || !kmul)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HMDT_ATTN_BWD_CASE(CC)                                                     \
  case CC:                                                                         \
    return (int)launch_attn_bwd<CC>(x, dh1, kmul, dx, w_qkv, b_qkv, w_proj, ln_w,  \
                                    ln_b, bias, mask, h_g, dw_g, opre_g, dqkv_g,   \
                                    part, B, H, W, heads, shift, wpb, s);
  switch (C) {
    HMDT_ATTN_BWD_CASE(96)
    HMDT_ATTN_BWD_CASE(192)
    HMDT_ATTN_BWD_CASE(384)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HMDT_ATTN_BWD_CASE
}
