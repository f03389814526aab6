// vit_attn_bwd: backward of the attention half of a ViT training block,
//   h1 = x + proj(concat_h softmax(q_h k_h^T, keys >= n_real masked) v_h),
//   [q | k | v] = LN1(x) W_qkv^T + b_qkv (the q rows carry 1/sqrt(hd)),
// given dh1 (B, Np, C) bf16: dx = dh1 + LN1^T(dh), where per clip and head
//   do = dh1 W_proj,  P = softmax(S),  dP = do_h v_h^T,
//   dS = P (dP - rowsum(dP P)),  dq = dS k,  dk = dS^T q,  dv = P^T do_h,
//   dh = [dq | dk | dv] W_qkv.
//
// Replaces the attention half of the TPU backward of the ViT training block,
// `_attn_bwd_core` (heart_murmur_detection_tpu/ops/pallas_vit_train.py:246)
// as the kernels `_bwd_attn_acc_kernel` (:336) and `_bwd_attn_emit_kernel`
// (:364) of fused_vit_block_train (:703, K9) run it.
//
// Outputs, besides dx: the per-token operands of the two weight products,
// bf16 rows h_g = LN1(x), opre_g = the attention output before proj (B Np, C)
// and dqkv_g = [dq | dk | dv] (B Np, 3C), from which swin_wgrad.cu forms
// dW_qkv = dqkv^T LN1(x) and dW_proj = dh1^T o_pre; and one float32 partial
// row per block of the last launch, [db_qkv (3C) | db_proj (C) | dLN1 w (C) |
// dLN1 b (C)], summed later in block order by swin_reduce. No atomics: every
// element is written by one thread, every sum taken by one thread in order.
//
// Design: four launches on the caller's stream (one call of the wrapper).
//  1. prep (64-token tiles x 4): LN1(x) -> h_g and the recomputed q, k, v
//     (rounded as the forward rounds them), and do = dh1 W_proj, both written
//     head-major to scratch, as vit_qkv.cu writes q, k, v.
//  2. query pass (64 query rows of one clip and head a block, 4 warps of 16
//     rows, keys streamed in 64-key tiles as in vit_attn.cu with the scores
//     in mma.sync registers): the row max and sum of exp; then P and
//     dP = do v^T per tile, the row term D = rowsum(P dP) in float32 from the
//     unrounded P, and o_pre = bf16(P) V; then dS = P (dP - D), rounded to
//     bf16, and dq = dS K. It writes o_pre and dq rows and (max, sum, D) per
//     query row. dQ's sum over key tiles stays inside the block, so it needs
//     no atomics.
//  3. key pass (64 key rows a block): walks the query tiles, recomputes
//     P^T = exp(K Q^T - max) / sum and dP^T = V do^T from the row statistics,
//     dS^T = P^T (dP^T - D), and accumulates dv = bf16(P^T) do and
//     dk = bf16(dS^T) q in float32 registers, rounded once.
//  4. dx (contiguous runs of 64-token tiles a block): dh = dqkv W_qkv
//     (K = 3C, WMMA) into float32 shared memory, the column sums, and the LN1
//     backward one warp a token.
// Padded keys (>= n_real) have P exactly 0, so their key tiles are skipped in
// pass 2 and their dk / dv rows are written as zeros; padded query rows take
// part as in the plain version (their dh1 is 0 on the training path, so they
// add exact zeros). K and V of one head at Np = 1040 do not fit in shared
// memory, so both passes stream them; nothing a pass keeps grows with Np.
//
// Bound on this card: per block of n tokens ~14 n C^2 FLOPs for the qkv
// recompute and the do and dh products plus ~10 Np n C for the attention
// products (recompute included), against ~6 n C bytes in and out, so the
// operations bound it. This first version recomputes S three times and dP
// twice, and keeps its products on mma.sync / WMMA without a pipeline.
#include "vit_attn_common.cuh"

namespace hmdt {

constexpr int VT = 64;  // tokens a tile of the row-wise launches (prep, dx)

// LayerNorm statistics of one token's C channels by one warp, in the order
// ln_token computes them; lane 0 writes them.
template <int C>
__device__ __forceinline__ void ln_stats(const bf16* __restrict__ src, int lane, float eps,
                                         float* mu_out, float* rstd_out) {
  constexpr int PER = C / 32;
  float v[PER];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    v[i] = __bfloat162float(src[lane + 32 * i]);
    s += v[i];
  }
  const float mu = warp_sum(s) / (float)C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const float d = v[i] - mu;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / (float)C + eps);
  if (lane == 0) {
    *mu_out = mu;
    *rstd_out = rstd;
  }
}

// ---------------------------------------------------------------------------
// 1. prep: LN1 + q, k, v (blockIdx.y 0..2) and do = dh1 W_proj (blockIdx.y 3)
// ---------------------------------------------------------------------------

template <int C>
struct PrepSmem {
  static constexpr int LDX = C + PAD;
  static constexpr size_t XN = (size_t)VT * LDX * 2;
  static constexpr size_t STAGE = (size_t)NWARPS * 256 * 4;
  static constexpr size_t bytes = XN + STAGE;
  static_assert(XN % 128 == 0, "regions must stay 128-byte aligned");
  static_assert(bytes <= SMEM_LIMIT, "shared memory over the sm_90 limit");
};

template <int C>
__global__ void __launch_bounds__(NTHREADS)
vit_attn_bwd_prep_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dh1,
                         const bf16* __restrict__ w_qkv, const float* __restrict__ b_qkv,
                         const bf16* __restrict__ w_proj, const float* __restrict__ ln_w,
                         const float* __restrict__ ln_b, bf16* __restrict__ h_g,
                         bf16* __restrict__ qkv, bf16* __restrict__ dob, int n_tokens, int Np,
                         int heads, float eps) {
  using L = PrepSmem<C>;
  constexpr int RT = VT / 16;
  constexpr int CT = C / 16;
  constexpr int VEC = C / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xn = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* stage = reinterpret_cast<float*>(smem + L::XN) + warp * 256;
  const int tok0 = blockIdx.x * VT;
  const int which = blockIdx.y;  // 0 q, 1 k, 2 v: LN1(x) W_qkv^T; 3: dh1 W_proj
  const int B = n_tokens / Np;

  if (which < 3) {
    for (int t = warp; t < VT; t += NWARPS) {
      const int tok = tok0 + t;
      if (tok < n_tokens) {
        ln_token<C>(x + (size_t)tok * C, ln_w, ln_b, xn + t * L::LDX, lane, nullptr, nullptr,
                    eps);
      } else {
        for (int c = lane; c < C; c += 32) xn[t * L::LDX + c] = __float2bfloat16(0.f);
      }
    }
  } else {
    for (int i = threadIdx.x; i < VT * VEC; i += NTHREADS) {
      const int r = i / VEC;
      reinterpret_cast<int4*>(xn + r * L::LDX)[i % VEC] =
          tok0 + r < n_tokens
              ? reinterpret_cast<const int4*>(dh1 + (size_t)(tok0 + r) * C)[i % VEC]
              : make_int4(0, 0, 0, 0);
    }
  }
  __syncthreads();
  if (which == 0) copy_rows_out(xn, L::LDX, h_g + (size_t)tok0 * C, min(VT, n_tokens - tok0), C);

  for (int ct = warp; ct < CT; ct += NWARPS) {
    FragC acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) wmma::fill_fragment(acc[r], 0.f);
    if (which < 3) {  // B(k, n) = W_qkv[which C + n][k]
      const bf16* wb = w_qkv + (size_t)(which * C + ct * 16) * C;
#pragma unroll 2
      for (int k0 = 0; k0 < C; k0 += 16) {
        FragBc bw;
        wmma::load_matrix_sync(bw, wb + k0, C);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          FragA a;
          wmma::load_matrix_sync(a, xn + r * 16 * L::LDX + k0, L::LDX);
          wmma::mma_sync(acc[r], a, bw, acc[r]);
        }
      }
    } else {  // B(k, n) = W_proj[k][n]
#pragma unroll 2
      for (int k0 = 0; k0 < C; k0 += 16) {
        FragBr bw;
        wmma::load_matrix_sync(bw, w_proj + (size_t)k0 * C + ct * 16, C);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          FragA a;
          wmma::load_matrix_sync(a, xn + r * 16 * L::LDX + k0, L::LDX);
          wmma::mma_sync(acc[r], a, bw, acc[r]);
        }
      }
    }
    // (+ bias), one rounding, head-major store: column c is head c / 64
    const int h = (ct * 16) / AHD;
    const int d0 = (ct * 16) % AHD;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      wmma::store_matrix_sync(stage, acc[r], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int tok = tok0 + r * 16 + e / 16;
        const int c = e % 16;
        if (tok < n_tokens) {
          const int b = tok / Np;
          const int t = tok % Np;
          if (which < 3) {
            const size_t off = ((((size_t)which * B + b) * heads + h) * Np + t) * AHD + d0 + c;
            qkv[off] = __float2bfloat16(stage[e] + b_qkv[which * C + ct * 16 + c]);
          } else {
            dob[(((size_t)b * heads + h) * Np + t) * AHD + d0 + c] = __float2bfloat16(stage[e]);
          }
        }
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// 2. query pass: row statistics, D, o_pre and dq for 64 query rows
// ---------------------------------------------------------------------------

constexpr int BKT = 64;  // keys (pass 2) or queries (pass 3) a streamed tile
constexpr int BNB = BKT / 8;

// Load the next K and V tiles into shared memory after every warp is done
// with the current ones (the register copies were fetched during the tile).
__device__ __forceinline__ void swap_tiles(bool more, const TileRegs<BKT>& ar, bf16* as,
                                           const TileRegs<BKT>& br, bf16* bs) {
  __syncthreads();  // every warp is done with the current tiles
  if (more) {
    store_tile<BKT>(ar, as);
    store_tile<BKT>(br, bs);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(ATHREADS)
vit_attn_bwd_q_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dob,
                      bf16* __restrict__ opre_g, bf16* __restrict__ dqkv_g,
                      float* __restrict__ stats, int Np, int n_real) {
  __shared__ __align__(128) bf16 ks[BKT * LDT];
  __shared__ __align__(128) bf16 vs[BKT * LDT];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * AQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int heads = gridDim.y;
  const int B = gridDim.z;
  const int C = heads * AHD;
  const size_t hstride = (size_t)Np * AHD;
  const bf16* kh = qkv + ((size_t)(B + b) * heads + h) * hstride;
  const bf16* vh = qkv + ((size_t)(2 * B + b) * heads + h) * hstride;
  const int n_kt = (n_real + BKT - 1) / BKT;  // key tiles holding real keys
  const int row0 = warp * 16 + g;

  uint32_t qa[AHD / 16][4], da[AHD / 16][4];
  load_a_rows(qkv + ((size_t)b * heads + h) * hstride, q0 + warp * 16, Np, g, t, qa);
  load_a_rows(dob + ((size_t)b * heads + h) * hstride, q0 + warp * 16, Np, g, t, da);
  TileRegs<BKT> kr, vr;

  // pass 1: each row's max and sum of exp(s - max), as vit_attn's stable pass
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  fetch_tile<BKT>(kh, 0, Np, kr);
  store_tile<BKT>(kr, ks);
  __syncthreads();
  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) fetch_tile<BKT>(kh, (kt + 1) * BKT, Np, kr);
    float s[BNB][4];
    score_tile<BKT>(qa, ks, kt * BKT, n_real, g, t, s);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float tmax = s[0][2 * hr];
#pragma unroll
      for (int nb = 0; nb < BNB; ++nb) tmax = fmaxf(tmax, fmaxf(s[nb][2 * hr], s[nb][2 * hr + 1]));
      const float mn = fmaxf(m[hr], tmax);
      float e = 0.f;
#pragma unroll
      for (int nb = 0; nb < BNB; ++nb)
        e += expf(s[nb][2 * hr] - mn) + expf(s[nb][2 * hr + 1] - mn);
      l[hr] = l[hr] * expf(m[hr] - mn) + e;
      m[hr] = mn;
    }
    __syncthreads();
    if (kt + 1 < n_kt) {
      store_tile<BKT>(kr, ks);
      __syncthreads();
    }
  }
  merge_row_stats(m[0], l[0]);
  merge_row_stats(m[1], l[1]);

  // pass 2: P (float32), dP = do V^T; D = rowsum(P dP); o_pre = bf16(P) V
  float o[AHD / 8][4];
#pragma unroll
  for (int db = 0; db < AHD / 8; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[db][e] = 0.f;
  float dsum[2] = {0.f, 0.f};
  fetch_tile<BKT>(kh, 0, Np, kr);
  fetch_tile<BKT>(vh, 0, Np, vr);
  store_tile<BKT>(kr, ks);
  store_tile<BKT>(vr, vs);
  __syncthreads();
  for (int kt = 0; kt < n_kt; ++kt) {
    const bool more = kt + 1 < n_kt;
    if (more) {
      fetch_tile<BKT>(kh, (kt + 1) * BKT, Np, kr);
      fetch_tile<BKT>(vh, (kt + 1) * BKT, Np, vr);
    }
    float s[BNB][4], dp[BNB][4];
    score_tile<BKT>(qa, ks, kt * BKT, n_real, g, t, s);
    score_tile<BKT>(da, vs, kt * BKT, NO_MASK, g, t, dp);
#pragma unroll
    for (int nb = 0; nb < BNB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const float p = expf(s[nb][e] - m[hr]) / l[hr];
        s[nb][e] = p;
        dsum[hr] += p * dp[nb][e];
      }
    }
    pv_tile<BKT>(s, vs, lane, o);
    swap_tiles(more, kr, ks, vr, vs);
  }
  const float D[2] = {quad_sum(dsum[0]), quad_sum(dsum[1])};
  const size_t C3 = 3 * (size_t)C;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + row0 + 8 * hr;
    if (r >= Np) continue;
    bf16* dst = opre_g + ((size_t)b * Np + r) * C + h * AHD + 2 * t;
#pragma unroll
    for (int db = 0; db < AHD / 8; ++db)
      *reinterpret_cast<uint32_t*>(dst + db * 8) = pack_bf16(o[db][2 * hr], o[db][2 * hr + 1]);
    if (t == 0) {
      const size_t bhn = (size_t)B * heads * Np;
      const size_t i = ((size_t)b * heads + h) * Np + r;
      stats[i] = m[hr];
      stats[bhn + i] = l[hr];
      stats[2 * bhn + i] = D[hr];
    }
  }

  // pass 3: dS = P (dP - D), rounded to bf16; dq = dS K
  float dq[AHD / 8][4];
#pragma unroll
  for (int db = 0; db < AHD / 8; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[db][e] = 0.f;
  fetch_tile<BKT>(kh, 0, Np, kr);
  fetch_tile<BKT>(vh, 0, Np, vr);
  store_tile<BKT>(kr, ks);
  store_tile<BKT>(vr, vs);
  __syncthreads();
  for (int kt = 0; kt < n_kt; ++kt) {
    const bool more = kt + 1 < n_kt;
    if (more) {
      fetch_tile<BKT>(kh, (kt + 1) * BKT, Np, kr);
      fetch_tile<BKT>(vh, (kt + 1) * BKT, Np, vr);
    }
    float s[BNB][4], dp[BNB][4];
    score_tile<BKT>(qa, ks, kt * BKT, n_real, g, t, s);
    score_tile<BKT>(da, vs, kt * BKT, NO_MASK, g, t, dp);
#pragma unroll
    for (int nb = 0; nb < BNB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const float p = expf(s[nb][e] - m[hr]) / l[hr];
        s[nb][e] = p * (dp[nb][e] - D[hr]);
      }
    }
    pv_tile<BKT>(s, ks, lane, dq);
    swap_tiles(more, kr, ks, vr, vs);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = q0 + row0 + 8 * hr;
    if (r >= Np) continue;
    bf16* dst = dqkv_g + ((size_t)b * Np + r) * C3 + h * AHD + 2 * t;
#pragma unroll
    for (int db = 0; db < AHD / 8; ++db)
      *reinterpret_cast<uint32_t*>(dst + db * 8) = pack_bf16(dq[db][2 * hr], dq[db][2 * hr + 1]);
  }
}

// ---------------------------------------------------------------------------
// 3. key pass: dk and dv for 64 key rows
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(ATHREADS)
vit_attn_bwd_kv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dob,
                       const float* __restrict__ stats, bf16* __restrict__ dqkv_g, int Np,
                       int n_real) {
  __shared__ __align__(128) bf16 qs[BKT * LDT];
  __shared__ __align__(128) bf16 ds[BKT * LDT];
  __shared__ float sm[BKT], sl[BKT], sd[BKT];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = blockIdx.x * AQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int heads = gridDim.y;
  const int B = gridDim.z;
  const int C = heads * AHD;
  const size_t C3 = 3 * (size_t)C;
  if (k0 >= n_real) {
    // keys past n_real: P is exactly 0 in their columns, so dk = dv = 0
    for (int i = threadIdx.x; i < AQ * 16; i += ATHREADS) {
      const int r = k0 + i / 16;
      const int which = 1 + (i % 16) / 8;
      if (r < Np)
        reinterpret_cast<int4*>(dqkv_g + ((size_t)b * Np + r) * C3 + which * C + h * AHD)[i % 8] =
            make_int4(0, 0, 0, 0);
    }
    return;
  }
  const size_t hstride = (size_t)Np * AHD;
  const bf16* qh = qkv + ((size_t)b * heads + h) * hstride;
  const bf16* dh = dob + ((size_t)b * heads + h) * hstride;
  const size_t bhn = (size_t)B * heads * Np;
  const size_t srow = ((size_t)b * heads + h) * Np;
  const int n_qt = (Np + BKT - 1) / BKT;
  const int kr0 = k0 + warp * 16 + g;  // this thread's key rows kr0, kr0 + 8
  const bool live[2] = {kr0 < n_real, kr0 + 8 < n_real};

  uint32_t ka[AHD / 16][4], va[AHD / 16][4];
  load_a_rows(qkv + ((size_t)(B + b) * heads + h) * hstride, k0 + warp * 16, Np, g, t, ka);
  load_a_rows(qkv + ((size_t)(2 * B + b) * heads + h) * hstride, k0 + warp * 16, Np, g, t, va);
  float dk[AHD / 8][4], dv[AHD / 8][4];
#pragma unroll
  for (int db = 0; db < AHD / 8; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[db][e] = dv[db][e] = 0.f;

  // the row statistics of query tile qt (rows past Np: P forced to 0 below)
  auto load_stats = [&](int qt) {
    for (int i = threadIdx.x; i < BKT; i += ATHREADS) {
      const int q = qt * BKT + i;
      const bool in = q < Np;
      sm[i] = in ? stats[srow + q] : 0.f;
      sl[i] = in ? stats[bhn + srow + q] : 1.f;
      sd[i] = in ? stats[2 * bhn + srow + q] : 0.f;
    }
  };
  TileRegs<BKT> qr, dr;
  fetch_tile<BKT>(qh, 0, Np, qr);
  fetch_tile<BKT>(dh, 0, Np, dr);
  store_tile<BKT>(qr, qs);
  store_tile<BKT>(dr, ds);
  load_stats(0);
  __syncthreads();
  for (int qt = 0; qt < n_qt; ++qt) {
    const bool more = qt + 1 < n_qt;
    if (more) {
      fetch_tile<BKT>(qh, (qt + 1) * BKT, Np, qr);
      fetch_tile<BKT>(dh, (qt + 1) * BKT, Np, dr);
    }
    float s[BNB][4], dp[BNB][4];
    score_tile<BKT>(ka, qs, 0, NO_MASK, g, t, s);   // S^T: keys x queries
    score_tile<BKT>(va, ds, 0, NO_MASK, g, t, dp);  // dP^T = V do^T
#pragma unroll
    for (int nb = 0; nb < BNB; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = nb * 8 + 2 * t + (e & 1);
        float p = 0.f;
        if (live[e >> 1] && qt * BKT + qc < Np) p = expf(s[nb][e] - sm[qc]) / sl[qc];
        s[nb][e] = p;
        dp[nb][e] = p * (dp[nb][e] - sd[qc]);
      }
    }
    pv_tile<BKT>(s, ds, lane, dv);   // dv += P^T do
    pv_tile<BKT>(dp, qs, lane, dk);  // dk += dS^T q
    __syncthreads();                 // every warp is done with this query tile
    if (more) {
      store_tile<BKT>(qr, qs);
      store_tile<BKT>(dr, ds);
      load_stats(qt + 1);
      __syncthreads();
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = kr0 + 8 * hr;
    if (r >= Np) continue;
    bf16* row = dqkv_g + ((size_t)b * Np + r) * C3 + h * AHD + 2 * t;
#pragma unroll
    for (int db = 0; db < AHD / 8; ++db) {
      *reinterpret_cast<uint32_t*>(row + C + db * 8) = pack_bf16(dk[db][2 * hr], dk[db][2 * hr + 1]);
      *reinterpret_cast<uint32_t*>(row + 2 * C + db * 8) =
          pack_bf16(dv[db][2 * hr], dv[db][2 * hr + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 4. dx: dh = dqkv W_qkv, the column sums and the LN1 backward
// ---------------------------------------------------------------------------

template <int C>
struct DxSmem {
  static constexpr int LDF = C + 4;  // f32 rows of dh
  static constexpr size_t DH = (size_t)VT * LDF * 4;
  static constexpr size_t COLS = (size_t)6 * C * 4;
  static constexpr size_t off_cols = DH;
  static constexpr size_t off_stats = DH + COLS;
  static constexpr size_t bytes = off_stats + 2 * VT * 4;
  static_assert(DH % 128 == 0 && COLS % 128 == 0, "regions must stay 128-byte aligned");
  static_assert(bytes <= SMEM_LIMIT, "shared memory over the sm_90 limit");
};

template <int C>
__global__ void __launch_bounds__(NTHREADS, 1)
vit_attn_bwd_dx_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dh1,
                       const bf16* __restrict__ dqkv_g, const bf16* __restrict__ w_qkv,
                       const float* __restrict__ ln_w, bf16* __restrict__ dx,
                       float* __restrict__ part, int n_tiles, int tpb, float eps) {
  using L = DxSmem<C>;
  constexpr int PER = C / 32;
  constexpr int C3 = 3 * C;
  constexpr int RT = VT / 16;
  constexpr int CT = C / 16;
  constexpr int PG = row_group(RT, CT);
  extern __shared__ __align__(128) unsigned char smem[];
  float* dhf = reinterpret_cast<float*>(smem);
  float* cols = reinterpret_cast<float*>(smem + L::off_cols);
  float* mu = reinterpret_cast<float*>(smem + L::off_stats);
  float* rstd = mu + VT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  // [db_qkv | db_proj | dLN1 w | dLN1 b]; every column has one owner thread
  for (int i = threadIdx.x; i < 6 * C; i += NTHREADS) cols[i] = 0.f;

  const int tile_end = min(n_tiles, (int)(blockIdx.x + 1) * tpb);
  for (int tile = blockIdx.x * tpb; tile < tile_end; ++tile) {
    const size_t tok0 = (size_t)tile * VT;
    // 1. LN1 statistics of the tile's tokens
    for (int t = warp; t < VT; t += NWARPS)
      ln_stats<C>(x + (tok0 + t) * C, lane, eps, mu + t, rstd + t);
    // 2. dh = dqkv W_qkv (64 x C, K = 3C; A is the dqkv rows the passes wrote)
    for (int u = warp; u < CT * (RT / PG); u += NWARPS) {
      const int n0 = (u % CT) * 16;
      const int rt0 = (u / CT) * PG;
      FragC acc[PG];
#pragma unroll
      for (int r = 0; r < PG; ++r) wmma::fill_fragment(acc[r], 0.f);
#pragma unroll 2
      for (int k0 = 0; k0 < C3; k0 += 16) {
        FragBr bw;
        wmma::load_matrix_sync(bw, w_qkv + (size_t)k0 * C + n0, C);
#pragma unroll
        for (int r = 0; r < PG; ++r) {
          FragA a;
          wmma::load_matrix_sync(a, dqkv_g + (tok0 + (rt0 + r) * 16) * C3 + k0, C3);
          wmma::mma_sync(acc[r], a, bw, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < PG; ++r)
        wmma::store_matrix_sync(dhf + (rt0 + r) * 16 * L::LDF + n0, acc[r], L::LDF,
                                wmma::mem_row_major);
    }
    __syncthreads();

    // 3. column sums in token order: db_qkv of the bf16 dqkv rows, db_proj
    //    of dh1, dLN1 w = sum dh xhat, dLN1 b = sum dh
    for (int c = threadIdx.x; c < C3; c += NTHREADS) {
      float s = 0.f;
      for (int t = 0; t < VT; ++t) s += __bfloat162float(dqkv_g[(tok0 + t) * C3 + c]);
      cols[c] += s;
    }
    for (int c = threadIdx.x; c < C; c += NTHREADS) {
      float sp = 0.f, sw = 0.f, sb = 0.f;
      for (int t = 0; t < VT; ++t) {
        const size_t off = (tok0 + t) * C + c;
        sp += __bfloat162float(dh1[off]);
        const float xh = (__bfloat162float(x[off]) - mu[t]) * rstd[t];
        const float d = dhf[t * L::LDF + c];
        sw += d * xh;
        sb += d;
      }
      cols[C3 + c] += sp;
      cols[C3 + C + c] += sw;
      cols[C3 + 2 * C + c] += sb;
    }
    // 4. dx = dh1 + rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)), dxhat = dh w
    for (int t = warp; t < VT; t += NWARPS) {
      const size_t row = (tok0 + t) * C;
      float xh[PER], dxh[PER];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int c = lane + 32 * i;
        xh[i] = (__bfloat162float(x[row + c]) - mu[t]) * rstd[t];
        dxh[i] = dhf[t * L::LDF + c] * ln_w[c];
        s1 += dxh[i];
        s2 += dxh[i] * xh[i];
      }
      const float m1 = warp_sum(s1) / (float)C;
      const float m2 = warp_sum(s2) / (float)C;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int c = lane + 32 * i;
        dx[row + c] = __float2bfloat16(__bfloat162float(dh1[row + c]) +
                                       rstd[t] * (dxh[i] - m1 - xh[i] * m2));
      }
    }
    __syncthreads();
  }
  // 5. this block's column sums -> its partial row
  for (int i = threadIdx.x; i < 6 * C; i += NTHREADS) part[(size_t)blockIdx.x * 6 * C + i] = cols[i];
}

template <int C>
static cudaError_t launch_attn_bwd(const void* x, const void* dh1, void* dx, const void* w_qkv,
                                   const void* b_qkv, const void* w_proj, const void* ln_w,
                                   const void* ln_b, void* h_g, void* opre_g, void* dqkv_g,
                                   void* part, void* qkv_ws, void* do_ws, void* stats_ws,
                                   int B, int Np, int heads, int n_real, int tpb, float eps,
                                   cudaStream_t stream) {
  const int n = B * Np;
  const int n_tiles = n / VT;
  auto prep = vit_attn_bwd_prep_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(prep, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)PrepSmem<C>::bytes);
  if (err != cudaSuccess) return err;
  prep<<<dim3(n_tiles, 4), NTHREADS, PrepSmem<C>::bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dh1),
      static_cast<const bf16*>(w_qkv), static_cast<const float*>(b_qkv),
      static_cast<const bf16*>(w_proj), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<bf16*>(h_g), static_cast<bf16*>(qkv_ws),
      static_cast<bf16*>(do_ws), n, Np, heads, eps);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const dim3 grid((Np + AQ - 1) / AQ, heads, B);
  vit_attn_bwd_q_kernel<<<grid, ATHREADS, 0, stream>>>(
      static_cast<const bf16*>(qkv_ws), static_cast<const bf16*>(do_ws),
      static_cast<bf16*>(opre_g), static_cast<bf16*>(dqkv_g), static_cast<float*>(stats_ws),
      Np, n_real);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  vit_attn_bwd_kv_kernel<<<grid, ATHREADS, 0, stream>>>(
      static_cast<const bf16*>(qkv_ws), static_cast<const bf16*>(do_ws),
      static_cast<const float*>(stats_ws), static_cast<bf16*>(dqkv_g), Np, n_real);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  auto dxk = vit_attn_bwd_dx_kernel<C>;
  err = cudaFuncSetAttribute(dxk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)DxSmem<C>::bytes);
  if (err != cudaSuccess) return err;
  dxk<<<(n_tiles + tpb - 1) / tpb, NTHREADS, DxSmem<C>::bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dh1),
      static_cast<const bf16*>(dqkv_g), static_cast<const bf16*>(w_qkv),
      static_cast<const float*>(ln_w), static_cast<bf16*>(dx), static_cast<float*>(part),
      n_tiles, tpb, eps);
  return cudaGetLastError();
}

}  // namespace hmdt

// C interface for ctypes. Returns the first launch error (0 on success).
// x, dh1, dx (B, Np, C) bf16 with B Np a multiple of 64; w_qkv (3C, C) and
// w_proj (C, C) bf16 (torch layout, q rows scaled); b_qkv, ln_w, ln_b f32;
// h_g, opre_g (B Np, C) and dqkv_g (B Np, 3C) bf16; part (ceil(B Np / 64 /
// tpb), 6C) f32; scratch qkv_ws (3, B, heads, Np, 64) and do_ws (B, heads,
// Np, 64) bf16, stats_ws (3, B heads Np) f32. Keys >= n_real are masked.
extern "C" int vit_attn_bwd_launch(const void* x, const void* dh1, void* dx, const void* w_qkv,
                                   const void* b_qkv, const void* w_proj, const void* ln_w,
                                   const void* ln_b, void* h_g, void* opre_g, void* dqkv_g,
                                   void* part, void* qkv_ws, void* do_ws, void* stats_ws,
                                   int B, int Np, int C, int heads, int n_real, int tpb,
                                   float eps, void* stream) {
  using namespace hmdt;
  if (B <= 0 || B > 65535 || Np <= 0 || (B * Np) % VT || n_real <= 0 || n_real > Np ||
      heads * AHD != C || tpb <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HMDT_VIT_ATTN_BWD_CASE(CC)                                                       \
  case CC:                                                                               \
    return (int)launch_attn_bwd<CC>(x, dh1, dx, w_qkv, b_qkv, w_proj, ln_w, ln_b, h_g,  \
                                    opre_g, dqkv_g, part, qkv_ws, do_ws, stats_ws, B,   \
                                    Np, heads, n_real, tpb, eps, s);
  switch (C) {
    HMDT_VIT_ATTN_BWD_CASE(384)
    HMDT_VIT_ATTN_BWD_CASE(768)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HMDT_VIT_ATTN_BWD_CASE
}
