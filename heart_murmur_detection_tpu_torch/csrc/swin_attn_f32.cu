// swin_attn_f32: the attention half of an HTS-AT swin block in float32,
//   h1 = x + k[b] * (proj(concat_h softmax(q_h k_h^T / sqrt(hd) + bias_h (+ mask)) v_h) + b_proj),
//   q, k, v = LN1(x) W_qkv + b_qkv, over 8x8 windows of x (B, H, W, C) float32;
//   k is an optional per-sample multiplier (null in eval).
//
// Replaces the attention body `_strip_attn` (heart_murmur_detection_tpu/ops/
// pallas_swin.py:97) at mm_dtype=float32, where every product runs at
// Precision.HIGHEST with float32 accumulation (:112-115): the float32 mode
// of the TPU kernels fused_swin_block (:480), fused_swin_pair (:847) and
// fused_swin_block_split (:618, attention half). There is no rounding
// point: operands, accumulators and the stored q, k, v, P and head outputs
// are all float32.
//
// Bound on this card: about 8 C^2 + 256 C operations a token against 8 C
// bytes, so the operations bind, at the FFMA rate (wgmma's float32 input is
// TF32, a 10-bit mantissa, which misses Precision.HIGHEST). Design, two
// grid launches a call, every product an fmaf chain in k order:
//  1. the core, a block of 128 threads per (window, head): the window's 64
//     token offsets (the cyclic shift stays in the addressing, token (r, c)
//     of rolled window (i, j) being x[(8i+r+s) mod H, (8j+c+s) mod W]; the
//     mask is indexed by (i, j) in the rolled frame, so no rolled copy is
//     made); LN1's two-pass float32 row statistics; the head's q, k, v
//     (64 x 72: hd 24 each, the zero rows that pad the layout to 32 a head
//     skipped) from K-chunks of 32 columns of x, normalised on the fly from
//     those statistics as they are staged (so no LN1 panel is held: at C 384
//     / 768 a float32 panel would take 96 / 192 KB of the 227), and the
//     matching rows of W_qkv; q times hd^-0.5; the 64 x 64 scores + bias[h]
//     (+ mask[window]) in shared memory; a warp's row softmax (stable, or
//     fast_softmax: exp(s) unnormalised and P v times 1 / sum); P v; the
//     head's 24 columns of o written to a float32 workspace (windows x 64,
//     C), which stays in L2 for
//  2. proj: the product of swin_f32_common.cuh over o and W_proj, + b_proj,
//     times k, + x, written at the token's place in x.
// No atomics; every sum has one order, so two launches agree bitwise.
#include "swin_f32_common.cuh"

namespace hmdt {
namespace f32 {

constexpr int HD = 24;            // head dim of every HTS-AT stage
constexpr int QKVN = 3 * HD;      // q, k, v columns of a head
constexpr int ATHREADS = 128;
constexpr int ABK = 32;           // k depth of a qkv step
constexpr int AAS = NTOK + 4;     // row stride of the k-major x tile (and of q^T)
constexpr int ABS = QKVN + 4;     // row stride of the k-major W_qkv tile
constexpr int SST = NTOK + 1;     // row stride of the scores

// Shared memory of a core block, in bytes from the start: token offsets
// (64 x 8), then the qkv tiles (aliased by the scores once q, k, v are
// made), q^T (scaled), k^T, v, and the row statistics and reciprocals
// (ops/swin_plan.py::attn_f32_plan computes the same sum).
constexpr size_t CORE_TILES = (size_t)ABK * AAS + (size_t)ABK * ABS;
constexpr size_t CORE_SCORES = (size_t)NTOK * SST;
constexpr size_t CORE_REGION = CORE_TILES > CORE_SCORES ? CORE_TILES : CORE_SCORES;
constexpr size_t core_smem_bytes() {
  return 8 * NTOK +
         sizeof(float) * (CORE_REGION + (size_t)HD * AAS + (size_t)HD * NTOK + (size_t)NTOK * HD +
                          3 * NTOK);
}

__global__ void __launch_bounds__(ATHREADS)
    swin_attn_f32_core_kernel(const float* __restrict__ x, float* __restrict__ o_ws,
                              const float* __restrict__ w_qkv, const float* __restrict__ b_qkv,
                              const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                              const float* __restrict__ bias, const float* __restrict__ mask,
                              int C, int heads, WinGeom g, int fast_softmax) {
  extern __shared__ float4 smem4[];
  size_t* s_off = reinterpret_cast<size_t*>(smem4);              // [64]
  float* region = reinterpret_cast<float*>(s_off + NTOK);         // tiles / scores
  float* As = region;                                             // [ABK][AAS]
  float* Bs = As + ABK * AAS;                                     // [ABK][ABS]
  float* S = region;                                              // [64][SST]
  float* QT = region + CORE_REGION;                               // [HD][AAS]
  float* KT = QT + HD * AAS;                                      // [HD][64]
  float* V = KT + HD * NTOK;                                      // [64][HD]
  float* s_mu = V + NTOK * HD;
  float* s_rs = s_mu + NTOK;
  float* s_rc = s_rs + NTOK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int win = blockIdx.x, h = blockIdx.y;
  const int hdp_rows = heads * HDP;  // rows of q (then k, then v) in the padded W_qkv

  if (tid < NTOK) {
    int b;
    s_off[tid] = win_offset(win * NTOK + tid, g, C, b);
  }
  __syncthreads();
  for (int rr = 0; rr < NTOK / 4; ++rr) {
    const int r = warp * (NTOK / 4) + rr;
    float mu, rs;
    row_stats(x + s_off[r], C, 1e-5f, mu, rs);
    if (lane == 0) {
      s_mu[r] = mu;
      s_rs[r] = rs;
    }
  }
  __syncthreads();

  // q, k, v of head h: 64 x 72 = LN1(x) (64 x C) W_h^T; a thread holds 4
  // rows x 9 columns (rows tr*4.., columns tc + 8 j)
  {
    const int tr = tid >> 3, tc = tid & 7;
    float acc[4][9];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 9; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < C; k0 += ABK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = tid + ATHREADS * i, r = idx >> 3, q = idx & 7, k = k0 + 4 * q;
        float4 v = *reinterpret_cast<const float4*>(x + s_off[r] + k);
        const float mu = s_mu[r], rs = s_rs[r];
        As[(4 * q + 0) * AAS + r] = ln_affine(v.x, mu, rs, ln_w[k], ln_b[k]);
        As[(4 * q + 1) * AAS + r] = ln_affine(v.y, mu, rs, ln_w[k + 1], ln_b[k + 1]);
        As[(4 * q + 2) * AAS + r] = ln_affine(v.z, mu, rs, ln_w[k + 2], ln_b[k + 2]);
        As[(4 * q + 3) * AAS + r] = ln_affine(v.w, mu, rs, ln_w[k + 3], ln_b[k + 3]);
      }
      for (int idx = tid; idx < QKVN * (ABK / 4); idx += ATHREADS) {
        const int n = idx >> 3, q = idx & 7;
        const int part = n / HD, d = n - part * HD;
        const float4 v = *reinterpret_cast<const float4*>(
            w_qkv + (size_t)(part * hdp_rows + h * HDP + d) * C + k0 + 4 * q);
        Bs[(4 * q + 0) * ABS + n] = v.x;
        Bs[(4 * q + 1) * ABS + n] = v.y;
        Bs[(4 * q + 2) * ABS + n] = v.z;
        Bs[(4 * q + 3) * ABS + n] = v.w;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < ABK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(As + kk * AAS + tr * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        float bv[9];
#pragma unroll
        for (int j = 0; j < 9; ++j) bv[j] = Bs[kk * ABS + tc + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 9; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
    // + b_qkv; q scaled by hd^-0.5 (the float32 constant) after its own
    // rounding, as the plain version scales the stored q
    const float scale = 0.2041241452319315f;
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const int n = tc + 8 * j, part = j / 3, d = n - part * HD;
      const float bq = b_qkv[part * hdp_rows + h * HDP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tr * 4 + i;
        const float v = acc[i][j] + bq;
        if (part == 0)
          QT[d * AAS + r] = __fmul_rn(v, scale);
        else if (part == 1)
          KT[d * NTOK + r] = v;
        else
          V[r * HD + d] = v;
      }
    }
  }
  __syncthreads();

  // scores: a thread holds rows ti*8.. and columns tj + 16 b
  {
    const int ti = tid >> 4, tj = tid & 15;
    float s[8][4];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float4 q0 = *reinterpret_cast<const float4*>(QT + d * AAS + ti * 8);
      const float4 q1 = *reinterpret_cast<const float4*>(QT + d * AAS + ti * 8 + 4);
      const float qa[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      float kb[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) kb[b] = KT[d * NTOK + tj + 16 * b];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
    }
    const float* bh = bias + (size_t)h * NTOK * NTOK;
    const float* mw = mask ? mask + (size_t)(win % g.nw) * NTOK * NTOK : nullptr;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int i = ti * 8 + a;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = tj + 16 * b;
        float v = __fadd_rn(s[a][b], bh[i * NTOK + j]);
        if (mw) v = __fadd_rn(v, mw[i * NTOK + j]);
        S[i * SST + j] = v;
      }
    }
  }
  __syncthreads();

  // softmax: a warp a row at a time, two columns a lane; one division a row
  for (int rr = 0; rr < NTOK / 4; ++rr) {
    const int i = warp * (NTOK / 4) + rr;
    const float s0 = S[i * SST + lane], s1 = S[i * SST + lane + 32];
    float e0, e1;
    if (fast_softmax) {
      e0 = expf(s0);
      e1 = expf(s1);
    } else {
      float m = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      e0 = expf(s0 - m);
      e1 = expf(s1 - m);
    }
    const float rc = 1.f / warp_sum(e0 + e1);
    if (fast_softmax) {
      S[i * SST + lane] = e0;
      S[i * SST + lane + 32] = e1;
      if (lane == 0) s_rc[i] = rc;
    } else {
      S[i * SST + lane] = __fmul_rn(e0, rc);
      S[i * SST + lane + 32] = __fmul_rn(e1, rc);
    }
  }
  __syncthreads();

  // o = P v: a thread holds rows ti*4.. and dims tc + 8 c
  {
    const int ti = tid >> 3, tc = tid & 7;
    float o[4][3];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 3; ++c) o[a][c] = 0.f;
#pragma unroll 8
    for (int j = 0; j < NTOK; ++j) {
      float p[4], v[3];
#pragma unroll
      for (int a = 0; a < 4; ++a) p[a] = S[(ti * 4 + a) * SST + j];
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = V[j * HD + tc + 8 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c) o[a][c] = fmaf(p[a], v[c], o[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ti * 4 + a;
      const float rc = fast_softmax ? s_rc[i] : 1.f;
      float* orow = o_ws + ((size_t)win * NTOK + i) * C + h * HD;
#pragma unroll
      for (int c = 0; c < 3; ++c) orow[tc + 8 * c] = fast_softmax ? __fmul_rn(o[a][c], rc) : o[a][c];
    }
  }
}

}  // namespace f32
}  // namespace hmdt

// x, out (B, H, W, C) float32; o_ws (B H W, C) float32 workspace; the
// padded layout of ops/swin.py::SwinBlockParams in float32; mask (nW, 64, 64)
// or null; kmul (B,) or null; the plan (ops/swin_plan.py::attn_f32_plan):
// the core's threads and shared bytes, proj's tile rows, columns, threads
// and shared bytes, each checked against this file's constants.
extern "C" int swin_attn_f32_launch(const void* x, void* out, void* o_ws, const void* w_qkv,
                                    const void* b_qkv, const void* w_proj, const void* b_proj,
                                    const void* ln_w, const void* ln_b, const void* bias,
                                    const void* mask, const void* kmul, int B, int H, int W, int C,
                                    int heads, int shift, int fast_softmax, int core_threads,
                                    int core_smem, int tile_rows, int tile_cols, int gemm_threads,
                                    int gemm_smem, void* stream) {
  using namespace hmdt;
  using namespace hmdt::f32;
  if (B <= 0 || H <= 0 || W <= 0 || H % WIN || W % WIN || heads <= 0 || heads * HD != C ||
      C % GBN || C % ABK || shift < 0 || shift >= WIN)
    return (int)cudaErrorInvalidValue;
  if (core_threads != ATHREADS || (size_t)core_smem != core_smem_bytes() || tile_rows != GBM ||
      tile_cols != GBN || gemm_threads != GTHREADS || (size_t)gemm_smem != gemm_smem_bytes())
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WinGeom g{H, W, W / WIN, (H / WIN) * (W / WIN), shift};
  const int windows = B * g.nw;
  swin_attn_f32_core_kernel<<<dim3(windows, heads), ATHREADS, core_smem_bytes(), s>>>(
      static_cast<const float*>(x), static_cast<float*>(o_ws), static_cast<const float*>(w_qkv),
      static_cast<const float*>(b_qkv), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), static_cast<const float*>(bias),
      static_cast<const float*>(mask), C, heads, g, fast_softmax);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm<false, EPI_RESID, true>(
      static_cast<const float*>(o_ws), static_cast<const float*>(w_proj),
      static_cast<const float*>(b_proj), nullptr, nullptr, static_cast<const float*>(x),
      static_cast<const float*>(kmul), static_cast<float*>(out), windows * NTOK, C, C, H * W, g,
      0.f, s);
  return (int)e;
}
