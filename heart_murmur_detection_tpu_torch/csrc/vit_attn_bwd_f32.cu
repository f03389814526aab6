// vit_attn_bwd_f32: the backward of the attention half of a ViT training
// block in float32, h1 = x + proj(concat_h softmax(q_h k_h^T, keys >= n_real
// masked) v_h), [q | k | v] = LN1(x) W_qkv^T + b_qkv (the q rows carry
// 1/sqrt(hd)), given dh1 (B, Np, C) float32: dx = dh1 + LN1^T(dh), where per
// clip and head
//   do = dh1 W_proj,  P = softmax(S),  dP = do_h v_h^T,  D = rowsum(P dP),
//   dS = P (dP - D),  dq = dS k,  dk = dS^T q,  dv = P^T do_h,
//   dh = [dq | dk | dv] W_qkv.
//
// Replaces the TPU body `_attn_bwd_core` (heart_murmur_detection_tpu/ops/
// pallas_vit_train.py:246) as `_bwd_attn_emit_kernel` (:364) runs it at
// mm_dtype=float32, every product at Precision.HIGHEST with float32
// accumulation (prec = HI, :253): the float32 mode of K9's backward,
// fused_vit_block_train (:703). There is no rounding point.
//
// Outputs, besides dx: the operand rows of the two weight products, float32
// h_g = LN1(x), opre_g = the attention output before proj (B Np, C) and
// dqkv_g = [dq | dk | dv] (B Np, 3C), which swin_wgrad_f32 turns into dW_qkv
// = dqkv^T LN1(x) and dW_proj = dh1^T o_pre; and float32 partial rows
// [db_qkv (3C) | db_proj (C) | dLN1 w (C) | dLN1 b (C)], one a block of the
// row pass, summed later in row order by swin_reduce.
//
// Bound on this card: about 14 C^2 + 12 Np C operations a token (the qkv
// recompute, do and dh products; the query pass's two score sweeps of S and
// dP, P v and dS k; the key pass's S, dP, P^T do and dS^T q), against about
// 6 C bytes in and out, so the operations bind, at the FFMA rate (wgmma's
// float32 input is TF32, which misses Precision.HIGHEST). Design, eight grid
// launches a call, the products on swin_f32_common.cuh's token-row product
// and the attention passes on vit_f32_attn.cuh's tiles (the layout of
// vit_attn_bwd.cu's six launches, on FFMA):
//  1. W_proj^T and W_qkv^T into small workspaces (the product computes A
//     W^T; do and dh take the transposes);
//  2. the operand rows LN1(x) (h_g), a warp a token;
//  3. qkv = LN1(x) W_qkv^T + b_qkv on the product, into a float32 workspace
//     (B Np, 3C), [q | k | v] token-major;
//  4. do = dh1 W_proj on the product, into a float32 workspace (B Np, C);
//  5. the query pass, a block of 128 threads a (tile of 64 query rows, head,
//     clip): sweep one over the key tiles < n_real forms S and dP and keeps
//     each row's max m, sum l of exp(s - m) and sum t of exp(s - m) dP,
//     rescaled together when the max moves, so D = t / l comes from the
//     unrounded float32 P and dP; sweep two forms S and dP again, P = exp(s
//     - m) / l, dS = P (dP - D), and sums o_pre = P v and dq = dS k over the
//     key tiles in registers. It writes the o_pre and dq rows and each row's
//     (m, 1 / l, D);
//  6. the key pass, a block a (tile of 64 keys, head, clip): S^T and dP^T of
//     every query tile (the padded query rows < Np take part, as in the
//     plain version; rows past Np do not), P^T and dS^T from the query rows'
//     statistics (bitwise the query pass's: the same fmaf chains), dv = P^T
//     do and dk = dS^T q summed over the query tiles in registers. A key
//     tile wholly at or past n_real writes zero rows; a key past n_real in a
//     partial tile has P = dS = 0, so its dk and dv rows are exact zeros;
//  7. dh = dqkv W_qkv on the product (K = 3C), into a float32 workspace;
//  8. the row pass (contiguous runs of tokens, a block a run): dx = dh1 +
//     the LN1 backward of dh, and each block's partial row (the column sums
//     of dqkv, dh1, dh xhat and dh over its tokens in order).
// No atomics; every sum has one order fixed by the shapes, so two launches
// agree bitwise.
#include "swin_f32_common.cuh"
#include "vit_f32_attn.cuh"

namespace hmdt {
namespace vf32 {

// Shared floats of a query-pass block: q^T, do^T, P^T and dS^T (row tiles),
// k^T and v^T (column tiles); of a key-pass block: k^T, v^T, P and dS (row
// tiles), q^T and do^T (column tiles), and the query tile's (m, 1 / l, D)
// (ops/vit_plan.py::attn_bwd_f32_plan computes the same sums).
constexpr size_t query_floats() { return 4 * (size_t)AT * RS + 2 * (size_t)AT * CS; }
constexpr size_t key_floats() { return 4 * (size_t)AT * RS + 2 * (size_t)AT * CS + 3 * AT; }
constexpr size_t query_smem_bytes() { return sizeof(float) * query_floats(); }
constexpr size_t key_smem_bytes() { return sizeof(float) * key_floats(); }

// grid (ceil(Np / 64), heads, B). qkv (B Np, 3C) [q | k | v]; dO (B Np, C);
// opre (B Np, C); dqkv (B Np, 3C): dq's third written here; stats (3, B
// heads Np): m, 1 / l, D of each query row.
__global__ void __launch_bounds__(ATHREADS)
    vit_attn_bwd_f32_query_kernel(const float* __restrict__ qkv, const float* __restrict__ dO,
                                  float* __restrict__ opre, float* __restrict__ dqkv,
                                  float* __restrict__ stats, int Np, int C, int n_real) {
  extern __shared__ float4 smem4[];
  float* QT = reinterpret_cast<float*>(smem4);  // [64 d][RS]
  float* DOT = QT + AHD * RS;                   // [64 d][RS]
  float* PT = DOT + AHD * RS;                   // [64 keys][RS]
  float* DST = PT + AT * RS;                    // [64 keys][RS]
  float* KT = DST + AT * RS;                    // [64 d][CS]
  float* VT = KT + AHD * CS;                    // [64 d][CS]
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
  const int i0 = blockIdx.x * AT, h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int ld = 3 * C;
  const float* base = qkv + (size_t)b * Np * ld + h * AHD;
  const float* dbase = dO + (size_t)b * Np * C + h * AHD;
  const int qv = min(AT, Np - i0);
  load_tile<RS>(QT, base + (size_t)i0 * ld, ld, qv);
  load_tile<RS>(DOT, dbase + (size_t)i0 * C, C, qv);
  const int ktiles = (n_real + AT - 1) / AT;

  float m[8], l[8], t[8], s[8][4], dp[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    m[a] = -INFINITY;
    l[a] = t[a] = 0.f;
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    const int j0 = kt * AT, kv = min(AT, Np - j0);
    __syncthreads();
    load_tile<CS>(KT, base + (size_t)j0 * ld + C, ld, kv);
    load_tile<CS>(VT, base + (size_t)j0 * ld + 2 * C, ld, kv);
    __syncthreads();
    score_tile(QT, KT, s);
    score_tile(DOT, VT, dp);
    mask_keys(s, j0, n_real);
    stats_tile<true>(s, dp, m, l, t);
  }
  float rl[8], D[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    rl[a] = 1.f / l[a];
    D[a] = __fmul_rn(t[a], rl[a]);
  }

  float o[8][4], dq[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[a][c] = dq[a][c] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int j0 = kt * AT, kv = min(AT, Np - j0);
    __syncthreads();
    load_tile<CS>(KT, base + (size_t)j0 * ld + C, ld, kv);
    load_tile<CS>(VT, base + (size_t)j0 * ld + 2 * C, ld, kv);
    __syncthreads();
    score_tile(QT, KT, s);
    score_tile(DOT, VT, dp);
    mask_keys(s, j0, n_real);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      float p[4], ds[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = __fmul_rn(expf(s[a][c] - m[a]), rl[a]);
        ds[c] = __fmul_rn(p[c], __fsub_rn(dp[a][c], D[a]));
      }
      store_row_t(PT, ti * 8 + a, p);
      store_row_t(DST, ti * 8 + a, ds);
    }
    __syncthreads();
    accum_tile(PT, VT, o);
    accum_tile(DST, KT, dq);
  }
  const size_t bh = ((size_t)b * heads + h) * Np, BHN = (size_t)gridDim.z * heads * Np;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int row = i0 + ti * 8 + a;
    if (row >= Np) break;
    float* orow = opre + ((size_t)b * Np + row) * C + h * AHD;
    float* qrow = dqkv + ((size_t)b * Np + row) * ld + h * AHD;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      orow[tj + 16 * c] = o[a][c];
      qrow[tj + 16 * c] = dq[a][c];
    }
    if (tj == 0) {
      stats[bh + row] = m[a];
      stats[BHN + bh + row] = rl[a];
      stats[2 * BHN + bh + row] = D[a];
    }
  }
}

// grid (ceil(Np / 64), heads, B): block (tile, h, b) takes keys [64 tile,
// 64 tile + 64) of clip b, head h, and writes their dk and dv rows into
// dqkv's second and third thirds.
__global__ void __launch_bounds__(ATHREADS)
    vit_attn_bwd_f32_key_kernel(const float* __restrict__ qkv, const float* __restrict__ dO,
                                const float* __restrict__ stats, float* __restrict__ dqkv, int Np,
                                int C, int n_real) {
  extern __shared__ float4 smem4[];
  float* KT = reinterpret_cast<float*>(smem4);  // [64 d][RS]
  float* VT = KT + AHD * RS;                    // [64 d][RS]
  float* PP = VT + AHD * RS;                    // [64 queries][RS]
  float* DSP = PP + AT * RS;                    // [64 queries][RS]
  float* QT = DSP + AT * RS;                    // [64 d][CS]
  float* DOT = QT + AHD * CS;                   // [64 d][CS]
  float* s_m = DOT + AHD * CS;                  // [64]
  float* s_rl = s_m + AT;                       // [64]
  float* s_D = s_rl + AT;                       // [64]
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
  const int j0 = blockIdx.x * AT, h = blockIdx.y, b = blockIdx.z, heads = gridDim.y;
  const int ld = 3 * C;
  const float* base = qkv + (size_t)b * Np * ld + h * AHD;
  const float* dbase = dO + (size_t)b * Np * C + h * AHD;
  const size_t bh = ((size_t)b * heads + h) * Np, BHN = (size_t)gridDim.z * heads * Np;
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[a][c] = dv[a][c] = 0.f;

  if (j0 < n_real) {
    load_tile<RS>(KT, base + (size_t)j0 * ld + C, ld, min(AT, Np - j0));
    load_tile<RS>(VT, base + (size_t)j0 * ld + 2 * C, ld, min(AT, Np - j0));
    float s[8][4], dp[8][4];
    for (int i0 = 0; i0 < Np; i0 += AT) {
      const int qv = min(AT, Np - i0);
      __syncthreads();
      load_tile<CS>(QT, base + (size_t)i0 * ld, ld, qv);
      load_tile<CS>(DOT, dbase + (size_t)i0 * C, C, qv);
      if (threadIdx.x < qv) {
        s_m[threadIdx.x] = stats[bh + i0 + threadIdx.x];
        s_rl[threadIdx.x] = stats[BHN + bh + i0 + threadIdx.x];
        s_D[threadIdx.x] = stats[2 * BHN + bh + i0 + threadIdx.x];
      }
      __syncthreads();
      score_tile(KT, QT, s);   // S^T: keys ti 8 + a, queries tj + 16 c
      score_tile(VT, DOT, dp);  // dP^T
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const bool key_ok = j0 + ti * 8 + a < n_real;
        float p[4], ds[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = tj + 16 * c;
          p[c] = ds[c] = 0.f;
          if (key_ok && qi < qv) {
            p[c] = __fmul_rn(expf(s[a][c] - s_m[qi]), s_rl[qi]);
            ds[c] = __fmul_rn(p[c], __fsub_rn(dp[a][c], s_D[qi]));
          }
        }
        store_row_t(PP, ti * 8 + a, p);
        store_row_t(DSP, ti * 8 + a, ds);
      }
      __syncthreads();
      accum_tile(PP, DOT, dv);
      accum_tile(DSP, QT, dk);
    }
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int key = j0 + ti * 8 + a;
    if (key >= Np) break;
    float* krow = dqkv + ((size_t)b * Np + key) * ld + C + h * AHD;
    const bool ok = key < n_real;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      krow[tj + 16 * c] = ok ? dk[a][c] : 0.f;
      krow[C + tj + 16 * c] = ok ? dv[a][c] : 0.f;
    }
  }
}

}  // namespace vf32
}  // namespace hmdt

// x, dh1, dx (B, Np, C) float32; w_qkv (3C, C), b_qkv, w_proj (C, C), ln_w,
// ln_b float32; the operand rows h_g, opre_g (n, C) and dqkv_g (n, 3C), n =
// B Np; part (grid, 6C); workspaces qkv_ws (n, 3C), do_ws (n, C), stats_ws
// (3, B heads Np), d_ws (n, C), wpt_ws (C, C), wqt_ws (C, 3C); n_real in (0,
// Np]; the plan (ops/vit_plan.py::attn_bwd_f32_plan): the row pass's blocks,
// the attention passes' threads and shared bytes (query, key), the
// product's tile rows, columns, threads and shared bytes, the row kernels'
// threads, each checked against this file's constants.
extern "C" int vit_attn_bwd_f32_launch(
    const void* x, const void* dh1, void* dx, const void* w_qkv, const void* b_qkv,
    const void* w_proj, const void* ln_w, const void* ln_b, void* h_g, void* opre_g,
    void* dqkv_g, void* part, void* qkv_ws, void* do_ws, void* stats_ws, void* d_ws, void* wpt_ws,
    void* wqt_ws, int B, int Np, int C, int heads, int n_real, int grid, int attn_threads,
    int query_smem, int key_smem, int tile_rows, int tile_cols, int threads, int gemm_smem,
    int row_threads, float eps, void* stream) {
  using namespace hmdt::f32;
  using namespace hmdt::vf32;
  const int n = B * Np;
  if (B <= 0 || B > 65535 || Np <= 0 || Np % 16 || n % GBM || (C != 384 && C != 768) ||
      heads * AHD != C || n_real <= 0 || n_real > Np || grid <= 0 || grid > n / GBM)
    return (int)cudaErrorInvalidValue;
  if (attn_threads != ATHREADS || (size_t)query_smem != query_smem_bytes() ||
      (size_t)key_smem != key_smem_bytes() || tile_rows != GBM || tile_cols != GBN ||
      threads != GTHREADS || (size_t)gemm_smem != gemm_smem_bytes() || row_threads != RTHREADS)
    return (int)cudaErrorInvalidValue;
  static bool attr = false;  // set once, at the first (warm-up) call
  cudaError_t e = cudaSuccess;
  if (!attr) {
    e = cudaFuncSetAttribute(vit_attn_bwd_f32_query_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)query_smem_bytes());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(vit_attn_bwd_f32_key_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)key_smem_bytes());
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* g = static_cast<const float*>(dh1);
  const float* wq = static_cast<const float*>(w_qkv);
  float* h = static_cast<float*>(h_g);
  float* dqkv = static_cast<float*>(dqkv_g);
  float* qkv = static_cast<float*>(qkv_ws);
  float* dws = static_cast<float*>(do_ws);
  float* d = static_cast<float*>(d_ws);
  float* wpt = static_cast<float*>(wpt_ws);
  float* wqt = static_cast<float*>(wqt_ws);
  const WinGeom none{0, 0, 1, 1, 0};
  const dim3 agrid((Np + AT - 1) / AT, heads, B);
  e = launch_transpose(static_cast<const float*>(w_proj), wpt, C, C, s);
  if (e == cudaSuccess) e = launch_transpose(wq, wqt, 3 * C, C, s);
  if (e == cudaSuccess)
    e = launch_ln_rows<false>(xf, g, nullptr, static_cast<const float*>(ln_w),
                              static_cast<const float*>(ln_b), h, nullptr, n, C, Np, none, eps, s);
  if (e == cudaSuccess)
    e = launch_rows<EPI_STORE>(h, wq, static_cast<const float*>(b_qkv), qkv, n, 3 * C, C, s);
  if (e == cudaSuccess) e = launch_rows<EPI_STORE>(g, wpt, nullptr, dws, n, C, C, s);
  if (e == cudaSuccess) {
    vit_attn_bwd_f32_query_kernel<<<agrid, ATHREADS, query_smem_bytes(), s>>>(
        qkv, dws, static_cast<float*>(opre_g), dqkv, static_cast<float*>(stats_ws), Np, C, n_real);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) {
    vit_attn_bwd_f32_key_kernel<<<agrid, ATHREADS, key_smem_bytes(), s>>>(
        qkv, dws, static_cast<const float*>(stats_ws), dqkv, Np, C, n_real);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) e = launch_rows<EPI_STORE>(dqkv, wqt, nullptr, d, n, C, 3 * C, s);
  if (e == cudaSuccess)
    e = launch_ln_bwd<false>(xf, d, g, static_cast<const float*>(ln_w), g, dqkv,
                             static_cast<float*>(dx), static_cast<float*>(part), n, C, 3 * C,
                             6 * C, 3 * C, grid, Np, none, eps, s);
  return (int)e;
}
