// swin_attn_bwd_f32: the backward of the attention half of an HTS-AT swin
// block in float32, h1 = x + k1[b] * attn(x) over 8x8 windows of x (B, H,
// W, C) float32, given dh1: dx = dh1 + LN1^T(dh), with per window and head
//   dw = k1 dh1,  do = dw W_proj,  dP = do_h v^T,  dv = P^T do_h,
//   dS = P (dP - rowsum(dP P)),  dq = dS k / sqrt(hd),  dk = dS^T q_scaled,
//   dh = [dq | dk | dv] W_qkv.
//
// Replaces the TPU body `_bwd_attn_kernel` (heart_murmur_detection_tpu/ops/
// pallas_swin_train.py:320) at mm_dtype=float32, where every product runs at
// Precision.HIGHEST with float32 accumulation (prec = HI, :333): the float32
// mode of K8, fused_swin_block_train (:606). There is no rounding point.
//
// Outputs, besides dx: the operand rows of the two weight products, float32
// in window order (h_g = LN1(x), dw_g = k1 dh1, opre_g = the attention
// output before proj, dqkv_g = [dq | dk | dv] in the padded qkv layout, the
// 8 padded columns of each head exact zeros), which swin_wgrad_f32 turns
// into dW_qkv = dqkv^T LN1(x) and dW_proj = dw^T o_pre; and float32 partial
// rows [dbias (heads, 64, 64) | db_qkv (3 heads 32) | db_proj (C) | dLN1 w
// (C) | dLN1 b (C)], one a block of the core's window runs, summed later in
// row order by swin_reduce.
//
// Bound on this card: about 14 C^2 + 768 C operations a token (the qkv
// recompute, do and dh, head dims unpadded, and the six window products)
// against about 6 C bytes in and out, so the operations bind, at the FFMA
// rate (wgmma's float32 input is TF32, which misses Precision.HIGHEST).
// Design, eight grid launches a call, every product an fmaf chain:
//  1. W_proj^T and W_qkv^T into small workspaces (the token-row product of
//     swin_f32_common.cuh computes A W^T; do and dh take the transposes);
//  2. the operand rows LN1(x) and k1 dh1 in window order, a warp a token
//     (the cyclic shift stays in the addressing: row w * 64 + t is token
//     (r, c) of rolled window (i, j), x[(8i+r+s) mod H, (8j+c+s) mod W]);
//  3. qkv = LN1(x) W_qkv^T + b_qkv on the product, into the dqkv rows;
//  4. do = dw W_proj on the product, into a float32 workspace;
//  5. the core, a block of 128 threads per (run of windows, head): for each
//     window of its run, in order, the head's q (scaled by hd^-0.5), k, v
//     and do_h (64 x 24 each) into shared memory, the scores + bias[h] (+
//     mask[window] in the rolled frame), the stable softmax P (a warp a
//     row), o_pre = P v (to opre_g), dv = P^T do_h, dP = do_h v^T, dS
//     (a warp a row), dq, dk; dq | dk | dv overwrite the window's q | k | v
//     in the dqkv rows (read whole before), the padded columns written 0;
//     dS and the dq / dk / dv column sums added to the block's running sums
//     (held by the threads that form them), written to its partial row at
//     the end;
//  6. dh = dqkv W_qkv on the product (K = 3 heads 32, the padded columns
//     zero), into the do workspace;
//  7. the row pass (as many blocks as the core's runs): dx = dh1 + the LN1
//     backward of dh at each token's place, and the column sums db_proj
//     (of k1 dh1), dLN1 w, dLN1 b over a contiguous run of token rows into
//     the same partial rows.
// No atomics; every sum has one order fixed by the shapes, so two launches
// agree bitwise.
#include "swin_f32_common.cuh"

namespace hmdt {
namespace f32 {

constexpr int BHD = 24;             // head dim of every HTS-AT stage
constexpr int BTHREADS = 128;
constexpr int TS = NTOK + 4;        // row stride of a d-major tile read by 8 rows at once
constexpr int PS = NTOK + 1;        // row stride of P and dS
constexpr int OS = 3 * BHD + 1;     // row stride of the dq | dk | dv staging tile

// Shared floats of a core block: q^T (scaled) and do^T (d-major, stride TS),
// k^T and v^T (d-major, 64), q (scaled), k, v and do (row-major, 24), P and
// dS, and the dq | dk | dv staging tile (ops/swin_plan.py::attn_bwd_f32_plan
// computes the same sum).
constexpr size_t core_bwd_floats() {
  return 2 * (size_t)BHD * TS + 2 * (size_t)BHD * NTOK + 4 * (size_t)NTOK * BHD +
         2 * (size_t)NTOK * PS + (size_t)NTOK * OS;
}
constexpr size_t core_bwd_smem_bytes() { return sizeof(float) * core_bwd_floats(); }

// grid (G, heads): block (q, h) walks windows [W q / G, W (q + 1) / G) of
// head h. qkv: the dqkv rows (windows x 64, 3 Cp), q | k | v on entry,
// dq | dk | dv on return; do_ws (windows x 64, C); part (G, part_cols).
__global__ void __launch_bounds__(BTHREADS)
    swin_attn_bwd_f32_core_kernel(float* __restrict__ qkv, const float* __restrict__ do_ws,
                                  float* __restrict__ opre, const float* __restrict__ bias,
                                  const float* __restrict__ mask, float* __restrict__ part,
                                  int windows, int C, int heads, int nw, int part_cols) {
  extern __shared__ float4 smem4[];
  float* QT = reinterpret_cast<float*>(smem4);  // [BHD][TS]
  float* DOT = QT + BHD * TS;                   // [BHD][TS]
  float* KT = DOT + BHD * TS;                   // [BHD][64]
  float* VT = KT + BHD * NTOK;                  // [BHD][64]
  float* QR = VT + BHD * NTOK;                  // [64][BHD]
  float* KR = QR + NTOK * BHD;                  // [64][BHD]
  float* VR = KR + NTOK * BHD;                  // [64][BHD]
  float* DOR = VR + NTOK * BHD;                 // [64][BHD]
  float* P = DOR + NTOK * BHD;                  // [64][PS]
  float* DS = P + NTOK * PS;                    // [64][PS]
  float* OUT = DS + NTOK * PS;                  // [64][OS]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = gridDim.x, q = blockIdx.x, h = blockIdx.y;
  const int w0 = (int)((long long)windows * q / G), w1 = (int)((long long)windows * (q + 1) / G);
  const int Cp = heads * HDP, N3 = 3 * Cp;
  const float scale = 0.2041241452319315f;  // hd^-0.5 in float32, as the forward scales q
  // the score layout (rows ti * 8 + a, columns tj + 16 b) and the row-block
  // layout (rows tr * 4 + a, columns tc + 8 c)
  const int ti = tid >> 4, tj = tid & 15, tr = tid >> 3, tc = tid & 7;
  float dbias[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) dbias[a][b] = 0.f;
  float dbqkv = 0.f;  // thread t < 72: column t of dq | dk | dv
  const float* bh = bias + (size_t)h * NTOK * NTOK;

  for (int w = w0; w < w1; ++w) {
    // q (scaled), k, v and do_h of the window's 64 tokens, both layouts
    for (int idx = tid; idx < NTOK * (BHD / 4); idx += BTHREADS) {
      const int r = idx / (BHD / 4), c = 4 * (idx - r * (BHD / 4));
      const size_t row = (size_t)w * NTOK + r;
      const float* src = qkv + row * N3 + h * HDP + c;
      float4 vq = *reinterpret_cast<const float4*>(src);
      const float4 vk = *reinterpret_cast<const float4*>(src + Cp);
      const float4 vv = *reinterpret_cast<const float4*>(src + 2 * Cp);
      const float4 vd = *reinterpret_cast<const float4*>(do_ws + row * C + h * BHD + c);
      vq.x = __fmul_rn(vq.x, scale);
      vq.y = __fmul_rn(vq.y, scale);
      vq.z = __fmul_rn(vq.z, scale);
      vq.w = __fmul_rn(vq.w, scale);
      const float aq[4] = {vq.x, vq.y, vq.z, vq.w}, ak[4] = {vk.x, vk.y, vk.z, vk.w};
      const float av[4] = {vv.x, vv.y, vv.z, vv.w}, ad[4] = {vd.x, vd.y, vd.z, vd.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        QT[(c + e) * TS + r] = aq[e];
        DOT[(c + e) * TS + r] = ad[e];
        KT[(c + e) * NTOK + r] = ak[e];
        VT[(c + e) * NTOK + r] = av[e];
        QR[r * BHD + c + e] = aq[e];
        KR[r * BHD + c + e] = ak[e];
        VR[r * BHD + c + e] = av[e];
        DOR[r * BHD + c + e] = ad[e];
      }
    }
    __syncthreads();

    // scores + bias (+ mask) into P, and dP = do_h v^T into DS
    {
      float s[8][4], dp[8][4];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll 4
      for (int d = 0; d < BHD; ++d) {
        const float4 q0 = *reinterpret_cast<const float4*>(QT + d * TS + ti * 8);
        const float4 q1 = *reinterpret_cast<const float4*>(QT + d * TS + ti * 8 + 4);
        const float4 o0 = *reinterpret_cast<const float4*>(DOT + d * TS + ti * 8);
        const float4 o1 = *reinterpret_cast<const float4*>(DOT + d * TS + ti * 8 + 4);
        const float qa[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
        const float oa[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
        float kb[4], vb[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          kb[b] = KT[d * NTOK + tj + 16 * b];
          vb[b] = VT[d * NTOK + tj + 16 * b];
        }
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            s[a][b] = fmaf(qa[a], kb[b], s[a][b]);
            dp[a][b] = fmaf(oa[a], vb[b], dp[a][b]);
          }
      }
      const float* mw = mask ? mask + (size_t)(w % nw) * NTOK * NTOK : nullptr;
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int i = ti * 8 + a;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = tj + 16 * b;
          float v = __fadd_rn(s[a][b], bh[i * NTOK + j]);
          if (mw) v = __fadd_rn(v, mw[i * NTOK + j]);
          P[i * PS + j] = v;
          DS[i * PS + j] = dp[a][b];
        }
      }
    }
    __syncthreads();

    // the stable softmax of each row, then dS = P (dP - rowsum(dP P)): a
    // warp a row, two columns a lane
    for (int rr = 0; rr < NTOK / 4; ++rr) {
      const int i = warp * (NTOK / 4) + rr;
      const float s0 = P[i * PS + lane], s1 = P[i * PS + lane + 32];
      float m = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float e0 = expf(s0 - m), e1 = expf(s1 - m);
      const float rc = 1.f / warp_sum(e0 + e1);
      const float p0 = __fmul_rn(e0, rc), p1 = __fmul_rn(e1, rc);
      const float d0 = DS[i * PS + lane], d1 = DS[i * PS + lane + 32];
      const float rs = warp_sum(fmaf(d1, p1, d0 * p0));
      P[i * PS + lane] = p0;
      P[i * PS + lane + 32] = p1;
      DS[i * PS + lane] = p0 * (d0 - rs);
      DS[i * PS + lane + 32] = p1 * (d1 - rs);
    }
    __syncthreads();

    // dbias over the block's windows, in order
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) dbias[a][b] += DS[(ti * 8 + a) * PS + tj + 16 * b];

    // o_pre = P v, dq = dS k * scale (rows tr * 4 + a); dv = P^T do_h, dk =
    // dS^T q_scaled (rows = keys tr * 4 + a); columns tc + 8 c
    {
      float o[4][3], dq[4][3], dv[4][3], dk[4][3];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 3; ++c) o[a][c] = dq[a][c] = dv[a][c] = dk[a][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < NTOK; ++j) {
        float pa[4], sa[4], pt[4], st[4], vj[3], kj[3], dj[3], qj[3];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pa[a] = P[(tr * 4 + a) * PS + j];   // P[i][j], rows i
          sa[a] = DS[(tr * 4 + a) * PS + j];  // dS[i][j]
          pt[a] = P[j * PS + tr * 4 + a];     // P[j][i'], keys i' (j the query)
          st[a] = DS[j * PS + tr * 4 + a];    // dS[j][i']
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          vj[c] = VR[j * BHD + tc + 8 * c];
          kj[c] = KR[j * BHD + tc + 8 * c];
          dj[c] = DOR[j * BHD + tc + 8 * c];
          qj[c] = QR[j * BHD + tc + 8 * c];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            o[a][c] = fmaf(pa[a], vj[c], o[a][c]);
            dq[a][c] = fmaf(sa[a], kj[c], dq[a][c]);
            dv[a][c] = fmaf(pt[a], dj[c], dv[a][c]);
            dk[a][c] = fmaf(st[a], qj[c], dk[a][c]);
          }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = tr * 4 + a;
        float* orow = opre + ((size_t)w * NTOK + i) * C + h * BHD;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int d = tc + 8 * c;
          orow[d] = o[a][c];
          OUT[i * OS + d] = __fmul_rn(dq[a][c], scale);
          OUT[i * OS + BHD + d] = dk[a][c];
          OUT[i * OS + 2 * BHD + d] = dv[a][c];
        }
      }
    }
    __syncthreads();

    // the dq | dk | dv column sums (a window's, then onto the run's), and
    // the rows into dqkv, their padded columns 0
    if (tid < 3 * BHD) {
      float s = 0.f;
      for (int i = 0; i < NTOK; ++i) s += OUT[i * OS + tid];
      dbqkv += s;
    }
    for (int idx = tid; idx < NTOK * 3 * HDP; idx += BTHREADS) {
      const int i = idx / (3 * HDP), rem = idx - i * 3 * HDP, pt = rem / HDP, d = rem - pt * HDP;
      qkv[((size_t)w * NTOK + i) * N3 + pt * Cp + h * HDP + d] =
          d < BHD ? OUT[i * OS + pt * BHD + d] : 0.f;
    }
    __syncthreads();  // the tiles are refilled for the next window
  }

  float* prow = part + (size_t)q * part_cols;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      prow[(size_t)h * NTOK * NTOK + (ti * 8 + a) * NTOK + tj + 16 * b] = dbias[a][b];
  float* pq = prow + (size_t)heads * NTOK * NTOK;
  if (tid < 3 * BHD) pq[(tid / BHD) * Cp + h * HDP + tid % BHD] = dbqkv;
  if (tid < 3 * (HDP - BHD)) {
    const int pt = tid / (HDP - BHD), d = BHD + tid % (HDP - BHD);
    pq[pt * Cp + h * HDP + d] = 0.f;
  }
}

}  // namespace f32
}  // namespace hmdt

// x, dh1, dx (B, H, W, C) float32; kmul (B,) float32; the padded layout of
// ops/swin.py::SwinBlockParams in float32 (w_qkv (3 heads 32, C), b_qkv,
// w_proj (C, C), ln_w, ln_b, bias (heads, 64, 64)); mask (nW, 64, 64) or
// null; the operand rows h_g, dw_g, opre_g (n, C) and dqkv_g (n, 3 heads 32)
// in window order; part (grid, heads 4096 + 3 heads 32 + 3 C); d_ws (n, C),
// wpt_ws (C, C), wqt_ws (C, 3 heads 32) workspaces; the plan
// (ops/swin_plan.py::attn_bwd_f32_plan): the core's runs (grid), threads and
// shared bytes, the product's tile rows, columns, threads and shared bytes,
// the row kernels' threads, each checked against this file's constants.
extern "C" int swin_attn_bwd_f32_launch(
    const void* x, const void* dh1, const void* kmul, void* dx, const void* w_qkv,
    const void* b_qkv, const void* w_proj, const void* ln_w, const void* ln_b, const void* bias,
    const void* mask, void* h_g, void* dw_g, void* opre_g, void* dqkv_g, void* part, void* d_ws,
    void* wpt_ws, void* wqt_ws, int B, int H, int W, int C, int heads, int shift, int grid,
    int core_threads, int core_smem, int tile_rows, int tile_cols, int threads, int gemm_smem,
    int row_threads, void* stream) {
  using namespace hmdt;
  using namespace hmdt::f32;
  if (B <= 0 || H <= 0 || W <= 0 || H % WIN || W % WIN || heads <= 0 || heads * BHD != C ||
      (C != 96 && C != 192 && C != 384) || shift < 0 || shift >= WIN)
    return (int)cudaErrorInvalidValue;
  const WinGeom g{H, W, W / WIN, (H / WIN) * (W / WIN), shift};
  const int windows = B * g.nw, n = windows * NTOK, Cp = heads * HDP;
  if (grid <= 0 || grid > windows || core_threads != BTHREADS ||
      (size_t)core_smem != core_bwd_smem_bytes() || tile_rows != GBM || tile_cols != GBN ||
      threads != GTHREADS || (size_t)gemm_smem != gemm_smem_bytes() || row_threads != RTHREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wq = static_cast<const float*>(w_qkv);
  float* h = static_cast<float*>(h_g);
  float* dw = static_cast<float*>(dw_g);
  float* dqkv = static_cast<float*>(dqkv_g);
  float* d = static_cast<float*>(d_ws);
  float* wpt = static_cast<float*>(wpt_ws);
  float* wqt = static_cast<float*>(wqt_ws);
  float* pt = static_cast<float*>(part);
  const int part_cols = heads * NTOK * NTOK + 3 * Cp + 3 * C;
  static bool attr = false;  // set once, outside any stream capture
  cudaError_t e = cudaSuccess;
  if (!attr) {
    e = cudaFuncSetAttribute(swin_attn_bwd_f32_core_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)core_bwd_smem_bytes());
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  e = launch_transpose(static_cast<const float*>(w_proj), wpt, C, C, s);
  if (e == cudaSuccess) e = launch_transpose(wq, wqt, 3 * Cp, C, s);
  if (e == cudaSuccess)
    e = launch_ln_rows<true>(xf, static_cast<const float*>(dh1), static_cast<const float*>(kmul),
                             static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), h,
                             dw, n, C, H * W, g, 1e-5f, s);
  if (e == cudaSuccess)
    e = launch_rows<EPI_STORE>(h, wq, static_cast<const float*>(b_qkv), dqkv, n, 3 * Cp, C, s);
  if (e == cudaSuccess) e = launch_rows<EPI_STORE>(dw, wpt, nullptr, d, n, C, C, s);
  if (e == cudaSuccess) {
    swin_attn_bwd_f32_core_kernel<<<dim3(grid, heads), BTHREADS, core_bwd_smem_bytes(), s>>>(
        dqkv, d, static_cast<float*>(opre_g), static_cast<const float*>(bias),
        static_cast<const float*>(mask), pt, windows, C, heads, g.nw, part_cols);
    e = cudaGetLastError();
  }
  if (e == cudaSuccess) e = launch_rows<EPI_STORE>(dqkv, wqt, nullptr, d, n, C, 3 * Cp, s);
  if (e == cudaSuccess)
    e = launch_ln_bwd<true>(xf, d, static_cast<const float*>(dh1),
                            static_cast<const float*>(ln_w), dw, nullptr,
                            static_cast<float*>(dx), pt, n, C, 0, part_cols,
                            heads * NTOK * NTOK + 3 * Cp, grid, H * W, g, 1e-5f, s);
  return (int)e;
}
