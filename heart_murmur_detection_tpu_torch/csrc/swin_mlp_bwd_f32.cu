// swin_mlp_bwd_f32: the backward of the MLP half of an HTS-AT swin block in
// float32,
//   y = h1 + k[b] * (GELU(LN2(h1) W1^T + b1) W2^T + b2),  given dy:
//   dh1 = dy + LN2_bwd(da1 W1),  da1 = (k dy) W2 * GELU'(a1),
// per token of h1, dy (n, C) float32; k an optional per-sample multiplier
// (null: 1), b = token / hw.
//
// Replaces the TPU body `_bwd_mlp_kernel` (heart_murmur_detection_tpu/ops/
// pallas_swin_train.py:271) at mm_dtype=float32, where every product runs at
// Precision.HIGHEST with float32 accumulation (prec = HI, :283): the float32
// mode of K8, fused_swin_block_train (:606). There is no rounding point:
// operands, accumulators and every emitted row are float32.
//
// Bound on this card: 24 n C^2 operations (the fc1 recompute and two data
// products, hidden 4 C) against about 12 n C bytes, so the operations bind,
// at the FFMA rate (wgmma's float32 input is TF32, which misses
// Precision.HIGHEST). Design: the token-row product of swin_f32_common.cuh
// for every product, with the hidden-wide rows in HBM between them (they
// are the weight products' operands anyway), seven grid launches a call:
//  1. W1^T (C, hidden) and W2^T (hidden, C) into small workspaces: the
//     product computes A W^T, so dg = (k dy) W2 and dm = da1 W1 take the
//     transposes as their W (two transpose launches);
//  2. the operand rows LN2(h1) and k dy (a warp a token);
//  3. fc1 recomputed: a1 = LN2(h1) W1^T + b1 -> GELU(a1) (an operand row)
//     and a1 kept in the da1 rows;
//  4. dg = (k dy) W2, times GELU'(a1) read from and written back to the
//     da1 rows in place: da1;
//  5. dm = da1 W1 into a float32 workspace;
//  6. the row pass: dh1 = dy + the LN2 backward of dm, and each block's
//     partial row [db1 | db2 | dLN2 w | dLN2 b] (the column sums of da1,
//     k dy, dm * xhat and dm over its contiguous run of tokens) for
//     swin_reduce.
// The weight gradients are swin_wgrad_f32's (da1^T LN2(h1), (k dy)^T
// GELU(a1)). No atomics; every sum has one order fixed by the shapes, so
// two launches agree bitwise.
//
// The same launch is the float32 MLP backward of the ViT training block
// (vit_mlp_bwd_f32 in ops/vit_train.py: `_bwd_mlp_common`,
// heart_murmur_detection_tpu/ops/pallas_vit_train.py:163, at
// mm_dtype=float32), with kmul null, eps 1e-6 and hw the padded tokens a
// clip; at C 96-384 for the swin blocks, 384 and 768 for the ViT blocks.
#include "swin_f32_common.cuh"

// h1, dy, dh1 (n, C) float32; kmul (B,) or null; ln_w, ln_b, b_fc1 float32;
// w_fc1 (hidden, C), w_fc2 (C, hidden) float32; the operand rows m_g =
// LN2(h1), dyk_g = k dy (n, C) and g_g = GELU(a1), da1_g (n, hidden); part
// (grid, hidden + 3 C); dm_ws (n, C), w1t_ws (C, hidden), w2t_ws (hidden, C)
// workspaces; hw tokens a sample; the plan (ops/swin_plan.py::
// mlp_bwd_f32_plan): the row pass's blocks, the product's tile rows,
// columns, threads and shared bytes, the row kernels' threads, each checked
// against this file's constants.
extern "C" int swin_mlp_bwd_f32_launch(const void* h1, const void* dy, const void* kmul, void* dh1,
                                       const void* ln_w, const void* ln_b, const void* w_fc1,
                                       const void* b_fc1, const void* w_fc2, void* m_g, void* g_g,
                                       void* dyk_g, void* da1_g, void* part, void* dm_ws,
                                       void* w1t_ws, void* w2t_ws, int n, int C, int hidden,
                                       int hw, int grid, int tile_rows, int tile_cols, int threads,
                                       int smem, int row_threads, float eps, void* stream) {
  using namespace hmdt::f32;
  if (n <= 0 || n % GBM || (C != 96 && C != 192 && C != 384 && C != 768) || hidden <= 0 ||
      hidden % GBN || hw <= 0 || grid <= 0 || grid > n)
    return (int)cudaErrorInvalidValue;
  if (tile_rows != GBM || tile_cols != GBN || threads != GTHREADS ||
      (size_t)smem != gemm_smem_bytes() || row_threads != RTHREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(h1);
  const float* w1 = static_cast<const float*>(w_fc1);
  float* m = static_cast<float*>(m_g);
  float* dyk = static_cast<float*>(dyk_g);
  float* g = static_cast<float*>(g_g);
  float* da1 = static_cast<float*>(da1_g);
  float* dm = static_cast<float*>(dm_ws);
  float* w1t = static_cast<float*>(w1t_ws);
  float* w2t = static_cast<float*>(w2t_ws);
  const WinGeom none{0, 0, 1, 1, 0};
  cudaError_t e = launch_transpose(w1, w1t, hidden, C, s);
  if (e == cudaSuccess) e = launch_transpose(static_cast<const float*>(w_fc2), w2t, C, hidden, s);
  if (e == cudaSuccess)
    e = launch_ln_rows<false>(h, static_cast<const float*>(dy), static_cast<const float*>(kmul),
                              static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), m,
                              dyk, n, C, hw, none, eps, s);
  if (e == cudaSuccess)
    e = launch_rows<EPI_GELU_KEEP>(m, w1, static_cast<const float*>(b_fc1), g, n, hidden, C, s, da1);
  if (e == cudaSuccess) e = launch_rows<EPI_DGELU>(dyk, w2t, nullptr, da1, n, hidden, C, s);
  if (e == cudaSuccess) e = launch_rows<EPI_STORE>(da1, w1t, nullptr, dm, n, C, hidden, s);
  if (e == cudaSuccess)
    e = launch_ln_bwd<false>(h, dm, static_cast<const float*>(dy),
                             static_cast<const float*>(ln_w), dyk, da1, static_cast<float*>(dh1),
                             static_cast<float*>(part), n, C, hidden, hidden + 3 * C, hidden, grid,
                             hw, none, eps, s);
  return (int)e;
}
