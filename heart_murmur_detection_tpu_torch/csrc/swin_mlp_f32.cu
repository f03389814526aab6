// swin_mlp_f32: the MLP half of an HTS-AT swin block in float32,
//   out = x + k[b] * (GELU(LN2(x) W_fc1^T + b_fc1) W_fc2^T + b_fc2),
//   per token of x (n, C) float32; k an optional per-sample multiplier
//   (null in eval), b = token / hw.
//
// Replaces the MLP body `_strip_mlp` (heart_murmur_detection_tpu/ops/
// pallas_swin.py:388) at mm_dtype=float32 (Precision.HIGHEST with float32
// accumulation, :394-395): the float32 mode of the TPU kernels
// fused_swin_block (:480), fused_swin_pair (:847) and fused_swin_block_split
// (:618, MLP half). Float32 operands, float32 accumulation, exact GELU
// (erff), LN2 from two-pass float32 row statistics, eps 1e-5.
//
// Bound on this card: 16 C^2 operations a token against 8 C bytes, so the
// operations bind, at the FFMA rate (wgmma's float32 input is TF32, which
// misses Precision.HIGHEST). Design: two grid launches of the product of
// swin_f32_common.cuh, with the GELU output in a float32 HBM workspace
// (n, 4 C) between them. A fused panel (fc2's 64 x C sums held in
// registers across the hidden chunks) does not fit at C >= 384 (96 or 192
// accumulators a thread), and splitting fc2's output columns over blocks
// would recompute fc1 per split; the workspace keeps one fc1 product for
// every width, at 32 C bytes a token of extra traffic, against 16 C^2
// operations:
//  1. fc1: LN2(x) over K = C (each block normalises its 64 rows as it
//     stages them, from the statistics it computes first), + b_fc1, GELU;
//  2. fc2: over K = 4 C, + b_fc2, times k, + x.
// No atomics; every sum has one order, so two launches agree bitwise.
//
// The same launch is the float32 MLP half of the ViT blocks (vit_mlp_f32 in
// ops/vit.py: `_mlp_half`, heart_murmur_detection_tpu/ops/pallas_vit.py:149,
// at mm_dtype=float32) with eps 1e-6 and kmul null; its token count is then
// B Np, a multiple of 16 (the last row tile of each product is partial).
#include "swin_f32_common.cuh"

// x, out (n, C) float32; g_ws (n, hidden) float32 workspace; ln_w, ln_b,
// b_fc1, b_fc2 float32; w_fc1 (hidden, C), w_fc2 (C, hidden) float32; kmul
// (B,) or null; n_tokens a multiple of 16; the plan (ops/swin_plan.py::
// mlp_f32_plan, ops/vit_plan.py::mlp_f32_plan): the tile rows,
// columns, threads and shared bytes, checked against the compiled ones.
extern "C" int swin_mlp_f32_launch(const void* x, void* out, void* g_ws, const void* ln_w,
                                   const void* ln_b, const void* w_fc1, const void* b_fc1,
                                   const void* w_fc2, const void* b_fc2, const void* kmul,
                                   int n_tokens, int C, int hidden, int hw, int tile_rows,
                                   int tile_cols, int threads, int smem, float eps, void* stream) {
  using namespace hmdt::f32;
  if (n_tokens <= 0 || n_tokens % 16 || C % GBN || hidden % GBN || C % GBK || hidden % GBK ||
      hw <= 0)
    return (int)cudaErrorInvalidValue;
  if (tile_rows != GBM || tile_cols != GBN || threads != GTHREADS ||
      (size_t)smem != gemm_smem_bytes())
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const WinGeom none{0, 0, 1, 1, 0};
  const float* xf = static_cast<const float*>(x);
  float* g = static_cast<float*>(g_ws);
  cudaError_t e = launch_gemm<true, EPI_GELU, false>(
      xf, static_cast<const float*>(w_fc1), static_cast<const float*>(b_fc1),
      static_cast<const float*>(ln_w), static_cast<const float*>(ln_b), nullptr, nullptr, g,
      n_tokens, hidden, C, hw, none, eps, s);
  if (e != cudaSuccess) return (int)e;
  e = launch_gemm<false, EPI_RESID, false>(
      g, static_cast<const float*>(w_fc2), static_cast<const float*>(b_fc2), nullptr, nullptr, xf,
      static_cast<const float*>(kmul), static_cast<float*>(out), n_tokens, C, hidden, hw, none,
      0.f, s);
  return (int)e;
}
