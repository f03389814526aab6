// Shared pieces of the HTS-AT swin kernels (swin_attn.cu, swin_mlp.cu and
// the training backward: swin_attn_bwd.cu, swin_mlp_bwd.cu through
// swin_bwd_common.cuh) and of the MAE ViT kernels (swin_mlp.cu serves as
// the ViT MLP half with LayerNorm eps 1e-6; vit_qkv.cu, vit_attn.cu and
// vit_attn_bwd.cu take the warp sums and limits). Every product runs on
// wgmma through wgmma_gemm.cuh.
//
// Every kernel takes bfloat16 activations and weights and keeps LayerNorm,
// softmax, GELU and every accumulator in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace hmdt {

using bf16 = __nv_bfloat16;

constexpr int WIN = 8;                  // window side
constexpr int NTOK = WIN * WIN;         // tokens per window
constexpr int HDP = 32;                 // head dim padded to two MMA k-steps
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr size_t SMEM_LIMIT = 232448;   // 227 KB of dynamic shared memory per block on sm_90

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm's affine step (x - mu) * rstd * w + b, and a branch added to
// the residual, x + k * branch, each product rounded before the add as the
// plain torch versions round them (no fused multiply-add).
__device__ __forceinline__ float ln_affine(float v, float mu, float rstd, float w, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(v - mu, rstd), w), b);
}
__device__ __forceinline__ float add_scaled(float x, float k, float branch) {
  return __fadd_rn(x, __fmul_rn(k, branch));
}

// The exact GELU, float32 (erff).
__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

}  // namespace hmdt
