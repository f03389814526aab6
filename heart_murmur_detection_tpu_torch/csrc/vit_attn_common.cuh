// Shared pieces of the ViT attention kernels vit_attn.cu (the forward core)
// and vit_attn_bwd.cu (the training backward): the head dim, the padded-key
// logit, the bf16 pair packing and the row statistics over a quad. Both keep
// their scores in wgmma accumulators (the layout at the top of
// wgmma_gemm.cuh), whose per-warp layout is that of an m16n8k16 product:
// thread lane = 4 g + t holds columns 2 t, 2 t + 1 of rows g and g + 8 of
// each 8-column block, so the 4 threads of a quad hold one row.
#pragma once

#include <math.h>
#include <stdint.h>

#include "swin_common.cuh"

namespace hmdt {

constexpr int AHD = 64;              // head dim
constexpr float MASK_LOGIT = -1e9f;  // the TPU kernel's padded-key logit

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Merge (max, sum of exp(s - max)) over the 4 threads of a quad (one row).
__device__ __forceinline__ void merge_row_stats(float& m, float& l) {
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, o);
    const float lo = __shfl_xor_sync(0xffffffffu, l, o);
    const float mn = fmaxf(m, mo);
    l = l * expf(m - mn) + lo * expf(mo - mn);
    m = mn;
  }
}

// Sum over the 4 threads of a quad.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

}  // namespace hmdt
