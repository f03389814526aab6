// Shared pieces of the HTS-AT swin kernels (swin_attn.cu, swin_mlp.cu and
// the training backward: swin_attn_bwd.cu, swin_mlp_bwd.cu) and of the MAE
// ViT kernels (swin_mlp.cu serves as the ViT MLP half with LayerNorm eps
// 1e-6; vit_qkv.cu, vit_attn.cu and vit_attn_bwd.cu take the warp sums and
// limits). The wgmma kernels (swin_wgrad.cu, vit_proj.cu, vit_qkv.cu,
// vit_attn.cu, vit_attn_bwd.cu) take their products from wgmma_gemm.cuh.
//
// Both kernels take bfloat16 activations and weights and keep LayerNorm,
// softmax, GELU and every accumulator in float32. In-kernel products are
// WMMA 16x16x16 bf16 tiles with float32 accumulation; a warp writes its
// accumulator tile to a private 16x16 float32 staging area in shared memory
// and applies the epilogue (bias, rounding, GELU, residual) from there.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>

namespace hmdt {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int WIN = 8;                  // window side
constexpr int NTOK = WIN * WIN;         // tokens per window
constexpr int HDP = 32;                 // head dim padded to two MMA k-steps
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int PAD = 8;                  // bf16 row padding (16 bytes) against bank conflicts
constexpr size_t SMEM_LIMIT = 232448;   // 227 KB of dynamic shared memory per block on sm_90

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Row tiles that share one weight fragment: a warp's unit of work is one
// 16-wide column tile times `row_group` row tiles, so each fragment loaded
// from L2 feeds that many MMAs. The largest group that still splits the
// units evenly over the warps.
__host__ __device__ constexpr int row_group(int row_tiles, int col_tiles) {
  for (int g = row_tiles; g > 1; --g)
    if (row_tiles % g == 0 && (col_tiles * (row_tiles / g)) % NWARPS == 0) return g;
  return 1;
}

// Whether to spread one work unit (a window, a token tile) over a cluster of
// cs blocks: only while the clustered grid stays within two waves of the
// card. Past that the card is already full, and the cluster's extra
// traffic (gathers, partial sums, repeated LayerNorms) costs more than it
// spreads (measured on an H100 at the HTS-AT stage shapes, B = 16 and 64).
inline bool use_cluster(long units, int cs) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return false;
  return cs > 1 && units * cs <= 2L * sms;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// LayerNorm of one token's C channels by one warp: float32 mean, then the
// mean of squared deviations, (x - mu) * rstd * w + b with
// rstd = rsqrt(var + eps), rounded to bf16 into dst (a shared-memory row).
// mu_out / rstd_out (may be null) receive the statistics from lane 0. eps is
// 1e-5 for the swin blocks (the default) and 1e-6 for the ViT blocks.
template <int C>
__device__ __forceinline__ void ln_token(const bf16* __restrict__ src,
                                         const float* __restrict__ w,
                                         const float* __restrict__ b,
                                         bf16* dst, int lane,
                                         float* mu_out = nullptr,
                                         float* rstd_out = nullptr,
                                         float eps = 1e-5f) {
  static_assert(C % 32 == 0, "C must be a multiple of 32");
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
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = lane + 32 * i;
    dst[c] = __float2bfloat16((v[i] - mu) * rstd * w[c] + b[c]);
  }
  if (mu_out && lane == 0) {
    *mu_out = mu;
    *rstd_out = rstd;
  }
}

// Copy rows of a shared-memory bf16 tile (row stride lds) to consecutive
// global rows of `cols` elements, in 16-byte pieces.
__device__ __forceinline__ void copy_rows_out(const bf16* src, int lds, bf16* dst,
                                              int rows, int cols) {
  const int vec = cols / 8;
  for (int i = threadIdx.x; i < rows * vec; i += blockDim.x) {
    const int r = i / vec;
    reinterpret_cast<int4*>(dst + (size_t)r * cols)[i % vec] =
        reinterpret_cast<const int4*>(src + (size_t)r * lds)[i % vec];
  }
}

// The exact GELU and its derivative, float32 (erff).
__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float gelu_exact_grad(float v) {
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * expf(-0.5f * v * v) * 0.3989422804014327f;
}

}  // namespace hmdt
