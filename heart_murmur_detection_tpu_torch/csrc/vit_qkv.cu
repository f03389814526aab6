// vit_qkv: LayerNorm 1 and the qkv product of a ViT block's attention half,
//   [q | k | v] = LN1(x) W_qkv^T + b_qkv,  x (n_tokens, C) bf16 (n_tokens = B Np),
//   LN eps an argument (1e-6 for the MAE encoders); the q rows of W_qkv and
//   the q part of b_qkv carry 1/sqrt(hd), folded in at weight load.
//   Written head-major: qkv (3, B, heads, Np, 64) bf16.
//
// Replaces the LN1 and qkv part of the ViT attention body `_attn_half`
// (heart_murmur_detection_tpu/ops/pallas_vit.py:66) that the TPU kernels
// fused_vit_block (:296, K5) and fused_vit_attn (:341, K6) run. The TPU kept
// q, k and v of a whole sequence in VMEM; on Hopper they go once through
// device memory in the layout vit_attn.cu streams (each head's rows of one
// clip contiguous).
//
// Design. A block of 8 warps takes a tile of 64 tokens and one third of the
// output columns (blockIdx.y: q, k or v; LN1 is recomputed by each third,
// which is cheap beside the product). It keeps LN1 of the tile in shared
// memory as bf16 (float32 statistics), then each warp takes 16-wide weight
// column tiles against all 4 row tiles of the tile, so each weight fragment
// read from L2 feeds 4 bf16 WMMA products with float32 accumulation. The
// epilogue adds the float32 bias and rounds once to bf16, as the TPU body
// does before its `.astype(act_dtype)`.
//
// Bound on this card: 6 C^2 FLOPs a token against 8 C bytes of traffic (x
// in, q/k/v out), so the operations bound it (0.06 ms for the operaGT batch
// of 64 clips); this version is bound by the latency of the weight reads
// from L2 and by WMMA issue. Later work: wgmma with TMA-fed weight tiles and
// larger token tiles.
#include "swin_common.cuh"

namespace hmdt {

constexpr int QKV_T = 64;   // tokens a block
constexpr int VIT_HD = 64;  // head dim of the ViT kernels

template <int C>
struct QkvSmem {
  static constexpr int LDX = C + PAD;
  static constexpr size_t XN = (size_t)QKV_T * LDX * 2;
  static constexpr size_t STAGE = (size_t)NWARPS * 256 * 4;
  static constexpr size_t bytes = XN + STAGE;
  static_assert(XN % 128 == 0, "regions must stay 128-byte aligned");
  static_assert(bytes <= SMEM_LIMIT, "shared memory over the sm_90 limit");
};

template <int C>
__global__ void __launch_bounds__(NTHREADS)
vit_qkv_kernel(const bf16* __restrict__ x, bf16* __restrict__ qkv,
               const bf16* __restrict__ w, const float* __restrict__ bias,
               const float* __restrict__ ln_w, const float* __restrict__ ln_b,
               int n_tokens, int Np, int heads, float eps) {
  using L = QkvSmem<C>;
  constexpr int RT = QKV_T / 16;  // row tiles
  constexpr int CT = C / 16;      // column tiles of one third
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xn = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* stage = reinterpret_cast<float*>(smem + L::XN) + warp * 256;
  const int tok0 = blockIdx.x * QKV_T;
  const int which = blockIdx.y;  // 0 q, 1 k, 2 v
  const int B = n_tokens / Np;

  // LN1 of the tile's tokens -> xn (rows past n_tokens are zero)
  for (int t = warp; t < QKV_T; t += NWARPS) {
    const int tok = tok0 + t;
    if (tok < n_tokens) {
      ln_token<C>(x + (size_t)tok * C, ln_w, ln_b, xn + t * L::LDX, lane, nullptr, nullptr, eps);
    } else {
      for (int c = lane; c < C; c += 32) xn[t * L::LDX + c] = __float2bfloat16(0.f);
    }
  }
  __syncthreads();

  for (int ct = warp; ct < CT; ct += NWARPS) {
    const int n0 = which * C + ct * 16;  // first weight row (output feature)
    FragC acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) wmma::fill_fragment(acc[r], 0.f);
#pragma unroll 2
    for (int k0 = 0; k0 < C; k0 += 16) {
      FragBc bw;
      wmma::load_matrix_sync(bw, w + (size_t)n0 * C + k0, C);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        FragA a;
        wmma::load_matrix_sync(a, xn + r * 16 * L::LDX + k0, L::LDX);
        wmma::mma_sync(acc[r], a, bw, acc[r]);
      }
    }
    // + bias, one rounding, head-major store: column c of the third is
    // head c / 64, dim c % 64
    const int h = (ct * 16) / VIT_HD;
    const int d0 = (ct * 16) % VIT_HD;
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
          const size_t off = ((((size_t)which * B + b) * heads + h) * Np + t) * VIT_HD + d0 + c;
          qkv[off] = __float2bfloat16(stage[e] + bias[n0 + c]);
        }
      }
      __syncwarp();
    }
  }
}

template <int C>
static cudaError_t launch_qkv(const void* x, void* qkv, const void* w, const void* b,
                              const void* ln_w, const void* ln_b, int n_tokens, int Np,
                              int heads, float eps, cudaStream_t stream) {
  const size_t smem = QkvSmem<C>::bytes;
  auto kernel = vit_qkv_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_tokens + QKV_T - 1) / QKV_T, 3);
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(qkv), static_cast<const bf16*>(w),
      static_cast<const float*>(b), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), n_tokens, Np, heads, eps);
  return cudaGetLastError();
}

}  // namespace hmdt

// C interface for ctypes. Returns cudaGetLastError() after the launch (0 on
// success). x (n_tokens, C) bf16 with n_tokens = B * Np; qkv (3, B, heads,
// Np, 64) bf16; w (3C, C) bf16; b, ln_w, ln_b float32.
extern "C" int vit_qkv_launch(const void* x, void* qkv, const void* w_qkv,
                              const void* b_qkv, const void* ln_w, const void* ln_b,
                              int n_tokens, int Np, int C, int heads, float eps,
                              void* stream) {
  using namespace hmdt;
  if (n_tokens <= 0 || Np <= 0 || n_tokens % Np || heads * VIT_HD != C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 384:
      return (int)launch_qkv<384>(x, qkv, w_qkv, b_qkv, ln_w, ln_b, n_tokens, Np, heads, eps, s);
    case 768:
      return (int)launch_qkv<768>(x, qkv, w_qkv, b_qkv, ln_w, ln_b, n_tokens, Np, heads, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
