// vit_proj: the proj product, bias and residual of a ViT block's attention
// half, out = bf16(x + (o_pre W_proj^T + b_proj)), o_pre (rows, C) the
// per-head attention outputs of vit_attn.cu (head h in columns 64 h ..),
// W_proj (C, C) in the torch (out, in) layout, x and out (rows, C), all
// bf16; b_proj float32. The product accumulates in float32; the bias, then
// x, are added in float32 and the sum is rounded once.
//
// Replaces the proj and residual of the ViT attention body `_attn_half`
// (heart_murmur_detection_tpu/ops/pallas_vit.py:66), which the TPU kernels
// K5 / K6 (and K10 / K11's attention halves) run after the attention in
// the same body.
//
// Bound on this card: 2 rows C^2 operations against 6 rows C bytes (o_pre,
// x, out) and the weights: about C / 3 = 128-256 FLOP a byte, so close to
// the line between the two at C = 384 and the operations at C = 768. Design:
// the wgmma GEMM core of wgmma_gemm.cuh with both operands K-major (o_pre's
// rows and the weight's rows run along K = C), a 128 x 128 output tile a
// block over all of K (6 or 12 stages of 64), the blocks of one row tile
// adjacent in the grid so o_pre's rows come from L2 after the first; the
// epilogue reads x and writes out straight from the accumulator registers.
// No split-K: each output element is one block's sum, so two launches agree
// bitwise.
#include "wgmma_gemm.cuh"

namespace hmdt {

using namespace hop;

// grid (C / 128, ceil(rows / 128)): blockIdx.x the column tile.
__global__ void __launch_bounds__(THREADS, 2)
vit_proj_kernel(const __grid_constant__ CUtensorMap to, const __grid_constant__ CUtensorMap tw,
                const bf16* __restrict__ x, const float* __restrict__ b_proj,
                bf16* __restrict__ out, int rows, int C) {
  extern __shared__ uint8_t smem_raw[];
  GemmSmem<1>& sm = gemm_smem<1>(smem_raw);
  gemm_init(sm);
  __syncthreads();
  const int n0 = blockIdx.x * GEMM_COLS, m0 = blockIdx.y * GemmCfg<1>::ROWS;
  float acc[1][64];
  gemm_core<false, false, 1>(sm, &to, &tw, m0, n0, 0, C / GEMM_BK, acc);
  if (threadIdx.x >= CONSUMERS) return;
  acc_pairs(acc[0], m0 + (threadIdx.x / 128) * 64, n0, [&](int row, int col, float v0, float v1) {
    if (row >= rows) return;
    const float2 bias = *reinterpret_cast<const float2*>(b_proj + col);
    const size_t off = (size_t)row * C + col;
    const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + off));
    *reinterpret_cast<__nv_bfloat162*>(out + off) =
        __floats2bfloat162_rn(xv.x + (v0 + bias.x), xv.y + (v1 + bias.y));
  });
}

}  // namespace hmdt

// C interface for ctypes. Returns cudaGetLastError() after the launch (0 on
// success), or the error that stopped it before. o, x and out (rows, C)
// bf16, out distinct from both; w (C, C) bf16; b (C,) f32; C a multiple of
// 128.
extern "C" int vit_proj_launch(const void* o, const void* x, void* out, const void* w,
                               const void* b, int rows, int C, void* stream) {
  using namespace hmdt;
  constexpr int R = GemmCfg<1>::ROWS;
  if (rows <= 0 || C <= 0 || C % GEMM_COLS || (rows + R - 1) / R > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mo, mw;
  const uint64_t d_o[2] = {(uint64_t)C, (uint64_t)rows}, d_w[2] = {(uint64_t)C, (uint64_t)C};
  const uint32_t box[2] = {BOX, BOX};
  int err = make_tensor_map(&mo, o, 2, d_o, box);
  if (!err) err = make_tensor_map(&mw, w, 2, d_w, box);
  if (err) return err;
  constexpr size_t smem = gemm_smem_bytes<1>();
  cudaError_t e = cudaFuncSetAttribute(vit_proj_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(C / GEMM_COLS, (rows + R - 1) / R);
  vit_proj_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      mo, mw, static_cast<const bf16*>(x), static_cast<const float*>(b),
      static_cast<bf16*>(out), rows, C);
  return (int)cudaGetLastError();
}
