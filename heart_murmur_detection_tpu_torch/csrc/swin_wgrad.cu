// swin_wgrad and swin_reduce: the weight gradients of the training swin
// backward without unordered atomics.
//
//   swin_wgrad   ws[s] = A[chunk s]^T B[chunk s] for A (n, M), B (n, N) bf16
//                rows of per-token operands (swin_attn_bwd.cu,
//                swin_mlp_bwd.cu), over fixed chunks of `chunk` tokens, into
//                float32 partials ws (S, M, N).
//   swin_reduce  out[l] = ws[0][l] + ws[1][l] + ... + ws[S-1][l], float32, in
//                that order: the split-K partials above, and the per-block
//                column-sum rows of the two backward kernels.
//
// Together they replace the weight-gradient accumulation of the TPU
// backward bodies `_bwd_mlp_kernel` (:271) and `_bwd_attn_kernel` (:320) of
// heart_murmur_detection_tpu/ops/pallas_swin_train.py (K8), which sum into a
// VMEM block that stays resident across the TPU's sequential grid. Each
// partial is written by one block and each output element is summed by one
// thread in a fixed order, so two runs give bitwise-equal gradients.
//
// Design. swin_wgrad: a block of 4 warps owns one 32 x 32 output tile of one
// chunk; per step it stages 64 token rows of the tile's A and B columns in
// shared memory (16-byte loads) and each warp adds four 16x16x16 WMMA
// products into its float32 accumulator (A read transposed, col_major).
// Bound on this card: 2 M N n FLOPs against (M + N) n bf16 bytes read once
// per output tile row / column, so the products dominate for these shapes;
// this first version has no multi-stage pipeline and is bound by the
// latency of its loads. swin_reduce reads S L floats once: bound by HBM.
#include "swin_common.cuh"

namespace hmdt {

constexpr int WT = 32;          // output tile side
constexpr int KT = 64;          // token rows a step
constexpr int LDW = WT + PAD;   // bf16 row stride of the staged operands
constexpr int WG_THREADS = 128;

__global__ void __launch_bounds__(WG_THREADS)
swin_wgrad_kernel(const bf16* __restrict__ a, const bf16* __restrict__ bm,
                  float* __restrict__ ws, int n, int M, int N, int chunk) {
  __shared__ __align__(128) bf16 as[KT * LDW];
  __shared__ __align__(128) bf16 bs[KT * LDW];
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int n0 = blockIdx.x * WT;
  const int m0 = blockIdx.y * WT;
  const int s = blockIdx.z;
  const int t_beg = s * chunk;
  const int t_end = min(n, t_beg + chunk);
  FragC acc;
  wmma::fill_fragment(acc, 0.f);
  for (int t0 = t_beg; t0 < t_end; t0 += KT) {
    // 64 rows x 32 columns of each operand: 4 pieces of 16 bytes a row
    for (int i = threadIdx.x; i < KT * 4; i += WG_THREADS) {
      const int r = i >> 2;
      const int q = i & 3;
      reinterpret_cast<int4*>(as + r * LDW)[q] =
          reinterpret_cast<const int4*>(a + (size_t)(t0 + r) * M + m0)[q];
      reinterpret_cast<int4*>(bs + r * LDW)[q] =
          reinterpret_cast<const int4*>(bm + (size_t)(t0 + r) * N + n0)[q];
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < KT; k0 += 16) {
      FragAc fa;
      FragBr fb;
      wmma::load_matrix_sync(fa, as + k0 * LDW + wm * 16, LDW);
      wmma::load_matrix_sync(fb, bs + k0 * LDW + wn * 16, LDW);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    __syncthreads();
  }
  wmma::store_matrix_sync(ws + ((size_t)s * M + m0 + wm * 16) * N + n0 + wn * 16, acc, N,
                          wmma::mem_row_major);
}

__global__ void swin_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                   int S, int L) {
  for (int l = blockIdx.x * blockDim.x + threadIdx.x; l < L; l += gridDim.x * blockDim.x) {
    float s = ws[l];
    for (int i = 1; i < S; ++i) s += ws[(size_t)i * L + l];
    out[l] = s;
  }
}

}  // namespace hmdt

// C interfaces for ctypes. Each returns cudaGetLastError() after the launch
// (0 on success).
// a (n, M), b (n, N) bf16 row-major; ws (ceil(n / chunk), M, N) f32; n and
// chunk multiples of 64, M and N multiples of 32.
extern "C" int swin_wgrad_launch(const void* a, const void* b, void* ws, int n, int M,
                                 int N, int chunk, void* stream) {
  using namespace hmdt;
  if (n <= 0 || n % KT || M <= 0 || M % WT || N <= 0 || N % WT || chunk <= 0 || chunk % KT)
    return (int)cudaErrorInvalidValue;
  const int S = (n + chunk - 1) / chunk;
  dim3 grid(N / WT, M / WT, S);
  swin_wgrad_kernel<<<grid, WG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<float*>(ws), n,
      M, N, chunk);
  return (int)cudaGetLastError();
}

// ws (S, L) f32 -> out (L,) f32.
extern "C" int swin_reduce_launch(const void* ws, void* out, int S, int L, void* stream) {
  using namespace hmdt;
  if (S <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int need = (L + threads - 1) / threads;
  const int blocks = need < 8192 ? need : 8192;
  swin_reduce_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), S, L);
  return (int)cudaGetLastError();
}
