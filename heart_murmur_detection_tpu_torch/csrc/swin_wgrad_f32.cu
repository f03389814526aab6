// swin_wgrad_f32: the float32 weight products of the training swin block,
// out = A^T B for A (n, M), B (n, N) float32 rows of per-token operands
// (swin_attn_bwd_f32.cu, swin_mlp_bwd_f32.cu), float32 (M, N).
//
// With swin_reduce (swin_wgrad.cu) it replaces the weight-gradient
// accumulation of the TPU backward bodies `_bwd_mlp_kernel` (:271) and
// `_bwd_attn_kernel` (:320) of heart_murmur_detection_tpu/ops/
// pallas_swin_train.py at mm_dtype=float32 (K8's float32 mode), which sum
// into a VMEM block that stays resident across the TPU's sequential grid,
// at Precision.HIGHEST.
//
// Bound on this card: 2 n M N operations against 4 n (M + N) bytes; at the
// COLA shapes (M, N in {C, 4 C}, C >= 96) the operations bind, at the FFMA
// rate (wgmma's float32 input is TF32, which misses Precision.HIGHEST).
// Design, two grid launches a call:
//  1. grid (tiles, S): a block of 192 threads computes one 96 x 96 output
//     tile over one fixed token chunk (ops/swin_plan.py::wgrad_f32_plan: S
//     chunks of `chunk` tokens, fixed by (n, M, N) alone, so that the
//     narrow stage-0 products still fill the card), 16 tokens a step through
//     shared memory (both operands are token-major already: each step is a
//     copy of 16 rows), 8 x 6 accumulators a thread, each step's 16 terms
//     summed apart and then added to the running sum (the float32 forward's
//     product does the same); the chunk's partial tile goes to a float32
//     workspace (S, M, N), or straight to out when S = 1;
//  2. swin_reduce_launch sums the S partials of each element in chunk
//     order.
// No atomics; every element has one order of summation, so two launches
// agree bitwise.
#include <cuda_runtime.h>
#include <stddef.h>

extern "C" int swin_reduce_launch(const void* ws, void* out, int S, int L, void* stream);

namespace hmdt {
namespace f32 {

constexpr int WT = 96;          // output tile rows and columns
constexpr int WK = 16;          // tokens a step
constexpr int WTHREADS = 192;   // 12 row groups of 8 x 16 column groups of 6
constexpr int WTM = 8;           // accumulator rows of a thread
constexpr int WTN = 6;           // accumulator columns of a thread
constexpr int WS = WT + 4;      // row stride of a staged step

// grid (M / 96 * N / 96, S): blockIdx.x the tile (row-major over the tile
// grid), blockIdx.y the chunk [s chunk, min(n, (s + 1) chunk)).
__global__ void __launch_bounds__(WTHREADS)
    swin_wgrad_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                          float* __restrict__ out, int n, int M, int N, int chunk) {
  __shared__ __align__(16) float As[WK][WS];
  __shared__ __align__(16) float Bs[WK][WS];
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int tn = N / WT;
  const int m0 = (blockIdx.x / tn) * WT, n0 = (blockIdx.x % tn) * WT;
  const int s = blockIdx.y, t0 = s * chunk, t1 = min(n, t0 + chunk);
  float acc[WTM][WTN];
#pragma unroll
  for (int i = 0; i < WTM; ++i)
#pragma unroll
    for (int j = 0; j < WTN; ++j) acc[i][j] = 0.f;

  for (int k0 = t0; k0 < t1; k0 += WK) {
    // 16 token rows of 96 columns of a and b: 384 float4s each
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int idx = tid + WTHREADS * u, r = idx / (WT / 4), c = 4 * (idx % (WT / 4));
      *reinterpret_cast<float4*>(&As[r][c]) =
          *reinterpret_cast<const float4*>(a + (size_t)(k0 + r) * M + m0 + c);
      *reinterpret_cast<float4*>(&Bs[r][c]) =
          *reinterpret_cast<const float4*>(b + (size_t)(k0 + r) * N + n0 + c);
    }
    __syncthreads();
    float part[WTM][WTN];
#pragma unroll
    for (int i = 0; i < WTM; ++i)
#pragma unroll
      for (int j = 0; j < WTN; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < WK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][tr * WTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][tr * WTM + 4]);
      const float av[WTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[WTN];
#pragma unroll
      for (int j = 0; j < WTN; ++j) bv[j] = Bs[kk][tc + 16 * j];
#pragma unroll
      for (int i = 0; i < WTM; ++i)
#pragma unroll
        for (int j = 0; j < WTN; ++j) part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < WTM; ++i)
#pragma unroll
      for (int j = 0; j < WTN; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }
  float* o = out + (size_t)s * M * N;
#pragma unroll
  for (int i = 0; i < WTM; ++i)
#pragma unroll
    for (int j = 0; j < WTN; ++j) o[(size_t)(m0 + tr * WTM + i) * N + n0 + tc + 16 * j] = acc[i][j];
}

}  // namespace f32
}  // namespace hmdt

// a (n, M), b (n, N) float32 row-major; out (M, N) float32; n and chunk
// multiples of 16, M and N multiples of 96; with S = ceil(n / chunk) > 1,
// ws holds S M N floats (the partials), else it is not read; the plan
// (ops/swin_plan.py::wgrad_f32_plan): the tile side and the threads, checked
// against this file's constants.
extern "C" int swin_wgrad_f32_launch(const void* a, const void* b, void* out, void* ws, int n,
                                     int M, int N, int chunk, int tile, int threads,
                                     void* stream) {
  using namespace hmdt::f32;
  if (n <= 0 || n % WK || M <= 0 || M % WT || N <= 0 || N % WT || chunk <= 0 || chunk % WK ||
      tile != WT || threads != WTHREADS)
    return (int)cudaErrorInvalidValue;
  const int S = (n + chunk - 1) / chunk;
  if (S > 65535 || (S > 1 && !ws)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* dst = S > 1 ? static_cast<float*>(ws) : static_cast<float*>(out);
  swin_wgrad_f32_kernel<<<dim3((M / WT) * (N / WT), S), WTHREADS, 0, st>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), dst, n, M, N, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || S == 1) return (int)e;
  return swin_reduce_launch(ws, out, S, M * N, stream);
}
