// Shared pieces of the float32 swin kernels (swin_attn_f32.cu and
// swin_mlp_f32.cu): the token addressing of a rolled window, LayerNorm row
// statistics, and a token-row product on the CUDA cores,
//
//   out[r, n] = epilogue(sum_k A'[r, k] W[n, k] + bias[n]),
//   A' = A, or LN(A) from row statistics the block computes itself,
//   epilogue = exact GELU, or x[r, n] + k[b] * (.) written at the token's
//   place (of a rolled window where the rows are windows).
//
// Float32 operands and float32 accumulation throughout, one fmaf a term in
// k order into a sum of each 16-deep step, added to the running sum: the
// TPU bodies at mm_dtype=float32 run Precision.HIGHEST, which
// TF32 (wgmma's float32 input) does not reach, so these products run on
// FFMA. Bound: the operations (16 n C^2 for the MLP, about 8 n C^2 for the
// attention) at the card's FFMA rate; the operands stay in L2.
//
// Tiles: a block of 128 threads owns 64 token rows and 96 output columns
// (every width here is a multiple of 96), K in steps of 16 through shared
// memory with A stored k-major; a thread holds 8 rows x 6 columns of
// accumulators (its rows contiguous, read as two 16-byte vectors; its
// columns 16 apart, so a warp's reads hit 16 consecutive banks).
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "swin_common.cuh"

namespace hmdt {
namespace f32 {

constexpr int GBM = 64;   // token rows of a block
constexpr int GBN = 96;   // output columns of a block
constexpr int GBK = 16;   // k depth of a shared-memory step
constexpr int GTHREADS = 128;
constexpr int GTM = 8;    // accumulator rows of a thread
constexpr int GTN = 6;    // accumulator columns of a thread
constexpr int GAS = GBM + 4;  // row stride of the k-major A tile
constexpr int GBS = GBN + 4;  // row stride of the k-major W tile

// Dynamic shared memory of a product block: the two tiles and the row
// statistics (ops/swin_plan.py::GemmF32Plan.smem_bytes is the same sum).
constexpr size_t gemm_smem_bytes() {
  return sizeof(float) * ((size_t)GBK * GAS + (size_t)GBK * GBS + 2 * GBM);
}

enum { EPI_GELU = 0, EPI_RESID = 1 };

// The geometry of a window-ordered row: row = window * 64 + token, windows
// b-major then row-major over the (rolled) map.
struct WinGeom {
  int H, W, nww, nw, shift;
};

// The element offset of token row `row` of the rolled windows in a
// (B, H, W, C) map: token (r, c) of rolled window (i, j) is
// x[(8i + r + s) mod H, (8j + c + s) mod W]; b gets the sample.
__device__ __forceinline__ size_t win_offset(int row, const WinGeom& g, int C, int& b) {
  const int win = row >> 6, t = row & 63;
  b = win / g.nw;
  const int wl = win - b * g.nw;
  const int wi = wl / g.nww, wj = wl - wi * g.nww;
  int y = WIN * wi + (t >> 3) + g.shift, xx = WIN * wj + (t & 7) + g.shift;
  if (y >= g.H) y -= g.H;
  if (xx >= g.W) xx -= g.W;
  return ((size_t)(b * g.H + y) * g.W + xx) * C;
}

// Two-pass float32 LayerNorm statistics of a row of K values, by one warp:
// the mean, then the mean of squared deviations (the plain versions' _ln).
__device__ __forceinline__ void row_stats(const float* __restrict__ xr, int K, float eps,
                                          float& mu, float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int k = lane; k < K; k += 32) s += xr[k];
  mu = warp_sum(s) / (float)K;
  float v = 0.f;
  for (int k = lane; k < K; k += 32) {
    const float d = xr[k] - mu;
    v = fmaf(d, d, v);
  }
  rstd = rsqrtf(warp_sum(v) / (float)K + eps);
}

// out = epilogue(A'(M x K) W(N x K)^T + bias), grid (M / 64, N / 96).
// LN: A' = LN(A) with ln_w / ln_b over K. WIN: the output rows (and the
// residual's) are window-ordered token rows of a (B, H, W, N) map; else
// row-major (M, N), sample b = row / hw. kmul: null, or (B,) multipliers
// of the residual branch.
template <bool LN, int EPI, bool WINO>
__global__ void __launch_bounds__(GTHREADS)
    swin_f32_gemm_kernel(const float* __restrict__ A, const float* __restrict__ Wt,
                         const float* __restrict__ bias, const float* __restrict__ ln_w,
                         const float* __restrict__ ln_b, const float* __restrict__ xres,
                         const float* __restrict__ kmul, float* __restrict__ out, int N, int K,
                         int hw, WinGeom g, float eps) {
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);  // [GBK][GAS]
  float* Bs = As + GBK * GAS;                    // [GBK][GBS]
  float* s_mu = Bs + GBK * GBS;                  // [GBM]
  float* s_rs = s_mu + GBM;                      // [GBM]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * GBM, col0 = blockIdx.y * GBN;

  if (LN) {
    const int warp = tid >> 5, lane = tid & 31;
    for (int rr = 0; rr < GBM / 4; ++rr) {
      const int r = warp * (GBM / 4) + rr;
      float mu, rs;
      row_stats(A + (size_t)(row0 + r) * K, K, eps, mu, rs);
      if (lane == 0) {
        s_mu[r] = mu;
        s_rs[r] = rs;
      }
    }
    __syncthreads();
  }

  const int tr = tid >> 4, tc = tid & 15;
  float acc[GTM][GTN];
#pragma unroll
  for (int i = 0; i < GTM; ++i)
#pragma unroll
    for (int j = 0; j < GTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GBK) {
    // A: 64 rows x 16 k, two 16-byte vectors a thread, stored k-major
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + GTHREADS * i, r = idx >> 2, q = idx & 3, k = k0 + 4 * q;
      float4 v = *reinterpret_cast<const float4*>(A + (size_t)(row0 + r) * K + k);
      if (LN) {
        const float mu = s_mu[r], rs = s_rs[r];
        v.x = ln_affine(v.x, mu, rs, ln_w[k], ln_b[k]);
        v.y = ln_affine(v.y, mu, rs, ln_w[k + 1], ln_b[k + 1]);
        v.z = ln_affine(v.z, mu, rs, ln_w[k + 2], ln_b[k + 2]);
        v.w = ln_affine(v.w, mu, rs, ln_w[k + 3], ln_b[k + 3]);
      }
      As[(4 * q + 0) * GAS + r] = v.x;
      As[(4 * q + 1) * GAS + r] = v.y;
      As[(4 * q + 2) * GAS + r] = v.z;
      As[(4 * q + 3) * GAS + r] = v.w;
    }
    // W: 96 rows x 16 k, three vectors a thread, stored k-major
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int idx = tid + GTHREADS * i, n = idx >> 2, q = idx & 3;
      const float4 v =
          *reinterpret_cast<const float4*>(Wt + (size_t)(col0 + n) * K + k0 + 4 * q);
      Bs[(4 * q + 0) * GBS + n] = v.x;
      Bs[(4 * q + 1) * GBS + n] = v.y;
      Bs[(4 * q + 2) * GBS + n] = v.z;
      Bs[(4 * q + 3) * GBS + n] = v.w;
    }
    __syncthreads();
    // the step's 16 terms into their own sum, then onto the running one:
    // the error of a K-term chain grows with K / 16 adds instead of K
    float part[GTM][GTN];
#pragma unroll
    for (int i = 0; i < GTM; ++i)
#pragma unroll
      for (int j = 0; j < GTN; ++j) part[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + kk * GAS + tr * GTM);
      const float4 a1 = *reinterpret_cast<const float4*>(As + kk * GAS + tr * GTM + 4);
      const float a[GTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[GTN];
#pragma unroll
      for (int j = 0; j < GTN; ++j) b[j] = Bs[kk * GBS + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < GTM; ++i)
#pragma unroll
        for (int j = 0; j < GTN; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < GTM; ++i)
#pragma unroll
      for (int j = 0; j < GTN; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < GTM; ++i) {
    const int row = row0 + tr * GTM + i;
    if (EPI == EPI_GELU) {
#pragma unroll
      for (int j = 0; j < GTN; ++j) {
        const int n = col0 + tc + 16 * j;
        out[(size_t)row * N + n] = gelu_exact(acc[i][j] + bias[n]);
      }
    } else {
      int b;
      size_t off;
      if (WINO) {
        off = win_offset(row, g, N, b);
      } else {
        off = (size_t)row * N;
        b = row / hw;
      }
      const float k = kmul ? kmul[b] : 1.f;
#pragma unroll
      for (int j = 0; j < GTN; ++j) {
        const int n = col0 + tc + 16 * j;
        out[off + n] = add_scaled(xres[off + n], k, acc[i][j] + bias[n]);
      }
    }
  }
}

// One launch of the product on the grid (M / 64, N / 96), after the checks
// the C entry points share. Returns the launch's CUDA error.
template <bool LN, int EPI, bool WINO>
inline cudaError_t launch_gemm(const float* A, const float* Wt, const float* bias,
                               const float* ln_w, const float* ln_b, const float* xres,
                               const float* kmul, float* out, int M, int N, int K, int hw,
                               WinGeom g, float eps, cudaStream_t s) {
  const dim3 grid(M / GBM, N / GBN);
  swin_f32_gemm_kernel<LN, EPI, WINO><<<grid, GTHREADS, gemm_smem_bytes(), s>>>(
      A, Wt, bias, ln_w, ln_b, xres, kmul, out, N, K, hw, g, eps);
  return cudaGetLastError();
}

}  // namespace f32
}  // namespace hmdt
