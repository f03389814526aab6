// Shared pieces of the float32 swin kernels (swin_attn_f32.cu,
// swin_mlp_f32.cu and their backward, swin_attn_bwd_f32.cu and
// swin_mlp_bwd_f32.cu) and of the float32 ViT kernels (vit_f32.cu,
// vit_attn_bwd_f32.cu; swin_mlp_f32.cu and swin_mlp_bwd_f32.cu serve as the
// ViT MLP half with LayerNorm eps 1e-6): the token addressing of a rolled
// window, LayerNorm
// row statistics, a token-row product on the CUDA cores,
//
//   out[r, n] = epilogue(sum_k A'[r, k] W[n, k] + bias[n]),
//   A' = A, or LN(A) from row statistics the block computes itself,
//   epilogue = exact GELU, or x[r, n] + k[b] * (.) written at the token's
//   place (of a rolled window where the rows are windows); for the
//   backward: a plain store (bias optional), GELU with its input kept, or
//   the product times GELU'(the input kept in out),
//
// and the backward's helpers: a weight transpose (the product takes W
// (N, K); the backward's products need W^T), the LayerNorm rows of a
// backward's operands, and its row pass (the LayerNorm backward with the
// per-block column sums).
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

// EPI_STORE: acc (+ bias[n] where bias is given); EPI_GELU_KEEP: GELU(acc +
// bias[n]), and acc + bias[n] into aux; EPI_DGELU: acc * GELU'(out[r, n]),
// the GELU input kept there by an EPI_GELU_KEEP launch, written in place.
enum { EPI_GELU = 0, EPI_RESID = 1, EPI_STORE = 2, EPI_GELU_KEEP = 3, EPI_DGELU = 4 };

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

// d/dv of the exact GELU, Phi(v) + v phi(v) (the plain versions' gelu_grad).
__device__ __forceinline__ float gelu_grad(float v) {
  return 0.5f * (1.f + erff(v * 0.70710678118654752f)) +
         v * expf(-0.5f * v * v) * 0.3989422804014327f;
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

// out = epilogue(A'(M x K) W(N x K)^T + bias), grid (ceil(M / 64), N / 96):
// the last row tile's rows past M read row M - 1 and are not stored.
// LN: A' = LN(A) with ln_w / ln_b over K. WIN: the output rows (and the
// residual's) are window-ordered token rows of a (B, H, W, N) map; else
// row-major (M, N), sample b = row / hw. kmul: null, or (B,) multipliers
// of the residual branch. aux: EPI_GELU_KEEP's second output.
template <bool LN, int EPI, bool WINO>
__global__ void __launch_bounds__(GTHREADS)
    swin_f32_gemm_kernel(const float* __restrict__ A, const float* __restrict__ Wt,
                         const float* __restrict__ bias, const float* __restrict__ ln_w,
                         const float* __restrict__ ln_b, const float* __restrict__ xres,
                         const float* __restrict__ kmul, float* __restrict__ out, int M, int N,
                         int K, int hw, WinGeom g, float eps, float* __restrict__ aux) {
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
      row_stats(A + (size_t)min(row0 + r, M - 1) * K, K, eps, mu, rs);
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
      float4 v = *reinterpret_cast<const float4*>(A + (size_t)min(row0 + r, M - 1) * K + k);
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
    if (row >= M) break;
    if (EPI == EPI_GELU) {
#pragma unroll
      for (int j = 0; j < GTN; ++j) {
        const int n = col0 + tc + 16 * j;
        out[(size_t)row * N + n] = gelu_exact(acc[i][j] + bias[n]);
      }
    } else if (EPI == EPI_STORE) {
#pragma unroll
      for (int j = 0; j < GTN; ++j) {
        const int n = col0 + tc + 16 * j;
        out[(size_t)row * N + n] = bias ? acc[i][j] + bias[n] : acc[i][j];
      }
    } else if (EPI == EPI_GELU_KEEP) {
#pragma unroll
      for (int j = 0; j < GTN; ++j) {
        const size_t o = (size_t)row * N + col0 + tc + 16 * j;
        const float v = acc[i][j] + bias[col0 + tc + 16 * j];
        out[o] = gelu_exact(v);
        aux[o] = v;
      }
    } else if (EPI == EPI_DGELU) {
#pragma unroll
      for (int j = 0; j < GTN; ++j) {
        const size_t o = (size_t)row * N + col0 + tc + 16 * j;
        out[o] = acc[i][j] * gelu_grad(out[o]);
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

// One launch of the product on the grid (ceil(M / 64), N / 96), after the checks
// the C entry points share. Returns the launch's CUDA error.
template <bool LN, int EPI, bool WINO>
inline cudaError_t launch_gemm(const float* A, const float* Wt, const float* bias,
                               const float* ln_w, const float* ln_b, const float* xres,
                               const float* kmul, float* out, int M, int N, int K, int hw,
                               WinGeom g, float eps, cudaStream_t s, float* aux = nullptr) {
  const dim3 grid((M + GBM - 1) / GBM, N / GBN);
  swin_f32_gemm_kernel<LN, EPI, WINO><<<grid, GTHREADS, gemm_smem_bytes(), s>>>(
      A, Wt, bias, ln_w, ln_b, xres, kmul, out, M, N, K, hw, g, eps, aux);
  return cudaGetLastError();
}

// A plain row-major product for the backward: out (M, N) = A (M, K) W (N, K)^T
// (+ bias), or one of the GELU epilogues.
template <int EPI>
inline cudaError_t launch_rows(const float* A, const float* Wt, const float* bias, float* out,
                               int M, int N, int K, cudaStream_t s, float* aux = nullptr) {
  const WinGeom none{0, 0, 1, 1, 0};
  return launch_gemm<false, EPI, false>(A, Wt, bias, nullptr, nullptr, nullptr, nullptr, out, M,
                                        N, K, 1, none, 0.f, s, aux);
}

// ---------------------------------------------------------------------------
// the backward's helpers
// ---------------------------------------------------------------------------

constexpr int TTILE = 32;       // a transpose tile (32 x 32, 32 x 8 threads)
constexpr int RTHREADS = 256;   // the row kernels: a warp a token
constexpr int RWARPS = RTHREADS / 32;

// out (C, R) = in (R, C)^T, R and C multiples of 32; grid (C / 32, R / 32).
template <int T = TTILE>
__global__ void __launch_bounds__(T * 8)
    f32_transpose_kernel(const float* __restrict__ in, float* __restrict__ out, int R, int C) {
  __shared__ float t[T][T + 1];
  const int c0 = blockIdx.x * T, r0 = blockIdx.y * T;
  for (int i = threadIdx.y; i < T; i += 8) t[i][threadIdx.x] = in[(size_t)(r0 + i) * C + c0 + threadIdx.x];
  __syncthreads();
  for (int i = threadIdx.y; i < T; i += 8) out[(size_t)(c0 + i) * R + r0 + threadIdx.x] = t[threadIdx.x][i];
}

inline cudaError_t launch_transpose(const float* in, float* out, int R, int C, cudaStream_t s) {
  f32_transpose_kernel<><<<dim3(C / TTILE, R / TTILE), dim3(TTILE, 8), 0, s>>>(in, out, R, C);
  return cudaGetLastError();
}

// The place of token row r: at a rolled window's token (WINO) or row r of a
// row-major (n, C) tensor, and its sample.
template <bool WINO>
__device__ __forceinline__ size_t row_offset(int r, const WinGeom& g, int C, int hw, int& b) {
  if (WINO) return win_offset(r, g, C, b);
  b = r / hw;
  return (size_t)r * C;
}

// A lane's NC = C / 32 values of a row (columns lane + 32 j) and the row's
// two-pass LayerNorm statistics over them (the plain versions' _ln_stats).
template <int NC>
__device__ __forceinline__ void lane_stats(const float (&v)[NC], int C, float eps, float& mu,
                                           float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) s += v[j];
  mu = warp_sum(s) / (float)C;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const float d = v[j] - mu;
    q = fmaf(d, d, q);
  }
  rstd = rsqrtf(warp_sum(q) / (float)C + eps);
}

// The operand rows of a backward, a warp a token row r < n: ln_out[r] =
// LN(x at r's place) and k_out[r] = k[b] * g (at r's place; k = 1 where
// kmul is null; k_out null: not written). Grid n / RWARPS.
template <int NC, bool WINO>
__global__ void __launch_bounds__(RTHREADS)
    f32_ln_rows_kernel(const float* __restrict__ x, const float* __restrict__ g,
                       const float* __restrict__ kmul, const float* __restrict__ ln_w,
                       const float* __restrict__ ln_b, float* __restrict__ ln_out,
                       float* __restrict__ k_out, int hw, WinGeom geo, float eps) {
  constexpr int C = 32 * NC;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * RWARPS + (threadIdx.x >> 5);
  int b;
  const size_t off = row_offset<WINO>(r, geo, C, hw, b);
  float v[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) v[j] = x[off + lane + 32 * j];
  float mu, rs;
  lane_stats<NC>(v, C, eps, mu, rs);
  const float k = kmul ? kmul[b] : 1.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    ln_out[(size_t)r * C + c] = ln_affine(v[j], mu, rs, ln_w[c], ln_b[c]);
    if (k_out) k_out[(size_t)r * C + c] = __fmul_rn(k, g[off + c]);
  }
}

// The row pass of a backward: block q of G walks token rows [n q / G,
// n (q + 1) / G) (a warp a row, rows warp, warp + 8, ...), each row r:
//   xhat, rstd = LN statistics of x at r's place,
//   out[r's place] = resid[r's place] + rstd (dxhat - mean(dxhat) -
//                    xhat mean(dxhat xhat)),  dxhat = gr[r] * ln_w,
// and fills its partial row part[q] (part_cols floats): at off3, the
// column sums [extra | gr * xhat | gr] over its rows (the warps' sums added
// in warp order), and, where wide is given, at 0 the column sums of wide
// (n, nw) over its rows in row order.
template <int NC, bool WINO>
__global__ void __launch_bounds__(RTHREADS)
    f32_ln_bwd_rows_kernel(const float* __restrict__ x, const float* __restrict__ gr,
                           const float* __restrict__ resid, const float* __restrict__ ln_w,
                           const float* __restrict__ extra, const float* __restrict__ wide,
                           float* __restrict__ out, float* __restrict__ part, int n, int nw,
                           int part_cols, int off3, int hw, WinGeom geo, float eps) {
  constexpr int C = 32 * NC;
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4);  // [RWARPS][3 C]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = gridDim.x, q = blockIdx.x;
  const int t0 = (int)((long long)n * q / G), t1 = (int)((long long)n * (q + 1) / G);
  float se[NC], sw[NC], sb[NC], w[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    se[j] = sw[j] = sb[j] = 0.f;
    w[j] = ln_w[lane + 32 * j];
  }
  for (int r = t0 + warp; r < t1; r += RWARPS) {
    int b;
    const size_t off = row_offset<WINO>(r, geo, C, hw, b);
    float v[NC], d[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) v[j] = x[off + lane + 32 * j];
    float mu, rs;
    lane_stats<NC>(v, C, eps, mu, rs);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      const float gv = gr[(size_t)r * C + c];
      v[j] = (v[j] - mu) * rs;  // xhat
      d[j] = gv * w[j];         // dxhat
      s1 += d[j];
      s2 = fmaf(d[j], v[j], s2);
      sw[j] = fmaf(gv, v[j], sw[j]);
      sb[j] += gv;
      se[j] += extra[(size_t)r * C + c];
    }
    const float m1 = warp_sum(s1) / (float)C, m2 = warp_sum(s2) / (float)C;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = lane + 32 * j;
      out[off + c] = resid[off + c] + rs * (d[j] - m1 - v[j] * m2);
    }
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + 32 * j;
    red[warp * 3 * C + c] = se[j];
    red[warp * 3 * C + C + c] = sw[j];
    red[warp * 3 * C + 2 * C + c] = sb[j];
  }
  __syncthreads();
  float* prow = part + (size_t)q * part_cols;
  for (int c = tid; c < 3 * C; c += RTHREADS) {
    float s = red[c];
#pragma unroll
    for (int k = 1; k < RWARPS; ++k) s += red[k * 3 * C + c];
    prow[off3 + c] = s;
  }
  if (wide) {
    for (int c = tid; c < nw; c += RTHREADS) {
      float s = 0.f;
      for (int r = t0; r < t1; ++r) s += wide[(size_t)r * nw + c];
      prow[c] = s;
    }
  }
}

constexpr size_t ln_bwd_smem_bytes(int C) { return sizeof(float) * RWARPS * 3 * (size_t)C; }

template <int NC, bool WINO>
inline cudaError_t launch_ln_rows_nc(const float* x, const float* g, const float* kmul,
                                     const float* ln_w, const float* ln_b, float* ln_out,
                                     float* k_out, int n, int hw, WinGeom geo, float eps,
                                     cudaStream_t s) {
  f32_ln_rows_kernel<NC, WINO><<<n / RWARPS, RTHREADS, 0, s>>>(x, g, kmul, ln_w, ln_b, ln_out,
                                                                k_out, hw, geo, eps);
  return cudaGetLastError();
}

template <int NC, bool WINO>
inline cudaError_t launch_ln_bwd_nc(const float* x, const float* gr, const float* resid,
                                    const float* ln_w, const float* extra, const float* wide,
                                    float* out, float* part, int n, int nw, int part_cols,
                                    int off3, int grid, int hw, WinGeom geo, float eps,
                                    cudaStream_t s) {
  // 36 KB at C = 384: under the 48 KB a launch takes without an attribute;
  // 72 KB at C = 768 (the ViT-B rows): the opt-in attribute, set at the
  // first launch (a warm-up call, outside any stream capture)
  const size_t smem = ln_bwd_smem_bytes(32 * NC);
  if (smem > 48 * 1024) {
    static bool attr = false;
    if (!attr) {
      const cudaError_t e = cudaFuncSetAttribute(f32_ln_bwd_rows_kernel<NC, WINO>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
      if (e != cudaSuccess) return e;
      attr = true;
    }
  }
  f32_ln_bwd_rows_kernel<NC, WINO><<<grid, RTHREADS, smem, s>>>(
      x, gr, resid, ln_w, extra, wide, out, part, n, nw, part_cols, off3, hw, geo, eps);
  return cudaGetLastError();
}

// The two row kernels at the widths the backward takes (C = 96, 192, 384
// for the swin blocks, 384 and 768 for the ViT blocks); n a multiple of
// RWARPS.
template <bool WINO>
inline cudaError_t launch_ln_rows(const float* x, const float* g, const float* kmul,
                                  const float* ln_w, const float* ln_b, float* ln_out,
                                  float* k_out, int n, int C, int hw, WinGeom geo, float eps,
                                  cudaStream_t s) {
  switch (C) {
    case 96: return launch_ln_rows_nc<3, WINO>(x, g, kmul, ln_w, ln_b, ln_out, k_out, n, hw, geo, eps, s);
    case 192: return launch_ln_rows_nc<6, WINO>(x, g, kmul, ln_w, ln_b, ln_out, k_out, n, hw, geo, eps, s);
    case 384: return launch_ln_rows_nc<12, WINO>(x, g, kmul, ln_w, ln_b, ln_out, k_out, n, hw, geo, eps, s);
    case 768: return launch_ln_rows_nc<24, WINO>(x, g, kmul, ln_w, ln_b, ln_out, k_out, n, hw, geo, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool WINO>
inline cudaError_t launch_ln_bwd(const float* x, const float* gr, const float* resid,
                                 const float* ln_w, const float* extra, const float* wide,
                                 float* out, float* part, int n, int C, int nw, int part_cols,
                                 int off3, int grid, int hw, WinGeom geo, float eps,
                                 cudaStream_t s) {
  switch (C) {
    case 96: return launch_ln_bwd_nc<3, WINO>(x, gr, resid, ln_w, extra, wide, out, part, n, nw, part_cols, off3, grid, hw, geo, eps, s);
    case 192: return launch_ln_bwd_nc<6, WINO>(x, gr, resid, ln_w, extra, wide, out, part, n, nw, part_cols, off3, grid, hw, geo, eps, s);
    case 384: return launch_ln_bwd_nc<12, WINO>(x, gr, resid, ln_w, extra, wide, out, part, n, nw, part_cols, off3, grid, hw, geo, eps, s);
    case 768: return launch_ln_bwd_nc<24, WINO>(x, gr, resid, ln_w, extra, wide, out, part, n, nw, part_cols, off3, grid, hw, geo, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace f32
}  // namespace hmdt
