// Pieces shared by the two backward kernels of the training blocks,
// swin_mlp_bwd.cu (also the ViT's vit_mlp_bwd) and swin_attn_bwd.cu. Each
// runs as a few grid launches in one call: a wgmma kernel over token panels
// or windows, then the two launches below.
//
//  - rows_mm_body: out (M, N) float32 = a (M, K) b (K, N) on the GEMM core
//    of wgmma_gemm.cuh, A K-major (token rows), B MN-major (a torch (out, in)
//    weight read as (K, N)), as vit_attn_bwd.cu's do and dh products: the
//    MLP's dm = da1 W1 and the attention's dh = dqkv W_qkv.
//  - ln_bwd_rows_body: the row pass. For each token, the LayerNorm backward
//    out = g + rstd (d w - mean(d w) - xhat mean(d w xhat)) with the
//    statistics of x recomputed, one warp a token; and, over a block's
//    contiguous run of 32-token tiles in order, the column sums
//    [sum k g | sum d xhat | sum d] into its columns of a float32 partial
//    row of the kernel before it (one row-pass block a row of that kernel:
//    no partial row of its own, so swin_reduce reads no extra rows).
//
// Each kernel symbol that runs these is named after its file
// (swin_mlp_bwd_*, swin_attn_bwd_*), so a profile groups a call's launches.
#pragma once

#include "swin_common.cuh"
#include "vit_attn_common.cuh"
#include "wgmma_gemm.cuh"

namespace hmdt {

using namespace hop;

// exact GELU and its derivative from one erf (the plain versions' formulas)
__device__ __forceinline__ void gelu_and_grad(float v, float& g, float& dg) {
  const float e = erff(v * 0.70710678118654752f);
  g = 0.5f * v * (1.f + e);
  dg = 0.5f * (1.f + e) + v * expf(-0.5f * v * v) * 0.3989422804014327f;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Byte offset of element (r, c) in a 128-byte-swizzle K-major tile of
// `rows` rows (boxes of 64 columns): the layout TMA writes and wgmma reads.
__device__ __forceinline__ uint32_t sw_off(int r, int c, int rows) {
  return (uint32_t)((c >> 6) * rows * 128 + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
                    (c & 7) * 2);
}

// ---------------------------------------------------------------------------
// token-row products on the GEMM core (a 128 x 128 tile a block, all of K)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void rows_mm_body(const CUtensorMap* ta, const CUtensorMap* tb,
                                             float* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  GemmSmem<1>& sm = gemm_smem<1>(smem_raw);
  gemm_init(sm);
  __syncthreads();
  const int n0 = blockIdx.x * GEMM_COLS, m0 = blockIdx.y * GemmCfg<1>::ROWS;
  float acc[1][64];
  gemm_core<false, true, 1>(sm, ta, tb, m0, n0, 0, (K + GEMM_BK - 1) / GEMM_BK, acc);
  if (threadIdx.x >= CONSUMERS) return;
  acc_pairs(acc[0], m0 + (threadIdx.x / 128) * 64, n0, [&](int row, int col, float v0, float v1) {
    if (row < M && col < N)
      *reinterpret_cast<float2*>(out + (size_t)row * N + col) = make_float2(v0, v1);
  });
}

// out = a (M, K) b (K, N) float32 by `kernel` (a __global__ that calls
// rows_mm_body), bf16 row-major operands, K and N multiples of 8.
template <typename Kernel>
static int launch_rows_mm(Kernel kernel, const void* a, const void* b, float* out, int M, int N,
                          int K, cudaStream_t stream) {
  CUtensorMap ma, mb;
  const uint64_t da[2] = {(uint64_t)K, (uint64_t)M}, db[2] = {(uint64_t)N, (uint64_t)K};
  const uint32_t box[2] = {BOX, BOX};
  int err = make_tensor_map(&ma, a, 2, da, box);
  if (!err) err = make_tensor_map(&mb, b, 2, db, box);
  if (err) return err;
  constexpr size_t smem = gemm_smem_bytes<1>();
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + GEMM_COLS - 1) / GEMM_COLS, (M + GemmCfg<1>::ROWS - 1) / GemmCfg<1>::ROWS);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<grid, THREADS, smem, stream>>>(ma, mb, out, M, N, K);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the row pass: LayerNorm backward and the column sums
// ---------------------------------------------------------------------------

constexpr int RP_TOKENS = 32;   // tokens a tile of the row pass (two a warp)
constexpr int RP_THREADS = 512;

// Where row r of d (and of the partial sums' order) lies in x, g and out.
// hh = 0: the rows are the tokens of (n, C) tensors, sample r / hw. Else
// window order over (B, hh, ww, C) tensors: row r is token r % 64 of rolled
// 8x8 window r / 64, at its place after the cyclic shift.
struct RowMap {
  int hh, ww, shift, hw;
  __device__ __forceinline__ size_t at(int r, int C, int& b) const {
    if (hh == 0) {
      b = r / hw;
      return (size_t)r * C;
    }
    const int w = r >> 6, t = r & 63, nww = ww / WIN, nws = (hh / WIN) * nww;
    b = w / nws;
    const int win = w % nws;
    const int rr = ((win / nww) * WIN + t / WIN + shift) % hh;
    const int cc = ((win % nww) * WIN + t % WIN + shift) % ww;
    return (((size_t)b * hh + rr) * ww + cc) * C;
  }
};

// The column sums of a tile: C / 2 column pairs a group of threads, GR
// groups (a power of two) each summing RP_TOKENS / GR of the tile's tokens.
template <int C>
struct RowsCfg {
  static constexpr int PAIRS = C / 2;
  static constexpr int FIT = RP_THREADS / PAIRS;
  static constexpr int GR = FIT >= 8 ? 8 : FIT >= 4 ? 4 : FIT >= 2 ? 2 : 1;
  static constexpr int TPG = RP_TOKENS / GR;
  static_assert(PAIRS <= RP_THREADS, "a column pair a thread");
};

// grid: block b walks the 32-token tiles [b T / G, (b + 1) T / G) of the T
// tiles of the n_rows rows. x, g and out bf16, d (n_rows, C) float32 in row
// order, kmul one float a sample (null: 1). The block writes [sum k g |
// sum d xhat | sum d] into columns [col0, col0 + 3C) of its partial row
// part[blockIdx.x] (L floats; the kernel before it owns the other columns):
// each group of threads sums its share of every tile in tile and token
// order, and the groups are added in order at the end.
template <int C>
__device__ __forceinline__ void ln_bwd_rows_body(const bf16* __restrict__ x,
                                                 const bf16* __restrict__ g,
                                                 const float* __restrict__ kmul,
                                                 const float* __restrict__ d,
                                                 const float* __restrict__ ln_w,
                                                 bf16* __restrict__ out, float* __restrict__ part,
                                                 int L, int col0, int n_rows, float eps,
                                                 RowMap map) {
  using Cfg = RowsCfg<C>;
  constexpr int QN = (C + 63) / 64;  // pairs of a lane: columns 2 lane + 64 q
  __shared__ float mu[RP_TOKENS], rstd[RP_TOKENS], kv[RP_TOKENS];
  __shared__ size_t offs[RP_TOKENS];
  __shared__ float red[Cfg::GR][3 * C];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = threadIdx.x / Cfg::PAIRS, c = 2 * (threadIdx.x % Cfg::PAIRS);
  float2 w[QN];
#pragma unroll
  for (int q = 0; q < QN; ++q) {
    const int cq = 2 * lane + 64 * q;
    w[q] = cq < C ? *reinterpret_cast<const float2*>(ln_w + cq) : make_float2(0.f, 0.f);
  }
  float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const long n_tiles = n_rows / RP_TOKENS;
  const int t_beg = (int)(n_tiles * blockIdx.x / gridDim.x);
  const int t_end = (int)(n_tiles * (blockIdx.x + 1) / gridDim.x);
  for (int tile = t_beg; tile < t_end; ++tile) {
    // 1. one warp a token: statistics, then out = g + LN^T(d)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = 2 * warp + u;
      const int r = tile * RP_TOKENS + t;
      int b;
      const size_t off = map.at(r, C, b);
      const float* dr = d + (size_t)r * C;
      float2 xv[QN], dv[QN];
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < QN; ++q) {
        const int cq = 2 * lane + 64 * q;
        if (cq < C) {
          xv[q] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + off + cq));
          dv[q] = *reinterpret_cast<const float2*>(dr + cq);
        } else {
          xv[q] = dv[q] = make_float2(0.f, 0.f);
        }
        sum += xv[q].x + xv[q].y;
      }
      const float m = warp_sum(sum) / (float)C;
      float var = 0.f;
#pragma unroll
      for (int q = 0; q < QN; ++q)
        if (2 * lane + 64 * q < C) {
          const float a = xv[q].x - m, bb = xv[q].y - m;
          var += a * a + bb * bb;
        }
      const float rs = rsqrtf(warp_sum(var) / (float)C + eps);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int q = 0; q < QN; ++q) {
        xv[q] = make_float2((xv[q].x - m) * rs, (xv[q].y - m) * rs);
        dv[q] = make_float2(dv[q].x * w[q].x, dv[q].y * w[q].y);
        s1 += dv[q].x + dv[q].y;
        s2 += dv[q].x * xv[q].x + dv[q].y * xv[q].y;
      }
      const float m1 = warp_sum(s1) / (float)C;
      const float m2 = warp_sum(s2) / (float)C;
#pragma unroll
      for (int q = 0; q < QN; ++q) {
        const int cq = 2 * lane + 64 * q;
        if (cq >= C) continue;
        const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g + off + cq));
        *reinterpret_cast<uint32_t*>(out + off + cq) =
            pack_bf16(gv.x + rs * (dv[q].x - m1 - xv[q].x * m2),
                      gv.y + rs * (dv[q].y - m1 - xv[q].y * m2));
      }
      if (lane == 0) {
        mu[t] = m;
        rstd[t] = rs;
        offs[t] = off;
        kv[t] = kmul ? kmul[b] : 1.f;
      }
    }
    __syncthreads();
    // 2. this group's tokens of the tile, in order, for its column pair
    if (grp < Cfg::GR) {
#pragma unroll 4
      for (int t = grp * Cfg::TPG; t < (grp + 1) * Cfg::TPG; ++t) {
        const size_t off = offs[t];
        const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g + off + c));
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + off + c));
        const float2 dv = *reinterpret_cast<const float2*>(d + ((size_t)tile * RP_TOKENS + t) * C + c);
        const float k = kv[t];
        s[0] += k * gv.x;
        s[1] += k * gv.y;
        s[2] += dv.x * ((xv.x - mu[t]) * rstd[t]);
        s[3] += dv.y * ((xv.y - mu[t]) * rstd[t]);
        s[4] += dv.x;
        s[5] += dv.y;
      }
    }
    __syncthreads();
  }
  if (grp < Cfg::GR)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      red[grp][k * C + c] = s[2 * k];
      red[grp][k * C + c + 1] = s[2 * k + 1];
    }
  __syncthreads();
  float* row = part + (size_t)blockIdx.x * L + col0;
  for (int i = threadIdx.x; i < 3 * C; i += RP_THREADS) {
    float v = red[0][i];
#pragma unroll
    for (int q = 1; q < Cfg::GR; ++q) v += red[q][i];
    row[i] = v;
  }
}

}  // namespace hmdt
