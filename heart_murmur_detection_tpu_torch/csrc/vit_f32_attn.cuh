// Shared pieces of the float32 ViT attention kernels (vit_f32.cu's core and
// vit_attn_bwd_f32.cu's query and key passes): full-sequence attention of
// one head over tiles of 64 query rows and 64 keys, head dim 64, on the CUDA
// cores (FFMA; wgmma's float32 input is TF32, which misses the TPU bodies'
// Precision.HIGHEST).
//
// The operand rows are token-major (B Np, 3C) float32, [q | k | v] with head
// h at columns h 64 of each third (q carries 1/sqrt(hd), folded into the
// weights). A block of 128 threads holds a 64 x 64 tile of scores in
// registers, a thread 8 rows (ti 8 ..) by 4 columns (tj + 16 b), ti = tid /
// 16, tj = tid % 16: the 16 threads that share a row are one half-warp, so a
// row's max and sum are a 16-lane butterfly. Tiles in shared memory are
// d-major: "row" tiles (stride 68) are read as two 16-byte vectors of 8
// rows, "column" tiles (stride 65) one value a lane at column tj + 16 b, or
// one a lane at row tj + 16 c of the transposed read; both reads are free of
// bank conflicts.
//
// The scores of a 64-row strip over Np = 1040 keys take 266 KB, more than
// the 227 KB of shared memory a block may hold, so they are not kept:
// every pass forms them again, tile by tile. The softmax is exact and
// stable as the TPU body's (jax.nn.softmax): a statistics sweep over the
// key tiles keeps each row's max m and sum l of exp(s - m), rescaling l
// when the max moves (l <- l exp(m_old - m_new) + the tile's sum), then a
// second sweep forms P = exp(s - m) / l from the same scores and takes its
// products. Two sweeps rather than an online softmax whose output is
// rescaled as it goes: P is normalised before it is used, as the plain
// version normalises it, no partial output is ever rescaled, and the
// backward (whose D = rowsum(P dP) needs the final statistics before dS)
// forms the same P from the same two sweeps. It costs one more score
// product a tile than an online softmax would.
//
// Keys at or past n_real get the score -1e9, so exp gives an exact 0; a key
// tile wholly past n_real is skipped (it adds exact zeros). Every sum has one
// order fixed by the shapes: scores one fmaf chain over d = 0..63; products
// over keys (or queries) each tile's 64 terms summed apart and then added to
// the running sum, tile after tile; a row's statistics the thread's 4
// columns in order, then the butterfly (xor 8, 4, 2, 1), then the running
// rescaled sum. No atomics.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace hmdt {
namespace vf32 {

constexpr int AT = 64;         // query rows and keys of a tile
constexpr int AHD = 64;        // head dim
constexpr int ATHREADS = 128;  // 8 x 16 threads, 8 x 4 scores each
constexpr int RS = AT + 4;     // stride of a row tile (16-byte reads of 8 rows)
constexpr int CS = AT + 1;     // stride of a column tile
constexpr float MASKED = -1e9f;

// A tile of 64 rows x 64 head dims of the operand rows, d-major into
// dst[d * stride + r]; rows r >= valid are 0. src points at row 0, column
// 0 of the head's slice; ld the row stride in floats.
template <int STRIDE>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ src,
                                          int ld, int valid) {
#pragma unroll
  for (int i = 0; i < AT * AHD / 4 / ATHREADS; ++i) {
    const int idx = threadIdx.x + ATHREADS * i, r = idx >> 4, q = idx & 15;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) v = *reinterpret_cast<const float4*>(src + (size_t)r * ld + 4 * q);
    dst[(4 * q + 0) * STRIDE + r] = v.x;
    dst[(4 * q + 1) * STRIDE + r] = v.y;
    dst[(4 * q + 2) * STRIDE + r] = v.z;
    dst[(4 * q + 3) * STRIDE + r] = v.w;
  }
}

// s[a][b] = sum_d A[d][ti 8 + a] B[d][tj + 16 b], one fmaf chain over d:
// A a row tile, B a column tile.
__device__ __forceinline__ void score_tile(const float* __restrict__ A,
                                           const float* __restrict__ Bc, float (&s)[8][4]) {
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 4
  for (int d = 0; d < AHD; ++d) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + d * RS + ti * 8);
    const float4 a1 = *reinterpret_cast<const float4*>(A + d * RS + ti * 8 + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float bv[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) bv[b] = Bc[d * CS + tj + 16 * b];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = fmaf(av[a], bv[b], s[a][b]);
  }
}

// acc[a][c] += sum_j X[j][ti 8 + a] Y[j][tj + 16 c]: X a row tile indexed by
// the summed axis j (P or dS transposed), Y a column tile d-major (Y[d][j]
// at d * CS + j, read at d = tj + 16 c); the tile's 64 terms summed apart,
// then added to acc.
__device__ __forceinline__ void accum_tile(const float* __restrict__ X,
                                           const float* __restrict__ Yc, float (&acc)[8][4]) {
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
  float part[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) part[a][c] = 0.f;
#pragma unroll 4
  for (int j = 0; j < AT; ++j) {
    const float4 x0 = *reinterpret_cast<const float4*>(X + j * RS + ti * 8);
    const float4 x1 = *reinterpret_cast<const float4*>(X + j * RS + ti * 8 + 4);
    const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    float yv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) yv[c] = Yc[(tj + 16 * c) * CS + j];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[a][c] = fmaf(xv[a], yv[c], part[a][c]);
  }
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] += part[a][c];
}

// A thread's 4 scores of a row into the row tile T (T[j][row] at j * RS +
// row): the transposed layout accum_tile reads.
__device__ __forceinline__ void store_row_t(float* __restrict__ T, int row, const float (&v)[4]) {
  const int tj = threadIdx.x & 15;
#pragma unroll
  for (int b = 0; b < 4; ++b) T[(tj + 16 * b) * RS + row] = v[b];
}

// The 16-lane butterflies of a row's max and sum (a half-warp holds a row).
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The scores of key column tj + 16 b of a tile at key j0 masked past
// n_real (the plain versions' masked_fill with -1e9).
__device__ __forceinline__ void mask_keys(float (&s)[8][4], int j0, int n_real) {
  const int tj = threadIdx.x & 15;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (j0 + tj + 16 * b >= n_real)
#pragma unroll
      for (int a = 0; a < 8; ++a) s[a][b] = MASKED;
}

// One key tile of the statistics sweep for a thread's 8 rows: the tile's
// row max, m <- max(m, it), l <- l exp(m_old - m) + sum_b exp(s - m) (the 4
// columns in order, then the butterfly); with dp given (the backward), t <-
// t exp(m_old - m) + sum_b exp(s - m) dP likewise.
template <bool WITH_DP>
__device__ __forceinline__ void stats_tile(const float (&s)[8][4], const float (&dp)[8][4],
                                           float (&m)[8], float (&l)[8], float (&t)[8]) {
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const float mt = fmaxf(fmaxf(s[a][0], s[a][1]), fmaxf(s[a][2], s[a][3]));
    const float mn = fmaxf(m[a], row_max16(mt)), c = expf(m[a] - mn);
    float ls = 0.f, ts = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float e = expf(s[a][b] - mn);
      ls += e;
      if (WITH_DP) ts = fmaf(e, dp[a][b], ts);
    }
    l[a] = __fadd_rn(__fmul_rn(l[a], c), row_sum16(ls));
    if (WITH_DP) t[a] = __fadd_rn(__fmul_rn(t[a], c), row_sum16(ts));
    m[a] = mn;
  }
}

}  // namespace vf32
}  // namespace hmdt
