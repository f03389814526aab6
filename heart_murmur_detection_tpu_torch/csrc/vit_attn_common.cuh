// Shared pieces of the ViT attention kernels: for vit_attn_bwd.cu (the
// training backward) mma.sync m16n8k16 bf16 products with float32
// accumulation, the accumulator-to-A-fragment reuse, and the streaming of
// 64-dim key / value / query tiles of one head through registers into
// shared memory; for both it and vit_attn.cu (the forward core, whose wgmma
// accumulators have the same per-warp layout) the head dim, the padded-key
// logit, the bf16 pair packing and the row statistics over a quad.
//
// Accumulator layout of an m16n8k16 product (16 x 8, float32): thread
// lane = 4 g + t holds columns 2 t, 2 t + 1 of rows g (elements 0, 1) and
// g + 8 (elements 2, 3). Two neighbouring 8-column accumulators, rounded to
// bf16 pairs, are exactly the A fragment of a 16 x 16 operand.
#pragma once

#include <math.h>
#include <stdint.h>

#include "swin_common.cuh"

namespace hmdt {

constexpr int AQ = 64;               // rows a block (queries, or keys in the backward)
constexpr int AHD = 64;              // head dim
constexpr int AWARPS = 4;            // warps a block, 16 rows each
constexpr int ATHREADS = AWARPS * 32;
constexpr int LDT = AHD + PAD;       // rows of a shared 64-dim tile (bf16)
constexpr float MASK_LOGIT = -1e9f;  // the TPU kernel's padded-key logit
constexpr int NO_MASK = 1 << 30;     // an n_real that masks no column

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8 x 8 bf16 matrices from shared memory; lane l gives the
// address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// KT rows of a head's (Np, 64) bf16 matrix in registers: thread i holds
// 16-byte pieces i, i + 128, ... (rows at or past Np read as zeros), so the
// next tile's loads are in flight while the current one is used.
template <int KT>
struct TileRegs {
  static constexpr int N = KT * (AHD / 8) / ATHREADS;
  int4 v[N];
};

template <int KT>
__device__ __forceinline__ void fetch_tile(const bf16* __restrict__ src, int r0, int Np,
                                           TileRegs<KT>& t) {
#pragma unroll
  for (int u = 0; u < TileRegs<KT>::N; ++u) {
    const int i = threadIdx.x + u * ATHREADS;
    const int r = i / (AHD / 8);
    t.v[u] = r0 + r < Np
                 ? reinterpret_cast<const int4*>(src + (size_t)(r0 + r) * AHD)[i % (AHD / 8)]
                 : make_int4(0, 0, 0, 0);
  }
}

template <int KT>
__device__ __forceinline__ void store_tile(const TileRegs<KT>& t, bf16* dst) {
#pragma unroll
  for (int u = 0; u < TileRegs<KT>::N; ++u) {
    const int i = threadIdx.x + u * ATHREADS;
    reinterpret_cast<int4*>(dst + (i / (AHD / 8)) * LDT)[i % (AHD / 8)] = t.v[u];
  }
}

// A warp's 16 rows (r0 .. r0 + 15) of a head's (Np, 64) matrix as the four
// m16n8k16 A fragments over the 64 dims, straight from device memory; rows
// at or past Np read as zeros.
__device__ __forceinline__ void load_a_rows(const bf16* __restrict__ src, int r0, int Np,
                                            int g, int t, uint32_t (&a)[AHD / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < AHD / 16; ++kc) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + (e & 1) * 8;
      const int c = kc * 16 + (e >> 1) * 8 + 2 * t;
      a[kc][e] = r < Np ? *reinterpret_cast<const uint32_t*>(src + (size_t)r * AHD + c) : 0u;
    }
  }
}

// S (16 x KT, float32) = A B^T for this warp's 16 rows (A fragments a) and
// the KT rows of the shared tile bs: s[nb] holds columns nb * 8 + 2 t, + 1
// of rows g (s[nb][0..1]) and g + 8 (s[nb][2..3]); columns at or past
// n_real (col0 is the tile's first column) read as the masked logit.
template <int KT>
__device__ __forceinline__ void score_tile(const uint32_t (&qa)[AHD / 16][4], const bf16* bs,
                                           int col0, int n_real, int g, int t,
                                           float (&s)[KT / 8][4]) {
#pragma unroll
  for (int nb = 0; nb < KT / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < AHD / 16; ++kc) {
#pragma unroll
    for (int nb = 0; nb < KT / 8; ++nb) {
      const bf16* kr = bs + (nb * 8 + g) * LDT + kc * 16 + 2 * t;
      mma_bf16(s[nb], qa[kc], *reinterpret_cast<const uint32_t*>(kr),
               *reinterpret_cast<const uint32_t*>(kr + 8));
    }
  }
#pragma unroll
  for (int nb = 0; nb < KT / 8; ++nb) {
    const int c = col0 + nb * 8 + 2 * t;
    if (c >= n_real) s[nb][0] = s[nb][2] = MASK_LOGIT;
    if (c + 1 >= n_real) s[nb][1] = s[nb][3] = MASK_LOGIT;
  }
}

// o (16 x 64, float32) += P V for this warp: P (16 x KT) in the accumulator
// layout of score_tile, rounded to bf16 as the A operand; V the KT rows of
// the shared tile vs (row-major, read transposed by ldmatrix).
template <int KT>
__device__ __forceinline__ void pv_tile(const float (&p)[KT / 8][4], const bf16* vs, int lane,
                                        float (&o)[AHD / 8][4]) {
#pragma unroll
  for (int kc = 0; kc < KT / 16; ++kc) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                            pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                            pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                            pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
#pragma unroll
    for (int db = 0; db < AHD / 8; db += 2) {
      // rows 16 kc .. +15, dims db * 8 .. +15, transposed into the B
      // fragments of dim blocks db and db + 1
      const int j = lane >> 3;
      uint32_t bv[4];
      ldsm_x4_trans(bv, vs + (kc * 16 + (j & 1) * 8 + (lane & 7)) * LDT + (db + (j >> 1)) * 8);
      mma_bf16(o[db], pa, bv[0], bv[1]);
      mma_bf16(o[db + 1], pa, bv[2], bv[3]);
    }
  }
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
