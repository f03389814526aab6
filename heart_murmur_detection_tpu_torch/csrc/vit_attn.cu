// vit_attn: the attention core of a ViT block's attention half,
//   o_pre[b, :, 64 h .. 64 h + 63] = bf16(attention_h(q_h, k_h, v_h)),
//   q, k, v head-major (3, B, heads, Np, 64) bf16 from vit_qkv.cu; o_pre
//   (B, Np, C) bf16, each head's output rounded to bf16 in its column block.
//   vit_proj.cu then adds proj, its bias and the residual. A head's
//   attention is one of six modes:
//     0 stable         softmax(q k^T, keys >= n_real masked) v, P rounded to
//                      bf16 after normalising (q carries 1/sqrt(hd))
//     1 fast           e = exp(s), no row max; bf16(e) v times 1/sum(e)
//     2 norm_before    e = exp(s), no row max; bf16(e / sum(e)) v
//     3 bf16_exp       e = exp(bf16(s)) in float32; bf16(e) v times 1/sum(e)
//                      (XLA's exp of K10 v5's bf16 scores: its sum takes the
//                      unrounded exp, its product operand the rounded one)
//     4 no_softmax     P = bf16(s), keys >= n_real give P = 0; P v
//     5 q_passthrough  o = q
//
// Replaces the attention part of the ViT attention body `_attn_half`
// (heart_murmur_detection_tpu/ops/pallas_vit.py:66) that the TPU kernels
// fused_vit_block (:296, K5) and fused_vit_attn (:341, K6) run (modes 0 and
// 1), and the attention of the TPU attention-half kernels K10
// (bench/gt_attn_opt.py::build :125, body `kernel` :50: v0-v2 mode 2, v3-v4
// mode 1, v5 mode 3, noattn mode 5) and K11 (bench/vit_attn_ablate.py::build
// :103, body `attn_kernel` :43: full mode 2, no_softmax mode 4, no_attn and
// ident mode 5; aligned_hcat is mode 2 where it is defined, ops/vit.py). The
// LN1 and qkv product of K10 / K11 are vit_qkv.cu with q unscaled; their
// query chunks of 208 rows are a TPU tiling, not part of the function.
//
// Bound on this card: 4 Np n_real 64 operations a head and clip (one pass)
// against 8 Np 64 bytes: the operations bind, and, in the two-pass modes,
// the exponentials (two a score, on the special-function units) about as
// much as the products; exp is taken as exp2f with log2 e folded into an
// FMA. Design:
//  - grid B x heads x ceil(Np / 128): every head of every clip in parallel
//    (864 blocks at operaGT B = 16, two an SM). A block is two consumer
//    warpgroups of 64 query rows and one producer warp.
//  - the producer loads the block's Q tile (128 x 64) once and streams the
//    head's K and V in 64-key tiles through an 8-slot TMA ring with one
//    full and one empty mbarrier a slot, only over the keys < n_real: the
//    TPU kernel set the padded key columns to -1e9, whose probabilities are
//    exact zeros, so skipping them is exact (the last tile masks its columns
//    past n_real the same way; rows past Np read as zeros).
//  - S = Q K^T is a wgmma m64n64k16 with both operands in shared memory
//    (K-major); P V a wgmma with P from registers, the accumulator of S
//    rounded to bf16 pairs (the layout at the top of wgmma_gemm.cuh), and V
//    MN-major from shared memory, so V is never transposed.
//  - two passes (stable, norm_before): the first runs Q K^T alone for each
//    row's max (fixed at 0 for norm_before, so a score that overflows exp
//    overflows here as on the TPU) and sum of exp(s - max), the second
//    recomputes Q K^T, forms P = exp(s - max) / sum, rounds it to bf16 and
//    runs P V. That puts the rounding where the normalise-then-bf16-product
//    bodies put it; an online-rescaled single pass would round P before its
//    final scale. One pass (fast, bf16_exp, no_softmax): P from each score
//    alone, the exp modes' P V scaled by 1/sum after the last tile, the
//    TPU kernels' own order. q_passthrough copies q and reads no K or V.
//  - a thread keeps its row statistics over its own columns in tile order
//    and merges them over the 4 threads of a row in a fixed order; nothing
//    is summed with atomics, so two launches agree bitwise. Query rows past
//    Np are not written; padded query rows < Np produce garbage that stays
//    in padded rows, as on the TPU.
#include "vit_attn_common.cuh"
#include "wgmma_gemm.cuh"

namespace hmdt {

using namespace hop;

enum AttnMode : int {
  MODE_STABLE = 0,
  MODE_FAST = 1,
  MODE_NORM_BEFORE = 2,
  MODE_BF16_EXP = 3,
  MODE_NO_SOFTMAX = 4,
  MODE_Q_PASSTHROUGH = 5,
  N_MODES = 6
};

constexpr int QT = 128;                   // query rows a block
constexpr int KT = 64;                    // keys a tile
constexpr int NSLOT = 8;                  // K / V tiles in flight
constexpr int Q_BYTES = QT * AHD * 2;     // 16 KB
constexpr int T_BYTES = KT * AHD * 2;     // 8 KB

struct AttnSmem {
  uint8_t q[Q_BYTES];
  uint8_t ring[NSLOT][T_BYTES];
  uint64_t qbar;
  uint64_t full[NSLOT];
  uint64_t empty[NSLOT];
};
constexpr size_t ATTN_SMEM = sizeof(AttnSmem) + 1024;  // with the alignment slack
static_assert(ATTN_SMEM * 2 <= SMEM_LIMIT, "two blocks an SM must fit");

// exp(x) is taken as exp2f(x log2 e): one multiply (or an FMA with the row
// max) and one special-function instruction, within 2 ulp of expf, and it
// overflows to inf past x = 88.7 as expf does.
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// grid (ceil(Np / 128), heads, B). tq / tkv: qkv as (3 B heads, Np, 64)
// in boxes of 128 and 64 rows.
__global__ void __launch_bounds__(THREADS, 2)
vit_attn_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tkv,
                const bf16* __restrict__ qkv, bf16* __restrict__ out, int Np, int n_real,
                int mode) {
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int heads = gridDim.y, B = gridDim.z;
  const int C = heads * AHD;
  if (mode == MODE_Q_PASSTHROUGH) {  // o = q: 16-byte pieces, no shared memory
    const bf16* qh = qkv + ((size_t)b * heads + h) * Np * AHD;
    for (int i = threadIdx.x; i < QT * (AHD / 8); i += THREADS) {
      const int r = q0 + i / (AHD / 8), c = (i % (AHD / 8)) * 8;
      if (r < Np)
        *reinterpret_cast<int4*>(out + ((size_t)b * Np + r) * C + h * AHD + c) =
            *reinterpret_cast<const int4*>(qh + (size_t)r * AHD + c);
    }
    return;
  }
  extern __shared__ uint8_t smem_raw[];
  AttnSmem& sm = *reinterpret_cast<AttnSmem*>(align_1024(smem_raw));
  if (threadIdx.x == 0) {
    mbar_init(&sm.qbar, 1);
    for (int i = 0; i < NSLOT; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const bool two_pass = mode == MODE_STABLE || mode == MODE_NORM_BEFORE;
  const int n_kt = (n_real + KT - 1) / KT;  // key tiles holding real keys
  // the tile sequence, the same for the producer and the consumers: pass 1
  // K_0 .. K_{n-1} (two-pass modes), then K_0, V_0, K_1, V_1, ...
  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == PRODUCER) {
      const int slab_q = b * heads + h, slab_k = (B + b) * heads + h,
                slab_v = (2 * B + b) * heads + h;
      mbar_expect_tx(&sm.qbar, Q_BYTES);
      tma_load_3d(sm.q, &tq, &sm.qbar, 0, q0, slab_q);
      int it = 0;
      auto push = [&](int slab, int kt) {
        const int slot = it % NSLOT;
        mbar_wait(&sm.empty[slot], ((it / NSLOT) & 1) ^ 1);
        mbar_expect_tx(&sm.full[slot], T_BYTES);
        tma_load_3d(sm.ring[slot], &tkv, &sm.full[slot], 0, kt * KT, slab);
        ++it;
      };
      if (two_pass)
        for (int kt = 0; kt < n_kt; ++kt) push(slab_k, kt);
      for (int kt = 0; kt < n_kt; ++kt) {
        push(slab_k, kt);
        push(slab_v, kt);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + wg * 64 + ((threadIdx.x / 32) & 3) * 16 + g;  // rows row0, row0 + 8
  const uint8_t* qs = sm.q + wg * BOX_BYTES;
  int it = 0;
  auto next_tile = [&]() -> const uint8_t* {
    const int slot = it % NSLOT;
    mbar_wait(&sm.full[slot], (it / NSLOT) & 1);
    return sm.ring[slot];
  };
  auto release = [&]() {
    mbar_arrive(&sm.empty[it % NSLOT]);
    ++it;
  };
  // s = Q K^T of the next tile (key tile kt), columns >= n_real masked
  float s[32];
  auto scores = [&](int kt) {
    const uint8_t* ks = next_tile();
    wg_fence();
    wgmma_m64n64_ss_first<0, 0>(s, desc_sw128(qs, 16, ATOM), desc_sw128(ks, 16, ATOM));
#pragma unroll
    for (int kk = 1; kk < AHD / 16; ++kk)
      wgmma_m64n64_ss<0, 0>(s, desc_sw128(qs + kk * 32, 16, ATOM),
                            desc_sw128(ks + kk * 32, 16, ATOM));
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    release();
    if ((kt + 1) * KT > n_real) {
#pragma unroll
      for (int j = 0; j < KT / 8; ++j) {
        const int c = kt * KT + 8 * j + 2 * t;
        if (c >= n_real) s[4 * j] = s[4 * j + 2] = MASK_LOGIT;
        if (c + 1 >= n_real) s[4 * j + 1] = s[4 * j + 3] = MASK_LOGIT;
      }
    }
  };

  mbar_wait(&sm.qbar, 0);
  // rows row0 (hr = 0) and row0 + 8 (hr = 1): element e of each 4-group
  // belongs to row hr = e >> 1
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (two_pass) {
    // pass 1: each row's max and sum of exp(s - max) over this thread's
    // columns (rescaled when the max moves), merged over the quad;
    // norm_before keeps the max at 0
    if (mode == MODE_NORM_BEFORE) m[0] = m[1] = 0.f;
    for (int kt = 0; kt < n_kt; ++kt) {
      scores(kt);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        if (mode == MODE_NORM_BEFORE) {
          float e = 0.f;
#pragma unroll
          for (int j = 0; j < KT / 8; ++j)
            e += exp2f(s[4 * j + 2 * hr] * LOG2E) + exp2f(s[4 * j + 2 * hr + 1] * LOG2E);
          l[hr] += e;
          continue;
        }
        float tmax = s[2 * hr];
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
          tmax = fmaxf(tmax, fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
        const float mn = fmaxf(m[hr], tmax);
        const float ml = mn * LOG2E;
        float e = 0.f;
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
          e += exp2f(fmaf(s[4 * j + 2 * hr], LOG2E, -ml)) +
               exp2f(fmaf(s[4 * j + 2 * hr + 1], LOG2E, -ml));
        l[hr] = l[hr] * exp2f((m[hr] - mn) * LOG2E) + e;
        m[hr] = mn;
      }
    }
    if (mode == MODE_NORM_BEFORE) {
      l[0] = quad_sum(l[0]);
      l[1] = quad_sum(l[1]);
    } else {
      merge_row_stats(m[0], l[0]);
      merge_row_stats(m[1], l[1]);
    }
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  const float ml[2] = {m[0] * LOG2E, m[1] * LOG2E};

  // pass 2 (the only pass of the one-pass modes): P, rounded to bf16, times V
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float sum[2] = {0.f, 0.f};  // the exp modes: this thread's share of the row sums
  for (int kt = 0; kt < n_kt; ++kt) {
    scores(kt);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hr = (i >> 1) & 1;
      float p;
      if (two_pass) {
        p = exp2f(fmaf(s[i], LOG2E, -ml[hr])) * inv[hr];
      } else if (mode == MODE_FAST) {
        p = exp2f(s[i] * LOG2E);
        sum[hr] += p;
      } else if (mode == MODE_BF16_EXP) {
        p = exp2f(round_bf16(s[i]) * LOG2E);
        sum[hr] += p;
      } else {  // no_softmax: the raw score, 0 on the masked columns
        p = kt * KT + 8 * (i >> 2) + 2 * t + (i & 1) < n_real ? s[i] : 0.f;
      }
      s[i] = p;
    }
    // P of the tile as the A operand: keys 16 kk .. 16 kk + 15 are column
    // blocks 2 kk and 2 kk + 1 of the accumulator
    uint32_t pa[AHD / 16][4];
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    const uint8_t* vs = next_tile();
    wg_fence();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
      wgmma_m64n64_rs<1>(o, pa[kk], desc_sw128(vs + kk * 2048, ATOM, ATOM));
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    release();
  }
  float scale[2] = {1.f, 1.f};
  if (mode == MODE_FAST || mode == MODE_BF16_EXP) {
    scale[0] = 1.f / quad_sum(sum[0]);
    scale[1] = 1.f / quad_sum(sum[1]);
  }
  // this head's output rows, rounded to bf16, into its column block
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = row0 + 8 * hr;
    if (row < Np) {
      bf16* dst = out + ((size_t)b * Np + row) * C + h * AHD + 2 * t;
#pragma unroll
      for (int j = 0; j < AHD / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + 8 * j) =
            pack_bf16(o[4 * j + 2 * hr] * scale[hr], o[4 * j + 2 * hr + 1] * scale[hr]);
    }
  }
}

}  // namespace hmdt

// C interface for ctypes. Returns cudaGetLastError() after the launch (0 on
// success), or the error that stopped it before. qkv (3, B, heads, Np, 64)
// bf16; out (B, Np, C) bf16, C = 64 heads; keys >= n_real are masked; mode
// 0-5 as at the top of this file.
extern "C" int vit_attn_launch(const void* qkv, void* out, int B, int Np, int C, int heads,
                               int n_real, int mode, void* stream) {
  using namespace hmdt;
  if (B <= 0 || Np <= 0 || n_real <= 0 || n_real > Np || heads <= 0 || heads * AHD != C ||
      B > 65535 || heads > 65535 || mode < 0 || mode >= N_MODES)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mkv;
  const uint64_t dims[3] = {(uint64_t)AHD, (uint64_t)Np, (uint64_t)3 * B * heads};
  const uint32_t box_q[3] = {AHD, QT, 1}, box_kv[3] = {AHD, KT, 1};
  int err = make_tensor_map(&mq, qkv, 3, dims, box_q);
  if (!err) err = make_tensor_map(&mkv, qkv, 3, dims, box_kv);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(vit_attn_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ATTN_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Np + QT - 1) / QT, heads, B);
  vit_attn_kernel<<<grid, THREADS, ATTN_SMEM, static_cast<cudaStream_t>(stream)>>>(
      mq, mkv, static_cast<const bf16*>(qkv), static_cast<bf16*>(out), Np, n_real, mode);
  return (int)cudaGetLastError();
}
