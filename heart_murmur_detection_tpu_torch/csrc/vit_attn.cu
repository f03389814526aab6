// vit_attn: the attention, proj and residual of a ViT block's attention half,
//   out = x + proj(concat_h attention_h(q_h, k_h, v_h)),
//   q, k, v head-major (3, B, heads, Np, 64) bf16 from vit_qkv.cu; x and out
//   (B, Np, C) bf16. The attention of a head is one of six modes:
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
// Design. A block of 4 warps takes one clip's 64-row query tile and walks
// the heads in sequence; warp w owns query rows 16w..16w+15. K and V of one
// head (1040 x 64 x 2 x 2 B at operaGT) do not fit in shared memory beside
// the output tile, so the block streams them in key tiles (64 keys at
// C = 384, 32 at C = 768), and only over the keys < n_real: the TPU kernel
// set the padded key columns to -1e9, whose probabilities are exact zeros,
// so skipping them is exact (the last tile masks its columns past n_real
// the same way). The next tile is loaded into registers while the current
// one is used; a tile costs two block barriers (the K/V hand-off) and
// nothing else, because the scores never leave registers: each warp runs
// mma.sync m16n8k16 (bf16, float32 accumulation) with its Q fragments held
// for the whole head, keeps S = Q K^T in the accumulator layout (a thread
// holds two columns of rows g and g + 8), reduces rows over the 4 threads
// of a quad, and feeds P, rounded to bf16, back as the A operand of P V.
//  - one pass (fast, bf16_exp, no_softmax): P is formed from each score
//    alone; the exp modes add it to the row sum, and their float32 P V
//    accumulators stay in registers across the tiles and are scaled by
//    1/sum after the last tile. That is the TPU kernels' own order.
//  - two passes (stable, norm_before): the first finds each row's sum of
//    exp(s - max) (stable: online, rescaling the sum when the max moves;
//    norm_before: max fixed at 0, so a score that overflows exp overflows
//    here as on the TPU); the second forms the normalised
//    P = exp(s - max) / sum, rounds it to bf16 and runs P V. That puts the
//    rounding where the normalise-then-bf16-product bodies put it; an
//    online-rescaled single pass would round P before its final scale. The
//    price is a second Q K^T per tile.
//  - q_passthrough reads no K or V: the warp's Q fragments are its output.
// Each head's output is rounded to bf16 into a 64 x C shared tile (48 KB at
// C = 384, 97 KB at C = 768); the epilogue runs proj against it with WMMA (a
// warp takes a 16-wide weight column tile against all 4 row tiles), adds the
// float32 bias and the residual x and rounds once. Query rows past Np read
// zeros and are not written; padded query rows < Np produce garbage that
// stays in padded rows, as on the TPU. Shared memory: 67 KB at C = 384
// (three blocks an SM), 106 KB at C = 768 (two). Every sum runs in a fixed
// order and nothing is added with atomics, so two launches agree bitwise.
//
// Bound on this card: 4 Np^2 hd FLOPs a head and clip for attention (one
// pass) plus 2 Np C^2 for proj, against 4 Np C + 6 Np C bytes, so the
// operations bound it. Later work: wgmma with TMA-fed K/V tiles, two heads
// a block at the narrow batch.
#include "vit_attn_common.cuh"

namespace hmdt {

enum AttnMode : int {
  MODE_STABLE = 0,
  MODE_FAST = 1,
  MODE_NORM_BEFORE = 2,
  MODE_BF16_EXP = 3,
  MODE_NO_SOFTMAX = 4,
  MODE_Q_PASSTHROUGH = 5,
  N_MODES = 6
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// keys a tile: 64 at C = 384; 32 at C = 768, where two blocks an SM then
// still fit beside the 97 KB output tile
template <int C>
constexpr int attn_key_tile() {
  return C >= 768 ? 32 : 64;
}

template <int C>
struct VitAttnSmem {
  static constexpr int KT = attn_key_tile<C>();
  static constexpr int LDO = C + PAD;  // head outputs (bf16)
  static constexpr size_t O = (size_t)AQ * LDO * 2;
  static constexpr size_t T = (size_t)KT * LDT * 2;
  static constexpr size_t off_o = 0;
  static constexpr size_t off_k = O;
  static constexpr size_t off_v = off_k + T;
  static constexpr size_t bytes = off_v + T;
  static_assert(O % 128 == 0 && T % 128 == 0,
                "shared-memory regions must stay 128-byte aligned");
  static_assert((size_t)AWARPS * 256 * 4 <= 2 * T, "staging must fit in the k / v tiles");
  static_assert(bytes <= SMEM_LIMIT, "shared memory over the sm_90 limit");
};

template <int C>
__global__ void __launch_bounds__(ATHREADS, (C >= 768 ? 2 : 3))
vit_attn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ qkv,
                bf16* __restrict__ out, const bf16* __restrict__ w_proj,
                const float* __restrict__ b_proj, int Np, int heads, int n_real,
                int mode) {
  using L = VitAttnSmem<C>;
  constexpr int KT = L::KT;
  constexpr int NB = KT / 8;  // 8-key column blocks of a tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ob = reinterpret_cast<bf16*>(smem + L::off_o);
  bf16* ks = reinterpret_cast<bf16*>(smem + L::off_k);
  bf16* vs = reinterpret_cast<bf16*>(smem + L::off_v);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // accumulator row (and row + 8) of this thread
  const int t = lane & 3;   // its column pair
  const int q0 = blockIdx.x * AQ;
  const int b = blockIdx.y;
  const int B = gridDim.y;
  const int n_kt = (n_real + KT - 1) / KT;  // key tiles holding real keys
  const int row0 = warp * 16 + g;            // this thread's rows in the tile
  const size_t hstride = (size_t)Np * AHD;

  const bool two_pass = mode == MODE_STABLE || mode == MODE_NORM_BEFORE;
  const bool scaled = mode == MODE_FAST || mode == MODE_BF16_EXP;  // times 1/sum after P V

  for (int h = 0; h < heads; ++h) {
    const bf16* qh = qkv + ((size_t)b * heads + h) * hstride;
    const bf16* kh = qkv + ((size_t)(B + b) * heads + h) * hstride;
    const bf16* vh = qkv + ((size_t)(2 * B + b) * heads + h) * hstride;
    // this warp's Q as m16n8k16 A fragments, straight from device memory
    uint32_t qa[AHD / 16][4];
    load_a_rows(qh, q0 + warp * 16, Np, g, t, qa);
    if (mode == MODE_Q_PASSTHROUGH) {
      // the A fragments are this warp's 16 rows of q, two bf16 a register
#pragma unroll
      for (int kc = 0; kc < AHD / 16; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = warp * 16 + g + (e & 1) * 8;
          const int c = h * AHD + kc * 16 + (e >> 1) * 8 + 2 * t;
          *reinterpret_cast<uint32_t*>(ob + r * L::LDO + c) = qa[kc][e];
        }
      continue;
    }
    TileRegs<KT> kr, vr;
    fetch_tile<KT>(kh, 0, Np, kr);
    store_tile<KT>(kr, ks);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8
    if (two_pass) {
      // pass 1: each row's max and sum of exp(s - max), kept per thread over
      // its columns (rescaled when the max moves), merged over the quad;
      // norm_before keeps the max at 0
      if (mode == MODE_NORM_BEFORE) m[0] = m[1] = 0.f;
      __syncthreads();
      for (int kt = 0; kt < n_kt; ++kt) {
        if (kt + 1 < n_kt) fetch_tile<KT>(kh, (kt + 1) * KT, Np, kr);
        float s[NB][4];
        score_tile<KT>(qa, ks, kt * KT, n_real, g, t, s);
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          if (mode == MODE_NORM_BEFORE) {
            float e = 0.f;
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
              e += expf(s[nb][2 * hr]) + expf(s[nb][2 * hr + 1]);
            l[hr] += e;
            continue;
          }
          float tmax = s[0][2 * hr];
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            tmax = fmaxf(tmax, fmaxf(s[nb][2 * hr], s[nb][2 * hr + 1]));
          const float mn = fmaxf(m[hr], tmax);
          float e = 0.f;
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
            e += expf(s[nb][2 * hr] - mn) + expf(s[nb][2 * hr + 1] - mn);
          l[hr] = l[hr] * expf(m[hr] - mn) + e;
          m[hr] = mn;
        }
        __syncthreads();  // every warp is done with this K tile
        if (kt + 1 < n_kt) {
          store_tile<KT>(kr, ks);
          __syncthreads();
        }
      }
      if (mode == MODE_NORM_BEFORE) {
        l[0] = quad_sum(l[0]);
        l[1] = quad_sum(l[1]);
      } else {
        merge_row_stats(m[0], l[0]);
        merge_row_stats(m[1], l[1]);
      }
      fetch_tile<KT>(kh, 0, Np, kr);
      store_tile<KT>(kr, ks);
    }
    fetch_tile<KT>(vh, 0, Np, vr);
    store_tile<KT>(vr, vs);
    __syncthreads();
    // pass 2 (the only pass of the one-pass modes): P, rounded to bf16, times V
    float o[AHD / 8][4];
#pragma unroll
    for (int db = 0; db < AHD / 8; ++db)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[db][e] = 0.f;
    float sum[2] = {0.f, 0.f};  // the exp modes: this thread's share of the row sums
    for (int kt = 0; kt < n_kt; ++kt) {
      if (kt + 1 < n_kt) {
        fetch_tile<KT>(kh, (kt + 1) * KT, Np, kr);
        fetch_tile<KT>(vh, (kt + 1) * KT, Np, vr);
      }
      float s[NB][4];
      score_tile<KT>(qa, ks, kt * KT, n_real, g, t, s);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          float p;
          if (two_pass) {
            p = expf(s[nb][e] - m[hr]) / l[hr];
          } else if (mode == MODE_FAST) {
            p = expf(s[nb][e]);
            sum[hr] += p;
          } else if (mode == MODE_BF16_EXP) {
            p = expf(round_bf16(s[nb][e]));
            sum[hr] += p;
          } else {  // no_softmax: the raw score, 0 on the masked columns
            p = kt * KT + nb * 8 + 2 * t + (e & 1) < n_real ? s[nb][e] : 0.f;
          }
          s[nb][e] = p;
        }
      }
      // P of the tile, rounded to bf16, as the A operand of P V (the
      // accumulator layout of two column blocks is the A layout)
      pv_tile<KT>(s, vs, lane, o);
      __syncthreads();  // every warp is done with this K and V tile
      if (kt + 1 < n_kt) {
        store_tile<KT>(kr, ks);
        store_tile<KT>(vr, vs);
        __syncthreads();
      }
    }
    float scale[2] = {1.f, 1.f};
    if (scaled) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        scale[hr] = 1.f / quad_sum(sum[hr]);
      }
    }
    // this head's 16 x 64 output of the warp, rounded to bf16, into ob
#pragma unroll
    for (int db = 0; db < AHD / 8; ++db) {
      const int c = h * AHD + db * 8 + 2 * t;
      float v0 = o[db][0], v1 = o[db][1], v2 = o[db][2], v3 = o[db][3];
      if (scaled) {
        v0 *= scale[0];
        v1 *= scale[0];
        v2 *= scale[1];
        v3 *= scale[1];
      }
      *reinterpret_cast<uint32_t*>(ob + row0 * L::LDO + c) = pack_bf16(v0, v1);
      *reinterpret_cast<uint32_t*>(ob + (row0 + 8) * L::LDO + c) = pack_bf16(v2, v3);
    }
  }
  __syncthreads();  // every head's output is in ob; k / v become staging

  // proj (K = C) + b_proj + x -> out; a unit is one 16-wide weight column
  // tile against the 4 row tiles
  float* stage = reinterpret_cast<float*>(smem + L::off_k) + warp * 256;
  constexpr int NCT = C / 16;
  for (int ct = warp; ct < NCT; ct += AWARPS) {
    const int n0 = ct * 16;
    FragC acc[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) wmma::fill_fragment(acc[r], 0.f);
#pragma unroll 2
    for (int k0 = 0; k0 < C; k0 += 16) {
      FragBc bw;
      wmma::load_matrix_sync(bw, w_proj + (size_t)n0 * C + k0, C);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        FragA a;
        wmma::load_matrix_sync(a, ob + r * 16 * L::LDO + k0, L::LDO);
        wmma::mma_sync(acc[r], a, bw, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      wmma::store_matrix_sync(stage, acc[r], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int tq = q0 + r * 16 + e / 16;
        const int c = n0 + e % 16;
        if (tq < Np) {
          const size_t off = ((size_t)b * Np + tq) * C + c;
          out[off] = __float2bfloat16(__bfloat162float(x[off]) + (stage[e] + b_proj[c]));
        }
      }
      __syncwarp();
    }
  }
}

template <int C>
static cudaError_t launch_vit_attn(const void* x, const void* qkv, void* out,
                                   const void* w_proj, const void* b_proj, int B, int Np,
                                   int heads, int n_real, int mode,
                                   cudaStream_t stream) {
  const size_t smem = VitAttnSmem<C>::bytes;
  auto kernel = vit_attn_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Np + AQ - 1) / AQ, B);
  kernel<<<grid, ATHREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(qkv), static_cast<bf16*>(out),
      static_cast<const bf16*>(w_proj), static_cast<const float*>(b_proj), Np, heads, n_real,
      mode);
  return cudaGetLastError();
}

}  // namespace hmdt

// C interface for ctypes. Returns cudaGetLastError() after the launch (0 on
// success). x and out distinct (B, Np, C) bf16; qkv (3, B, heads, Np, 64)
// bf16; w_proj (C, C) bf16; b_proj float32; keys >= n_real are masked;
// mode 0-5 as at the top of this file.
extern "C" int vit_attn_launch(const void* x, const void* qkv, void* out,
                               const void* w_proj, const void* b_proj, int B, int Np,
                               int C, int heads, int n_real, int mode, void* stream) {
  using namespace hmdt;
  if (B <= 0 || Np <= 0 || n_real <= 0 || n_real > Np || heads * AHD != C ||
      B > 65535 || mode < 0 || mode >= N_MODES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 384:
      return (int)launch_vit_attn<384>(x, qkv, out, w_proj, b_proj, B, Np, heads, n_real,
                                       mode, s);
    case 768:
      return (int)launch_vit_attn<768>(x, qkv, out, w_proj, b_proj, B, Np, heads, n_real,
                                       mode, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
