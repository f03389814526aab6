// swin_attn: the attention half of an HTS-AT swin block,
//   h1 = x + k[b] * proj(concat_h softmax(q_h k_h^T / sqrt(hd) + bias_h (+ mask)) v_h),
//   q, k, v = LN1(x) W_qkv + b_qkv, over 8x8 windows of x (B, H, W, C) bf16;
//   k is an optional per-sample multiplier (DropPath keep multipliers of the
//   training forward); without it (null) the eval block, k = 1.
//
// Replaces the attention body `_strip_attn` (heart_murmur_detection_tpu/ops/
// pallas_swin.py:97) that the TPU kernels fused_swin_block (:480),
// fused_swin_pair (:847) and fused_swin_block_split (:618, attention half)
// run, and the attention half of the training forward `_train_fwd_kernel`
// (ops/pallas_swin_train.py:233, K8).
//
// Design. A cluster of CS blocks of 8 warps handles one window of one clip:
// CS is 2 at C = 384 and 4 at C = 768 (8 heads a block) while the windows
// alone would leave most SMs idle (use_cluster: the clustered grid stays
// within two waves), else 1. The cyclic shift of a shifted block is in the
// addressing on both axes: token (r, c) of rolled window (i, j) is read from
// and written back to x[(8i+r+s) mod H, (8j+c+s) mod W], and the mask is
// indexed by (i, j) in the rolled frame, so no rolled copy of x exists.
// Each block keeps LN1(x)
// of the window (64 x C bf16) in shared memory and runs its heads one at a
// time: q/k/v (64 x 32 each, hd padded to 32 with zero weight rows; a warp
// takes one 16-wide weight column tile against several 16-token row tiles,
// so each weight fragment read from L2 feeds several MMAs) ->
// scores (64 x 64 f32) -> softmax -> P v, whose 24 real columns go into a
// 64 x C bf16 buffer. The blocks of a cluster then copy each other's head
// columns through distributed shared memory, and each computes proj for its
// share of the output columns; the residual re-reads x. Rounded to bf16
// where the TPU body rounds: qkv, the scaled q, the attention output and h1.
// At C = 768 the two 64 x C buffers take 194 KB of the 227 KB; everything
// per head shares the remaining 33 KB (P aliases q/k, the per-warp staging
// aliases the scores).
//
// Bound on this card: the window's FLOPs are small (~0.4 GFLOP a window at
// C = 768) and every block re-reads its weights from L2, so this version is
// bound by the latency of those reads and by WMMA issue, not by HBM; the
// stage-3 map is a single window a clip, which is why its heads are spread
// over a cluster. Later work: several windows per block to amortise the
// weight reads, wgmma with TMA-fed weight tiles.
#include <cooperative_groups.h>

#include "swin_common.cuh"

namespace hmdt {

namespace cg = cooperative_groups;

// blocks per window: 8 or fewer heads a block at hd = 24
template <int C>
constexpr int attn_cluster() {
  return C >= 768 ? 4 : (C >= 384 ? 2 : 1);
}

template <int C>
struct AttnSmem {
  static constexpr int LDX = C + PAD;     // LN(x) and attention-output rows (bf16)
  static constexpr int LDH = HDP + PAD;   // q / k / v rows (bf16)
  static constexpr int LDS = NTOK + 4;    // score rows (f32)
  static constexpr int LDP = NTOK + PAD;  // probability rows (bf16)
  static constexpr size_t XN = (size_t)NTOK * LDX * 2;
  static constexpr size_t QK = 2 * (size_t)NTOK * LDH * 2;
  static constexpr size_t V = (size_t)NTOK * LDH * 2;
  static constexpr size_t S = (size_t)NTOK * LDS * 4;
  static constexpr size_t off_xn = 0;
  static constexpr size_t off_o = XN;
  static constexpr size_t off_qk = 2 * XN;
  static constexpr size_t off_v = off_qk + QK;
  static constexpr size_t off_s = off_v + V;
  static constexpr size_t off_recip = off_s + S;
  static constexpr size_t bytes = off_recip + NTOK * 4;
  static_assert((size_t)NTOK * LDP * 2 <= QK, "P must fit in the q/k region");
  static_assert((size_t)NWARPS * 256 * 4 <= S, "staging must fit in the score region");
  static_assert(XN % 128 == 0 && QK % 128 == 0 && V % 128 == 0 && S % 128 == 0,
                "shared-memory regions must stay 128-byte aligned");
  static_assert(bytes <= SMEM_LIMIT, "shared memory over the sm_90 limit");
};

template <int C, int CS>
__global__ void __launch_bounds__(NTHREADS)
swin_attn_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                 const bf16* __restrict__ w_qkv, const float* __restrict__ b_qkv,
                 const bf16* __restrict__ w_proj, const float* __restrict__ b_proj,
                 const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                 const float* __restrict__ bias, const float* __restrict__ mask,
                 const float* __restrict__ kmul,
                 int H, int W, int heads, int shift, int fast_softmax) {
  using L = AttnSmem<C>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xn = reinterpret_cast<bf16*>(smem + L::off_xn);
  bf16* ob = reinterpret_cast<bf16*>(smem + L::off_o);
  bf16* qs = reinterpret_cast<bf16*>(smem + L::off_qk);
  bf16* ks = qs + NTOK * L::LDH;
  bf16* ps = qs;  // probabilities overwrite q/k once the scores exist
  bf16* vs = reinterpret_cast<bf16*>(smem + L::off_v);
  float* sf = reinterpret_cast<float*>(smem + L::off_s);
  float* recip = reinterpret_cast<float*>(smem + L::off_recip);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* stage = sf + warp * 256;  // this warp's 16 x 16 f32 staging tile
  const int nww = W / WIN;
  const int win = blockIdx.x / CS;  // window index in the rolled frame
  const int wi = win / nww;
  const int wj = win % nww;
  const int b = blockIdx.y;
  int rank = 0;  // this block's place in the window's cluster
  if constexpr (CS > 1) rank = (int)cg::this_cluster().block_rank();
  const int hd = C / heads;
  const int Cp = heads * HDP;
  const int hpb = heads / CS;  // heads of this block
  // qkv: a unit is one column tile against all 4 row tiles, so each weight
  // fragment read from L2 feeds 4 MMAs; that leaves 6 units for 8 warps,
  // and still timed faster on an H100 than units of 2 or 1 row tiles
  constexpr int QG = 4;
  // hd^-0.5 as the bf16 flow applies it: a bf16 constant times bf16 q
  const float qscale = __bfloat162float(__float2bfloat16(1.0f / sqrtf((float)hd)));
  const float* mask_w = mask ? mask + (size_t)win * NTOK * NTOK : nullptr;

  // element offset of token t of this (rolled) window in x and out
  auto tok_off = [&](int t) -> size_t {
    const int r = (wi * WIN + t / WIN + shift) % H;
    const int c = (wj * WIN + t % WIN + shift) % W;
    return (((size_t)b * H + r) * W + c) * C;
  };

  // 1. LN1 of the window's tokens -> xn
  for (int t = warp; t < NTOK; t += NWARPS)
    ln_token<C>(x + tok_off(t), ln_w, ln_b, xn + t * L::LDX, lane);
  __syncthreads();

  for (int h = rank * hpb; h < (rank + 1) * hpb; ++h) {
    // 2. q, k, v of head h: three (64 x C) @ (C x 32) products, 6 column
    // tiles of 4 row tiles; a unit is one column tile times QG row tiles
    for (int u = warp; u < 6 * (4 / QG); u += NWARPS) {
      const int which = (u % 6) / 2;  // 0 q, 1 k, 2 v
      const int ct = u % 2;
      const int rt0 = (u / 6) * QG;
      const int n0 = which * Cp + h * HDP + ct * 16;  // first output feature
      FragC acc[QG];
#pragma unroll
      for (int r = 0; r < QG; ++r) wmma::fill_fragment(acc[r], 0.f);
#pragma unroll 2
      for (int k0 = 0; k0 < C; k0 += 16) {
        FragBc bw;
        wmma::load_matrix_sync(bw, w_qkv + (size_t)n0 * C + k0, C);
#pragma unroll
        for (int r = 0; r < QG; ++r) {
          FragA a;
          wmma::load_matrix_sync(a, xn + (rt0 + r) * 16 * L::LDX + k0, L::LDX);
          wmma::mma_sync(acc[r], a, bw, acc[r]);
        }
      }
      bf16* dst = which == 0 ? qs : (which == 1 ? ks : vs);
#pragma unroll
      for (int r = 0; r < QG; ++r) {
        wmma::store_matrix_sync(stage, acc[r], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int c = e % 16;
          bf16 v = __float2bfloat16(stage[e] + b_qkv[n0 + c]);
          if (which == 0) v = __float2bfloat16(__bfloat162float(v) * qscale);
          dst[((rt0 + r) * 16 + e / 16) * L::LDH + ct * 16 + c] = v;
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // 3. scores q k^T (64 x 64, K = 32), 16 tiles
    for (int tile = warp; tile < 16; tile += NWARPS) {
      const int rt = tile / 4;
      const int ct = tile % 4;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int k0 = 0; k0 < HDP; k0 += 16) {
        FragA a;
        FragBc bk;
        wmma::load_matrix_sync(a, qs + rt * 16 * L::LDH + k0, L::LDH);
        wmma::load_matrix_sync(bk, ks + ct * 16 * L::LDH + k0, L::LDH);
        wmma::mma_sync(acc, a, bk, acc);
      }
      wmma::store_matrix_sync(sf + rt * 16 * L::LDS + ct * 16, acc, L::LDS,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // 4. + bias (+ mask), softmax over each row in f32 -> P (bf16)
    const float* bias_h = bias + (size_t)h * NTOK * NTOK;
    for (int r = warp; r < NTOK; r += NWARPS) {
      float a0 = sf[r * L::LDS + lane] + bias_h[r * NTOK + lane];
      float a1 = sf[r * L::LDS + lane + 32] + bias_h[r * NTOK + lane + 32];
      if (mask_w) {
        a0 += mask_w[r * NTOK + lane];
        a1 += mask_w[r * NTOK + lane + 32];
      }
      float e0, e1;
      if (fast_softmax) {
        // unnormalised; the row sum divides the P v output instead
        e0 = expf(a0);
        e1 = expf(a1);
        const float s = warp_sum(e0 + e1);
        if (lane == 0) recip[r] = 1.f / s;
      } else {
        const float m = warp_max(fmaxf(a0, a1));
        e0 = expf(a0 - m);
        e1 = expf(a1 - m);
        const float s = warp_sum(e0 + e1);
        e0 = e0 / s;
        e1 = e1 / s;
      }
      ps[r * L::LDP + lane] = __float2bfloat16(e0);
      ps[r * L::LDP + lane + 32] = __float2bfloat16(e1);
    }
    __syncthreads();

    // 5. P v (64 x 32, K = 64), 8 tiles; the hd real columns go to ob
    for (int tile = warp; tile < 8; tile += NWARPS) {
      const int rt = tile / 2;
      const int ct = tile % 2;
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int k0 = 0; k0 < NTOK; k0 += 16) {
        FragA a;
        FragBr bv;
        wmma::load_matrix_sync(a, ps + rt * 16 * L::LDP + k0, L::LDP);
        wmma::load_matrix_sync(bv, vs + k0 * L::LDH + ct * 16, L::LDH);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(stage, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = rt * 16 + e / 16;
        const int c = ct * 16 + e % 16;
        if (c < hd) {
          float v = stage[e];
          if (fast_softmax) v *= recip[r];
          ob[r * L::LDX + h * hd + c] = __float2bfloat16(v);
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }

  // 6. gather the other blocks' head columns of ob through distributed
  // shared memory (16-byte copies of each row's segment)
  if constexpr (CS > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's head outputs are in its ob
    const int nvec = hpb * hd * 2 / 16;  // 16-byte pieces of one row's segment
    for (int r = 0; r < CS; ++r) {
      if (r == rank) continue;
      const bf16* remote = cluster.map_shared_rank(ob, r);
      for (int i = threadIdx.x; i < NTOK * nvec; i += NTHREADS) {
        const size_t off = (size_t)(i / nvec) * L::LDX + r * hpb * hd;
        reinterpret_cast<int4*>(ob + off)[i % nvec] =
            reinterpret_cast<const int4*>(remote + off)[i % nvec];
      }
    }
    cluster.sync();  // no block leaves while another still reads its ob
  }

  // 7. proj for this block's C / CS output columns (K = C) + b_proj + x;
  // a unit is one column tile times PG row tiles
  constexpr int NCT = C / 16 / CS;
  static_assert(C % (16 * CS) == 0, "proj columns must split into 16-wide tiles");
  constexpr int PG = row_group(4, NCT);
  const int col0 = rank * (C / CS);
  for (int u = warp; u < NCT * (4 / PG); u += NWARPS) {
    const int n0 = col0 + (u % NCT) * 16;
    const int rt0 = (u / NCT) * PG;
    FragC acc[PG];
#pragma unroll
    for (int r = 0; r < PG; ++r) wmma::fill_fragment(acc[r], 0.f);
#pragma unroll 2
    for (int k0 = 0; k0 < C; k0 += 16) {
      FragBc bw;
      wmma::load_matrix_sync(bw, w_proj + (size_t)n0 * C + k0, C);
#pragma unroll
      for (int r = 0; r < PG; ++r) {
        FragA a;
        wmma::load_matrix_sync(a, ob + (rt0 + r) * 16 * L::LDX + k0, L::LDX);
        wmma::mma_sync(acc[r], a, bw, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < PG; ++r) {
      wmma::store_matrix_sync(stage, acc[r], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = (rt0 + r) * 16 + e / 16;
        const int c = n0 + e % 16;
        const size_t off = tok_off(row) + c;
        const float br = stage[e] + b_proj[c];
        out[off] = __float2bfloat16(__bfloat162float(x[off]) + (kmul ? kmul[b] * br : br));
      }
      __syncwarp();
    }
  }
}

template <int C, int CS>
static cudaError_t launch_attn_cs(const void* x, void* out, const void* w_qkv,
                                  const void* b_qkv, const void* w_proj,
                                  const void* b_proj, const void* ln_w,
                                  const void* ln_b, const void* bias,
                                  const void* mask, const void* kmul, int B, int H,
                                  int W, int heads, int shift, int fast_softmax,
                                  cudaStream_t stream) {
  const size_t smem = AttnSmem<C>::bytes;
  auto kernel = swin_attn_kernel<C, CS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((H / WIN) * (W / WIN) * CS, B);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(x), static_cast<bf16*>(out),
      static_cast<const bf16*>(w_qkv), static_cast<const float*>(b_qkv),
      static_cast<const bf16*>(w_proj), static_cast<const float*>(b_proj),
      static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
      static_cast<const float*>(bias), static_cast<const float*>(mask),
      static_cast<const float*>(kmul), H, W, heads, shift, fast_softmax);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int C>
static cudaError_t launch_attn(const void* x, void* out, const void* w_qkv,
                               const void* b_qkv, const void* w_proj,
                               const void* b_proj, const void* ln_w,
                               const void* ln_b, const void* bias,
                               const void* mask, const void* kmul, int B, int H,
                               int W, int heads, int shift, int fast_softmax,
                               cudaStream_t stream) {
  constexpr int CS = attn_cluster<C>();
  // a cluster needs whole heads a block and 16-byte pieces of gathered columns
  if (CS > 1 && heads % CS == 0 && ((heads / CS) * (C / heads)) % 8 == 0 &&
      use_cluster((long)(H / WIN) * (W / WIN) * B, CS))
    return launch_attn_cs<C, CS>(x, out, w_qkv, b_qkv, w_proj, b_proj, ln_w, ln_b,
                                 bias, mask, kmul, B, H, W, heads, shift,
                                 fast_softmax, stream);
  return launch_attn_cs<C, 1>(x, out, w_qkv, b_qkv, w_proj, b_proj, ln_w, ln_b,
                              bias, mask, kmul, B, H, W, heads, shift, fast_softmax,
                              stream);
}

}  // namespace hmdt

// C interface for ctypes. Returns cudaGetLastError() after the launch (0 on
// success); x and out are distinct (B, H, W, C) bf16 buffers; mask and kmul
// (B floats) may be null.
extern "C" int swin_attn_launch(const void* x, void* out, const void* w_qkv,
                                const void* b_qkv, const void* w_proj,
                                const void* b_proj, const void* ln_w,
                                const void* ln_b, const void* bias,
                                const void* mask, const void* kmul, int B, int H,
                                int W, int C,
                                int heads, int shift, int fast_softmax,
                                void* stream) {
  using namespace hmdt;
  if (B <= 0 || H % WIN || W % WIN || heads <= 0 || C % heads ||
      C / heads > HDP || shift < 0 || shift >= WIN)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HMDT_ATTN_CASE(CC)                                                     \
  case CC:                                                                     \
    return (int)launch_attn<CC>(x, out, w_qkv, b_qkv, w_proj, b_proj, ln_w,    \
                                ln_b, bias, mask, kmul, B, H, W, heads, shift, \
                                fast_softmax, s);
  switch (C) {
    HMDT_ATTN_CASE(96)
    HMDT_ATTN_CASE(192)
    HMDT_ATTN_CASE(384)
    HMDT_ATTN_CASE(768)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HMDT_ATTN_CASE
}
