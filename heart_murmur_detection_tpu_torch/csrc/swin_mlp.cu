// swin_mlp: the MLP half of an HTS-AT swin block, per token,
//   y = x + k[tok / hw] * fc2(GELU(fc1(LN2(x)))),  x (n_tokens, C) bf16;
//   k is an optional per-sample multiplier of the training forward (null: 1).
//   LN2's eps is an argument: 1e-5 for the swin blocks, 1e-6 for ViT.
//
// Replaces the MLP body `_strip_mlp` (heart_murmur_detection_tpu/ops/
// pallas_swin.py:388) that the TPU kernels fused_swin_block (:480),
// fused_swin_pair (:847) and fused_swin_block_split (:618, MLP half) run,
// the MLP half of `_train_fwd_kernel` (ops/pallas_swin_train.py:233, K8),
// and, as `vit_mlp`, the ViT MLP body `_mlp_half` (ops/pallas_vit.py:149)
// of fused_vit_block (:296, K5) and fused_vit_mlp (:373, K7): the same
// token-wise LN, fc1, exact GELU, fc2 and residual.
//
// Design. A cluster of CS blocks of 8 warps handles a tile of T tokens (64
// at C <= 384, 32 at C = 768, where a 64-token f32 accumulator would not
// fit beside LN(x)); CS is 2 at C = 384 and 4 at C = 768 while the tiles
// alone would leave most SMs idle (use_cluster: the clustered grid stays
// within two waves, so the serving batch B = 16), else 1. Each block keeps
// LN2 of the tile in shared memory as bf16 and walks its share of the hidden
// dimension in chunks of 128: fc1 for the chunk, + b_fc1, exact erf GELU in
// f32, rounded to bf16 into shared memory, then fc2 of the chunk accumulates
// into float32 WMMA fragments held in registers across chunks. In both
// products a warp takes one 16-wide weight column tile against a group of
// 16-token row tiles, so each weight fragment read from L2 feeds that many
// MMAs; each accumulator still sums over k in the same order. With CS > 1
// the blocks park their fc2 partial sums in shared memory and each sums its
// share of the output columns over the cluster, in rank order, through
// distributed shared memory. The epilogue adds b_fc2 and the residual (x
// re-read from global memory) and rounds once to bf16, as the TPU body does.
//
// Bound on this card: 16 C^2 FLOPs a token against 4 C bytes of activation
// traffic, so at C >= 96 the FLOPs dominate; every block re-reads its
// weight rows from L2, and the latency of those reads bounds this version.
// Later work: larger token tiles and wgmma with TMA-fed weight tiles.
#include <cooperative_groups.h>

#include "swin_common.cuh"

namespace hmdt {

namespace cg = cooperative_groups;

constexpr int HC = 128;  // hidden chunk

// blocks per token tile (the hidden dimension is split over them)
template <int C>
constexpr int mlp_cluster() {
  return C >= 768 ? 4 : (C >= 384 ? 2 : 1);
}

template <int C, int T, int CS>
struct MlpSmem {
  static constexpr int LDX = C + PAD;
  static constexpr int LDG = HC + PAD;
  static constexpr int LDP = C + 4;  // fc2 partial rows (f32)
  static constexpr size_t XN = (size_t)T * LDX * 2;
  static constexpr size_t G = (size_t)T * LDG * 2;
  static constexpr size_t STAGE = (size_t)NWARPS * 256 * 4;
  static constexpr size_t PART = CS > 1 ? (size_t)T * LDP * 4 : 0;
  static constexpr size_t off_xn = 0;
  static constexpr size_t off_g = XN;
  static constexpr size_t off_stage = XN + G;
  static constexpr size_t off_part = off_stage + STAGE;
  static constexpr size_t bytes = off_part + PART;
  static_assert(XN % 128 == 0 && G % 128 == 0, "regions must stay 128-byte aligned");
  static_assert(bytes <= SMEM_LIMIT, "shared memory over the sm_90 limit");
};

// Two blocks an SM at C <= 192 (128 registers a thread), where a tile's
// shared memory leaves room for them; the k loops unroll by 2 because the
// row group already gives each warp independent MMAs. Both choices were the
// fastest of the variants timed on an H100 at the HTS-AT stage shapes.
template <int C, int T, int CS>
__global__ void __launch_bounds__(NTHREADS, (C <= 192 ? 2 : 1))
swin_mlp_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                const bf16* __restrict__ w1, const float* __restrict__ b1,
                const bf16* __restrict__ w2, const float* __restrict__ b2,
                const float* __restrict__ kmul, int n_tokens, int hidden, int hw,
                float eps) {
  using L = MlpSmem<C, T, CS>;
  constexpr int RT = T / 16;
  constexpr int CT = C / 16;
  constexpr int G1 = row_group(RT, HC / 16);             // fc1: row tiles per unit
  constexpr int U1 = (HC / 16) * (RT / G1);              // fc1 units per chunk
  constexpr int G2 = row_group(RT, CT);                  // fc2: row tiles per unit
  constexpr int UPW = CT * (RT / G2) / NWARPS;           // fc2 units per warp
  static_assert((CT * (RT / G2)) % NWARPS == 0, "fc2 units must split evenly over the warps");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xn = reinterpret_cast<bf16*>(smem + L::off_xn);
  bf16* g = reinterpret_cast<bf16*>(smem + L::off_g);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* stage = reinterpret_cast<float*>(smem + L::off_stage) + warp * 256;
  const int tok0 = (blockIdx.x / CS) * T;
  int rank = 0;  // this block's place in the tile's cluster
  if constexpr (CS > 1) rank = (int)cg::this_cluster().block_rank();
  const int h_per = hidden / CS;  // hidden units of this block

  // LN2 of the tile's tokens -> xn (rows past n_tokens are zero)
  for (int t = warp; t < T; t += NWARPS) {
    const int tok = tok0 + t;
    if (tok < n_tokens) {
      ln_token<C>(x + (size_t)tok * C, ln_w, ln_b, xn + t * L::LDX, lane, nullptr, nullptr,
                  eps);
    } else {
      for (int c = lane; c < C; c += 32) xn[t * L::LDX + c] = __float2bfloat16(0.f);
    }
  }
  // fc2 accumulators: unit j of this warp is column tile u % CT and row
  // tiles (u / CT) * G2 + r, with u = warp + j * NWARPS
  FragC acc[UPW][G2];
#pragma unroll
  for (int j = 0; j < UPW; ++j)
#pragma unroll
    for (int r = 0; r < G2; ++r) wmma::fill_fragment(acc[j][r], 0.f);
  __syncthreads();

  for (int h0 = rank * h_per; h0 < (rank + 1) * h_per; h0 += HC) {
    // fc1 of the chunk: (T x C) @ (C x HC) + b_fc1 -> GELU -> g (bf16)
    for (int u = warp; u < U1; u += NWARPS) {
      const int ct = u % (HC / 16);
      const int rt0 = (u / (HC / 16)) * G1;
      const int n0 = h0 + ct * 16;
      FragC a1[G1];
#pragma unroll
      for (int r = 0; r < G1; ++r) wmma::fill_fragment(a1[r], 0.f);
#pragma unroll 2
      for (int k0 = 0; k0 < C; k0 += 16) {
        FragBc bw;
        wmma::load_matrix_sync(bw, w1 + (size_t)n0 * C + k0, C);
#pragma unroll
        for (int r = 0; r < G1; ++r) {
          FragA a;
          wmma::load_matrix_sync(a, xn + (rt0 + r) * 16 * L::LDX + k0, L::LDX);
          wmma::mma_sync(a1[r], a, bw, a1[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < G1; ++r) {
        wmma::store_matrix_sync(stage, a1[r], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int c = e % 16;
          const float v = stage[e] + b1[n0 + c];
          const float gelu = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
          g[((rt0 + r) * 16 + e / 16) * L::LDG + ct * 16 + c] = __float2bfloat16(gelu);
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // fc2 of the chunk: acc += g (T x HC) @ W2[:, h0:h0+HC]^T
#pragma unroll
    for (int j = 0; j < UPW; ++j) {
      const int u = warp + j * NWARPS;
      const int ct = u % CT;
      const int rt0 = (u / CT) * G2;
#pragma unroll 2
      for (int k0 = 0; k0 < HC; k0 += 16) {
        FragBc bw;
        wmma::load_matrix_sync(bw, w2 + (size_t)(ct * 16) * hidden + h0 + k0, hidden);
#pragma unroll
        for (int r = 0; r < G2; ++r) {
          FragA a;
          wmma::load_matrix_sync(a, g + (rt0 + r) * 16 * L::LDG + k0, L::LDG);
          wmma::mma_sync(acc[j][r], a, bw, acc[j][r]);
        }
      }
    }
    __syncthreads();
  }

  if constexpr (CS == 1) {
    // epilogue: + b_fc2 + x -> out
#pragma unroll
    for (int j = 0; j < UPW; ++j) {
      const int u = warp + j * NWARPS;
      const int ct = u % CT;
#pragma unroll
      for (int r = 0; r < G2; ++r) {
        const int rt = (u / CT) * G2 + r;
        wmma::store_matrix_sync(stage, acc[j][r], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int tok = tok0 + rt * 16 + e / 16;
          const int c = ct * 16 + e % 16;
          if (tok < n_tokens) {
            const size_t off = (size_t)tok * C + c;
            const float br = stage[e] + b2[c];
            out[off] = __float2bfloat16(__bfloat162float(x[off]) +
                                        (kmul ? kmul[tok / hw] * br : br));
          }
        }
        __syncwarp();
      }
    }
  } else {
    // park the fc2 partials, then sum this block's C / CS output columns
    // over the cluster in rank order, + b_fc2 + x -> out
    float* part = reinterpret_cast<float*>(smem + L::off_part);
#pragma unroll
    for (int j = 0; j < UPW; ++j) {
      const int u = warp + j * NWARPS;
#pragma unroll
      for (int r = 0; r < G2; ++r) {
        const int rt = (u / CT) * G2 + r;
        wmma::store_matrix_sync(part + rt * 16 * L::LDP + (u % CT) * 16, acc[j][r], L::LDP,
                                wmma::mem_row_major);
      }
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's partials are in its shared memory
    constexpr int CB = C / CS;  // output columns of this block
    const float* parts[CS];
#pragma unroll
    for (int r = 0; r < CS; ++r) parts[r] = cluster.map_shared_rank(part, r);
    for (int i = threadIdx.x; i < T * CB; i += NTHREADS) {
      const int t = i / CB;
      const int c = rank * CB + i % CB;
      const int tok = tok0 + t;
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < CS; ++r) s += parts[r][t * L::LDP + c];
      if (tok < n_tokens) {
        const size_t off = (size_t)tok * C + c;
        const float br = s + b2[c];
        out[off] = __float2bfloat16(__bfloat162float(x[off]) +
                                    (kmul ? kmul[tok / hw] * br : br));
      }
    }
    cluster.sync();  // no block leaves while another still reads its partials
  }
}

template <int C, int T, int CS>
static cudaError_t launch_mlp_cs(const void* x, void* out, const void* ln_w,
                                 const void* ln_b, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* kmul,
                                 int n_tokens, int hidden, int hw, float eps,
                                 cudaStream_t stream) {
  const size_t smem = MlpSmem<C, T, CS>::bytes;
  auto kernel = swin_mlp_kernel<C, T, CS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_tokens + T - 1) / T * CS);
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
      static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(kmul), n_tokens, hidden, hw, eps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int C, int T>
static cudaError_t launch_mlp(const void* x, void* out, const void* ln_w,
                              const void* ln_b, const void* w1, const void* b1,
                              const void* w2, const void* b2, const void* kmul,
                              int n_tokens, int hidden, int hw, float eps,
                              cudaStream_t stream) {
  constexpr int CS = mlp_cluster<C>();
  // a cluster needs whole hidden chunks a block
  if (CS > 1 && hidden % (HC * CS) == 0 && use_cluster((n_tokens + T - 1) / T, CS))
    return launch_mlp_cs<C, T, CS>(x, out, ln_w, ln_b, w1, b1, w2, b2, kmul,
                                   n_tokens, hidden, hw, eps, stream);
  return launch_mlp_cs<C, T, 1>(x, out, ln_w, ln_b, w1, b1, w2, b2, kmul, n_tokens,
                                hidden, hw, eps, stream);
}

}  // namespace hmdt

// C interface for ctypes. Returns cudaGetLastError() after the launch (0 on
// success); x and out are distinct (n_tokens, C) bf16 buffers; kmul (one
// float per sample of hw tokens) may be null; eps is LN2's epsilon.
extern "C" int swin_mlp_launch(const void* x, void* out, const void* ln_w,
                               const void* ln_b, const void* w_fc1,
                               const void* b_fc1, const void* w_fc2,
                               const void* b_fc2, const void* kmul, int n_tokens,
                               int C, int hidden, int hw, float eps, void* stream) {
  using namespace hmdt;
  if (n_tokens <= 0 || hidden <= 0 || hidden % HC || hw <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 96:
      return (int)launch_mlp<96, 64>(x, out, ln_w, ln_b, w_fc1, b_fc1, w_fc2, b_fc2, kmul, n_tokens, hidden, hw, eps, s);
    case 192:
      return (int)launch_mlp<192, 64>(x, out, ln_w, ln_b, w_fc1, b_fc1, w_fc2, b_fc2, kmul, n_tokens, hidden, hw, eps, s);
    case 384:
      return (int)launch_mlp<384, 64>(x, out, ln_w, ln_b, w_fc1, b_fc1, w_fc2, b_fc2, kmul, n_tokens, hidden, hw, eps, s);
    case 768:
      return (int)launch_mlp<768, 32>(x, out, ln_w, ln_b, w_fc1, b_fc1, w_fc2, b_fc2, kmul, n_tokens, hidden, hw, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
