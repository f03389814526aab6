// swin_mlp_bwd: backward of the MLP half of an HTS-AT training swin block,
//   y = h1 + k2[b] * fc2(GELU(fc1(LN2(h1)))),  h1, dy (n_tokens, C) bf16,
// given dy: dh1 = dy + LN2^T(dm), where with a1 = LN2(h1) W1^T + b1,
//   dyk = k2 dy,  da1 = (dyk W2) * GELU'(a1),  dm = da1 W1.
//
// Replaces the MLP half of the TPU backward, `_bwd_mlp_kernel`
// (heart_murmur_detection_tpu/ops/pallas_swin_train.py:271) of
// fused_swin_block_train (:606, K8).
//
// Outputs, besides dh1:
//   - the per-token operands of the two weight products, bf16 rows:
//     m_g = LN2(h1), g_g = GELU(a1), dyk_g = k2 dy, da1_g = da1, from which
//     swin_wgrad.cu forms dW1 = da1^T LN2(h1) and dW2 = dyk^T GELU(a1);
//   - one float32 partial row per block, [db1 (4C) | db2 (C) | dLN2 w (C) |
//     dLN2 b (C)]: the column sums of da1, dyk, dm * xhat and dm over the
//     block's tiles, summed later in block order by swin_reduce. No atomics:
//     each column is summed by one thread in token order.
//
// Design. A block walks a contiguous run of `tpb` tiles of 64 tokens. Per
// tile it recomputes LN2 (statistics kept), writes k2 dy as bf16, then walks
// the hidden dimension in chunks of 128: a1 of the chunk (WMMA, K = C) into
// float32 shared memory with GELU(a1) streamed out; dg = k2 dy W2[:, chunk]
// (K = C), da1 = dg * GELU'(a1) in place; da1 as bf16 feeds dm += da1
// W1[chunk, :] (K = 128), whose float32 accumulators stay in registers across
// the chunks, as the forward's fc2 does. dm then lands over LN2(h1) and k2 dy
// in shared memory, and the LN backward runs one warp a token. Rounded to
// bf16 where the plain version (ops/swin_train.py::swin_mlp_bwd_ref) rounds:
// the product operands LN2(h1), k2 dy, GELU(a1), da1, and dh1.
//
// Bound on this card: like the forward, ~24 C^2 FLOPs a token for its three
// products against ~28 C bytes of traffic (h1, dy, dh1 and the four operand
// rows), so the products dominate at these widths, and this first version is
// bound by the latency of the weight reads from L2 and by WMMA issue.
#include "swin_common.cuh"

namespace hmdt {

constexpr int BT = 64;    // tokens a tile
constexpr int BHC = 128;  // hidden chunk

template <int C>
struct MlpBwdSmem {
  static constexpr int HID = 4 * C;
  static constexpr int LDX = C + PAD;    // bf16 rows of LN2(h1) and k2 dy
  static constexpr int LDF = C + 4;      // f32 rows of dm (over the two above)
  static constexpr int LDA = BHC + 4;    // f32 rows of a1, then da1
  static constexpr int LDG = BHC + PAD;  // bf16 rows of da1
  static constexpr size_t XN = (size_t)BT * LDX * 2;
  static constexpr size_t A1 = (size_t)BT * LDA * 4;
  static constexpr size_t G = (size_t)BT * LDG * 2;
  static constexpr size_t STAGE = (size_t)NWARPS * 256 * 4;
  static constexpr size_t COLS = (size_t)(HID + 3 * C) * 4;
  static constexpr size_t off_m = 0;
  static constexpr size_t off_dyk = XN;
  static constexpr size_t off_a1 = 2 * XN;
  static constexpr size_t off_g = off_a1 + A1;
  static constexpr size_t off_stage = off_g + G;
  static constexpr size_t off_cols = off_stage + STAGE;
  static constexpr size_t off_stats = off_cols + COLS;
  static constexpr size_t bytes = off_stats + 2 * BT * 4;
  static_assert((size_t)BT * LDF * 4 <= 2 * XN, "dm must fit over LN2(h1) and k2 dy");
  static_assert(XN % 128 == 0 && A1 % 128 == 0 && G % 128 == 0 && COLS % 128 == 0,
                "shared-memory regions must stay 128-byte aligned");
  static_assert(bytes <= SMEM_LIMIT, "shared memory over the sm_90 limit");
};

template <int C>
__global__ void __launch_bounds__(NTHREADS, (C <= 96 ? 2 : 1))
swin_mlp_bwd_kernel(const bf16* __restrict__ h1, const bf16* __restrict__ dy,
                    const float* __restrict__ kmul, bf16* __restrict__ dh1,
                    const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                    const bf16* __restrict__ w1, const float* __restrict__ b1,
                    const bf16* __restrict__ w2, bf16* __restrict__ m_g,
                    bf16* __restrict__ g_g, bf16* __restrict__ dyk_g,
                    bf16* __restrict__ da1_g, float* __restrict__ part, int n_tiles,
                    int hw, int tpb) {
  using L = MlpBwdSmem<C>;
  constexpr int HID = L::HID;
  constexpr int PER = C / 32;
  constexpr int RT = BT / 16;
  constexpr int CT = C / 16;
  constexpr int HCT = BHC / 16;
  constexpr int G1 = row_group(RT, HCT);       // chunk products: row tiles per unit
  constexpr int U1 = HCT * (RT / G1);          // chunk product units
  constexpr int G2 = row_group(RT, CT);        // dm: row tiles per unit
  constexpr int UPW = CT * (RT / G2) / NWARPS; // dm units per warp
  static_assert((CT * (RT / G2)) % NWARPS == 0, "dm units must split evenly over the warps");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xm = reinterpret_cast<bf16*>(smem + L::off_m);
  bf16* dyk = reinterpret_cast<bf16*>(smem + L::off_dyk);
  float* dm = reinterpret_cast<float*>(smem + L::off_m);  // after the chunk loop
  float* a1 = reinterpret_cast<float*>(smem + L::off_a1);
  bf16* da1b = reinterpret_cast<bf16*>(smem + L::off_g);
  float* cols = reinterpret_cast<float*>(smem + L::off_cols);
  float* mu = reinterpret_cast<float*>(smem + L::off_stats);
  float* rstd = mu + BT;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* stage = reinterpret_cast<float*>(smem + L::off_stage) + warp * 256;

  // column sums [db1 | db2 | dLN2 w | dLN2 b]; every column has one owner thread
  for (int i = threadIdx.x; i < HID + 3 * C; i += NTHREADS) cols[i] = 0.f;

  const int tile_end = min(n_tiles, (int)(blockIdx.x + 1) * tpb);
  for (int tile = blockIdx.x * tpb; tile < tile_end; ++tile) {
    const size_t tok0 = (size_t)tile * BT;
    // 1. LN2(h1) of the tile -> xm, with its statistics
    for (int t = warp; t < BT; t += NWARPS)
      ln_token<C>(h1 + (tok0 + t) * C, ln_w, ln_b, xm + t * L::LDX, lane, mu + t, rstd + t);
    // 2. dyk = k2 dy -> bf16 in shared and global memory; db2 sums in f32
    for (int c = threadIdx.x; c < C; c += NTHREADS) {
      float s = 0.f;
      for (int t = 0; t < BT; ++t) {
        const size_t off = (tok0 + t) * C + c;
        const float v = kmul[(tok0 + t) / hw] * __bfloat162float(dy[off]);
        s += v;
        const bf16 vb = __float2bfloat16(v);
        dyk[t * L::LDX + c] = vb;
        dyk_g[off] = vb;
      }
      cols[HID + c] += s;
    }
    __syncthreads();
    copy_rows_out(xm, L::LDX, m_g + tok0 * C, BT, C);

    FragC acc[UPW][G2];  // dm: unit j of this warp is column tile u % CT, u = warp + j * NWARPS
#pragma unroll
    for (int j = 0; j < UPW; ++j)
#pragma unroll
      for (int r = 0; r < G2; ++r) wmma::fill_fragment(acc[j][r], 0.f);

    for (int h0 = 0; h0 < HID; h0 += BHC) {
      // 3. a1 = LN2(h1) W1[h0:h0+BHC]^T + b1 -> a1 (f32); GELU(a1) -> g_g
      for (int u = warp; u < U1; u += NWARPS) {
        const int ct = u % HCT;
        const int rt0 = (u / HCT) * G1;
        const int n0 = h0 + ct * 16;
        FragC f[G1];
#pragma unroll
        for (int r = 0; r < G1; ++r) wmma::fill_fragment(f[r], 0.f);
#pragma unroll 2
        for (int k0 = 0; k0 < C; k0 += 16) {
          FragBc bw;
          wmma::load_matrix_sync(bw, w1 + (size_t)n0 * C + k0, C);
#pragma unroll
          for (int r = 0; r < G1; ++r) {
            FragA a;
            wmma::load_matrix_sync(a, xm + (rt0 + r) * 16 * L::LDX + k0, L::LDX);
            wmma::mma_sync(f[r], a, bw, f[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < G1; ++r) {
          wmma::store_matrix_sync(stage, f[r], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int row = (rt0 + r) * 16 + e / 16;
            const int c = ct * 16 + e % 16;
            const float v = stage[e] + b1[h0 + c];
            a1[row * L::LDA + c] = v;
            g_g[(tok0 + row) * HID + h0 + c] = __float2bfloat16(gelu_exact(v));
          }
          __syncwarp();
        }
      }
      __syncthreads();

      // 4. dg = dyk W2[:, h0:h0+BHC]; da1 = dg * GELU'(a1) -> a1 (in place),
      //    da1b (bf16) and da1_g
      for (int u = warp; u < U1; u += NWARPS) {
        const int ct = u % HCT;
        const int rt0 = (u / HCT) * G1;
        const int n0 = h0 + ct * 16;
        FragC f[G1];
#pragma unroll
        for (int r = 0; r < G1; ++r) wmma::fill_fragment(f[r], 0.f);
#pragma unroll 2
        for (int k0 = 0; k0 < C; k0 += 16) {
          FragBr bw;
          wmma::load_matrix_sync(bw, w2 + (size_t)k0 * HID + n0, HID);
#pragma unroll
          for (int r = 0; r < G1; ++r) {
            FragA a;
            wmma::load_matrix_sync(a, dyk + (rt0 + r) * 16 * L::LDX + k0, L::LDX);
            wmma::mma_sync(f[r], a, bw, f[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < G1; ++r) {
          wmma::store_matrix_sync(stage, f[r], 16, wmma::mem_row_major);
          __syncwarp();
          for (int e = lane; e < 256; e += 32) {
            const int row = (rt0 + r) * 16 + e / 16;
            const int c = ct * 16 + e % 16;
            const float d = stage[e] * gelu_exact_grad(a1[row * L::LDA + c]);
            a1[row * L::LDA + c] = d;
            const bf16 db = __float2bfloat16(d);
            da1b[row * L::LDG + c] = db;
            da1_g[(tok0 + row) * HID + h0 + c] = db;
          }
          __syncwarp();
        }
      }
      __syncthreads();

      // 5. db1 sums of the chunk (f32, token order); 6. dm += da1 W1[chunk, :]
      for (int j = threadIdx.x; j < BHC; j += NTHREADS) {
        float s = 0.f;
        for (int t = 0; t < BT; ++t) s += a1[t * L::LDA + j];
        cols[h0 + j] += s;
      }
#pragma unroll
      for (int j = 0; j < UPW; ++j) {
        const int u = warp + j * NWARPS;
        const int ct = u % CT;
        const int rt0 = (u / CT) * G2;
#pragma unroll 2
        for (int k0 = 0; k0 < BHC; k0 += 16) {
          FragBr bw;
          wmma::load_matrix_sync(bw, w1 + (size_t)(h0 + k0) * C + ct * 16, C);
#pragma unroll
          for (int r = 0; r < G2; ++r) {
            FragA a;
            wmma::load_matrix_sync(a, da1b + (rt0 + r) * 16 * L::LDG + k0, L::LDG);
            wmma::mma_sync(acc[j][r], a, bw, acc[j][r]);
          }
        }
      }
      __syncthreads();
    }

    // 7. dm -> shared memory (f32, over LN2(h1) and k2 dy)
#pragma unroll
    for (int j = 0; j < UPW; ++j) {
      const int u = warp + j * NWARPS;
#pragma unroll
      for (int r = 0; r < G2; ++r) {
        const int rt = (u / CT) * G2 + r;
        wmma::store_matrix_sync(dm + rt * 16 * L::LDF + (u % CT) * 16, acc[j][r], L::LDF,
                                wmma::mem_row_major);
      }
    }
    __syncthreads();

    // 8. dLN2 sums: dm * xhat and dm, one thread a column
    for (int c = threadIdx.x; c < C; c += NTHREADS) {
      float sw = 0.f, sb = 0.f;
      for (int t = 0; t < BT; ++t) {
        const float xh = (__bfloat162float(h1[(tok0 + t) * C + c]) - mu[t]) * rstd[t];
        const float d = dm[t * L::LDF + c];
        sw += d * xh;
        sb += d;
      }
      cols[HID + C + c] += sw;
      cols[HID + 2 * C + c] += sb;
    }
    // 9. dh1 = dy + rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)), dxhat = dm w
    for (int t = warp; t < BT; t += NWARPS) {
      const size_t row = (tok0 + t) * C;
      float xh[PER], dxh[PER];
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int c = lane + 32 * i;
        xh[i] = (__bfloat162float(h1[row + c]) - mu[t]) * rstd[t];
        dxh[i] = dm[t * L::LDF + c] * ln_w[c];
        s1 += dxh[i];
        s2 += dxh[i] * xh[i];
      }
      const float m1 = warp_sum(s1) / (float)C;
      const float m2 = warp_sum(s2) / (float)C;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int c = lane + 32 * i;
        dh1[row + c] = __float2bfloat16(__bfloat162float(dy[row + c]) +
                                        rstd[t] * (dxh[i] - m1 - xh[i] * m2));
      }
    }
    __syncthreads();
  }
  // 10. this block's column sums -> its partial row
  for (int i = threadIdx.x; i < HID + 3 * C; i += NTHREADS)
    part[(size_t)blockIdx.x * (HID + 3 * C) + i] = cols[i];
}

template <int C>
static cudaError_t launch_mlp_bwd(const void* h1, const void* dy, const void* kmul,
                                  void* dh1, const void* ln_w, const void* ln_b,
                                  const void* w1, const void* b1, const void* w2,
                                  void* m_g, void* g_g, void* dyk_g, void* da1_g,
                                  void* part, int n_tokens, int hw, int tpb,
                                  cudaStream_t stream) {
  const size_t smem = MlpBwdSmem<C>::bytes;
  auto kernel = swin_mlp_bwd_kernel<C>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = n_tokens / BT;
  const int grid = (n_tiles + tpb - 1) / tpb;
  kernel<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(h1), static_cast<const bf16*>(dy),
      static_cast<const float*>(kmul), static_cast<bf16*>(dh1),
      static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<bf16*>(m_g), static_cast<bf16*>(g_g),
      static_cast<bf16*>(dyk_g), static_cast<bf16*>(da1_g), static_cast<float*>(part),
      n_tiles, hw, tpb);
  return cudaGetLastError();
}

}  // namespace hmdt

// C interface for ctypes. Returns cudaGetLastError() after the launch (0 on
// success). h1, dy, dh1 (n_tokens, C) bf16; kmul one float per sample of hw
// tokens; m_g, dyk_g (n_tokens, C) and g_g, da1_g (n_tokens, hidden) bf16;
// part (ceil(n_tokens / 64 / tpb), hidden + 3 C) f32.
extern "C" int swin_mlp_bwd_launch(const void* h1, const void* dy, const void* kmul,
                                   void* dh1, const void* ln_w, const void* ln_b,
                                   const void* w_fc1, const void* b_fc1,
                                   const void* w_fc2, void* m_g, void* g_g,
                                   void* dyk_g, void* da1_g, void* part, int n_tokens,
                                   int C, int hidden, int hw, int tpb, void* stream) {
  using namespace hmdt;
  if (n_tokens <= 0 || n_tokens % BT || hidden != 4 * C || hw <= 0 || tpb <= 0 || !kmul)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HMDT_MLP_BWD_CASE(CC)                                                   \
  case CC:                                                                      \
    return (int)launch_mlp_bwd<CC>(h1, dy, kmul, dh1, ln_w, ln_b, w_fc1, b_fc1, \
                                   w_fc2, m_g, g_g, dyk_g, da1_g, part,         \
                                   n_tokens, hw, tpb, s);
  switch (C) {
    HMDT_MLP_BWD_CASE(96)
    HMDT_MLP_BWD_CASE(192)
    HMDT_MLP_BWD_CASE(384)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HMDT_MLP_BWD_CASE
}
