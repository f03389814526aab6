// vit_rows: HeAR's ViT-L (C = 1024) qkv and MLP halves as a LayerNorm row
// pass and token-row GEMMs on the wgmma core of wgmma_gemm.cuh:
//
//   vit_qkv at C = 1024:  h = LN1(x)                      (row pass, bf16 rows)
//                         qkv = h W_qkv^T + b_qkv          (GEMM, head-major out)
//   vit_mlp at C = 1024:  h = LN2(x)                      (row pass)
//                         g = GELU(h W1^T + b1)            (GEMM, bf16 rows)
//                         y = x + (g W2^T + b2)            (GEMM, residual)
//
// x (n_tokens, C) bf16; weights in the torch (out, in) layout, bf16; biases
// and LN parameters float32; qkv (3, B, heads, Np, 64) with 1/sqrt(64)
// folded into the q rows at weight load. Each product accumulates in
// float32 and is rounded
// once after its epilogue, where the plain versions (ops/vit.py vit_qkv_ref,
// vit_mlp_ref) round: LN to bf16, + b1 and the exact erf GELU to bf16,
// + b2, + x to bf16.
//
// Replaces, at C = 1024, the LN1 and qkv part of the ViT attention body
// `_attn_half` (heart_murmur_detection_tpu/ops/pallas_vit.py:66) of
// fused_vit_attn (:341, K6) and the MLP body `_mlp_half` (:149) of
// fused_vit_mlp (:373, K7). C 384 and 768 keep vit_qkv.cu and swin_mlp.cu,
// which hold a block's LN'd panel on chip; at C = 1024 that 128 KB panel
// left vit_qkv a two-stage ring (1.67x torch.addmm) and swin_mlp four
// blocks a panel that each recomputed fc1 (40 C^2 operations a token
// instead of 16 C^2, 2.6x the library chain).
//
// Bound on this card: the operations (6 C^2 a token for qkv, 16 C^2 for the
// MLP; about 11 and 30 GFLOP at B = 16 clips of 112 tokens) over 989
// TFLOP/s. Design:
//  - the row pass: one warp a row, 16-byte loads, float32 statistics, one
//    rounding; h is 3.7 MB at B = 16 and stays in the 50 MB L2 for the
//    GEMM that reads it, as does the MLP's GELU rows g (14.7 MB). fc1 thus
//    runs once a token;
//  - the GEMM: persistent blocks, one an SM, over 128 x 128 output tiles,
//    each over all of K (ops/vit_plan.py). The producer warp streams the A
//    and B boxes of the block's tiles by TMA through one ring of four 32 KB
//    stages. Where a block has two tiles or more, the two consumer
//    warpgroups take them in turns ("ping-pong", two m64n128 wgmma
//    accumulators each), handing the tensor cores over by a pair of named
//    barriers, so one warpgroup's epilogue runs while the other's products
//    do: on an H100 the qkv products without an epilogue took 19 us of 28
//    at B = 16 with both warpgroups on every tile. Where a block has one
//    tile (fc2 at B = 16, every product at B = 1) both warpgroups share it,
//    64 rows each. Larger tiles (64 x 256 a warpgroup, 128 x 256 a block)
//    and a 2 x 2 cluster multicasting A and B were slower there, and so
//    was the MLP in one launch with fc1's GELU chunks passed between the
//    four blocks of a panel's cluster (bench/vit_mlp_cluster.cu);
//  - the epilogue: + bias, GELU or the residual, one rounding, into the
//    warpgroup's staged bf16 tile, then 16-byte stores, each thread
//    keeping its 8 columns (head-major for qkv: a head's 64 columns of a
//    token are 128 contiguous bytes).
// No split-K: each output is one block's sum in a fixed order, so two
// launches agree bitwise.
#include "swin_common.cuh"
#include "vit_attn_common.cuh"
#include "wgmma_gemm.cuh"

namespace hmdt {

using namespace hop;

constexpr int ROWS_WIDTH = 1024;  // the width this file serves (HeAR's ViT-L)
constexpr int ROWS_HD = 64;       // head dim
constexpr int LN_WARPS = 8;       // rows (warps) a row-pass block

enum Epilogue { EPI_GELU = 0, EPI_RESID = 1, EPI_QKV = 2 };

// LayerNorm of rows of C = 256 V bf16 values: lane l holds the 16-byte
// chunks l, l + 32, ... of its warp's row.
template <int C>
__global__ void __launch_bounds__(LN_WARPS * 32)
vit_ln_rows_kernel(const bf16* __restrict__ x, bf16* __restrict__ out,
                   const float* __restrict__ ln_w, const float* __restrict__ ln_b, int rows,
                   float eps) {
  constexpr int V = C / 256;
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= rows) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * C);
  float v[V][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const uint4 u = __ldg(xr + 32 * i + lane);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      v[i][2 * j] = f.x;
      v[i][2 * j + 1] = f.y;
      s += f.x + f.y;
    }
  }
  const float mu = warp_sum(s) / (float)C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < V; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = v[i][e] - mu;
      q += __fmul_rn(d, d);
    }
  const float rstd = rsqrtf(warp_sum(q) / (float)C + eps);
  uint4* orow = reinterpret_cast<uint4*>(out + (size_t)row * C);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c0 = 256 * i + 8 * lane;
    const float4 w0 = *reinterpret_cast<const float4*>(ln_w + c0);
    const float4 w1 = *reinterpret_cast<const float4*>(ln_w + c0 + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(ln_b + c0);
    const float4 b1 = *reinterpret_cast<const float4*>(ln_b + c0 + 4);
    const float ww[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint32_t o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = pack_bf16(ln_affine(v[i][2 * j], mu, rstd, ww[2 * j], bb[2 * j]),
                       ln_affine(v[i][2 * j + 1], mu, rstd, ww[2 * j + 1], bb[2 * j + 1]));
    orow[32 * i + lane] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// What an epilogue reads besides the tile: the float32 bias of the output
// columns; EPI_RESID: the residual x (M, N); EPI_QKV: the head-major
// geometry.
struct EpiArgs {
  const float* bias;
  bf16* out;
  const bf16* x;
  int Np;
  int heads;
};

// The arriving half of a named barrier (see named_sync): the thread does
// not wait.
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

constexpr int RG_ROWS = 128;                   // token rows of a tile
constexpr int RG_STAGES = 4;                   // ring stages
constexpr int RG_STAGE_BYTES = 4 * BOX_BYTES;  // A's two 64 x 64 boxes, then B's two
constexpr int OUT_LD = GEMM_COLS + 8;          // bf16 row of a staged tile (padded)

struct RowsGemmSmem {
  uint8_t ring[RG_STAGES][RG_STAGE_BYTES];
  bf16 out[2][RG_ROWS * OUT_LD];  // each warpgroup's rounded tile, for the 16-byte stores
  uint64_t full[RG_STAGES];
  uint64_t empty[RG_STAGES];
};

constexpr size_t rows_gemm_smem_bytes() { return sizeof(RowsGemmSmem) + 1024; }

// out = epilogue(A B^T + bias) for A (M, K) and B (N, K), both K-major bf16
// (tokens and the torch weight layout), in 128 x 128 output tiles over all
// of K; persistent: the block's q-th tile is blockIdx.x + q gridDim.x (tile
// t at column tile t % (N / 128), row tile t / (N / 128)), and the
// producer warp streams the A and B boxes of the block's tiles in q order
// through one ring. Two schedules of the consumer warpgroups (the plan
// picks, ops/vit_plan.py):
//  - ping-pong (COOP false; blocks with two or more tiles): warpgroup q % 2
//    owns tile q, all 128 rows (two m64n128 accumulators), so the ring
//    hands the tensor cores to one warpgroup's products while the other
//    runs its epilogue (bias, GELU or the residual, rounding, staging,
//    stores);
//  - cooperative (COOP true; a tile a block, where ping-pong would leave
//    one warpgroup idle): both warpgroups on every tile, 64 rows each.
template <int EPI, bool COOP>
__global__ void __launch_bounds__(THREADS, 1)
vit_rows_gemm_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                     int M, int N, int K, EpiArgs ea) {
  constexpr int S = RG_STAGES, MI = COOP ? 1 : 2;  // m64n128 accumulators a warpgroup
  constexpr int WG_ROWS = 64 * MI;                   // a warpgroup's rows of a tile
  extern __shared__ uint8_t smem_raw[];
  RowsGemmSmem& sm = *reinterpret_cast<RowsGemmSmem*>(align_1024(smem_raw));
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], COOP ? CONSUMERS : CONSUMERS / 2);  // the stage's readers
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int gx = N / GEMM_COLS, tiles = gx * ((M + RG_ROWS - 1) / RG_ROWS);
  const int k_steps = K / GEMM_BK;

  if (tid >= CONSUMERS) {
    if (tid == PRODUCER) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int n0 = (t % gx) * GEMM_COLS, m0 = (t / gx) * RG_ROWS;
        for (int ks = 0; ks < k_steps; ++ks, ++it) {
          const int st = it % S;
          mbar_wait(&sm.empty[st], ((it / S) & 1) ^ 1);
          mbar_expect_tx(&sm.full[st], RG_STAGE_BYTES);
          uint8_t* s = sm.ring[st];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            tma_load_2d(s + j * BOX_BYTES, &ta, &sm.full[st], ks * GEMM_BK, m0 + BOX * j);
            tma_load_2d(s + (2 + j) * BOX_BYTES, &tb, &sm.full[st], ks * GEMM_BK, n0 + BOX * j);
          }
        }
      }
    }
    return;
  }

  const int wg = tid / 128, wtid = tid % 128;
  const int row0 = COOP ? 64 * wg : 0;  // this warpgroup's first row of a tile
  bf16* stage_out = sm.out[wg];
  const int B = EPI == EPI_QKV ? M / ea.Np : 0;
  const int C = EPI == EPI_QKV ? N / 3 : 0;
  for (int q = COOP ? 0 : wg;; q += COOP ? 1 : 2) {
    const int t = blockIdx.x + q * gridDim.x;
    if (t >= tiles) break;
    const int n0 = (t % gx) * GEMM_COLS, m0 = (t / gx) * RG_ROWS;
    float acc[MI][64];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[i][e] = 0.f;
    // ping-pong's turn: the other warpgroup's products of tile q - 1 are
    // issued, so every stage of the ring is at most one phase ahead of
    // this warpgroup's waits (a parity wait cannot tell two phases apart)
    if (!COOP && q > 0) named_sync(4 + wg, CONSUMERS);
    int it = q * k_steps;
    for (int ks = 0; ks < k_steps; ++ks, ++it) {
      const int st = it % S;
      mbar_wait(&sm.full[st], (it / S) & 1);
      const uint8_t* sa = sm.ring[st] + (COOP ? wg * BOX_BYTES : 0);
      const uint8_t* sb = sm.ring[st] + 2 * BOX_BYTES;
      wg_fence();
#pragma unroll
      for (int i = 0; i < MI; ++i) fence_regs(acc[i]);
#pragma unroll
      for (int kk = 0; kk < GEMM_BK / 16; ++kk) {
        const uint64_t db = desc_sw128(sb + kk * 32, 16, ATOM);
#pragma unroll
        for (int i = 0; i < MI; ++i)
          wgmma_m64n128_ss<0, 0>(acc[i], desc_sw128(sa + i * BOX_BYTES + kk * 32, 16, ATOM), db);
      }
      wg_commit();
      // keep this stage's products in flight; the previous stage's are done
      wg_wait<1>();
#pragma unroll
      for (int i = 0; i < MI; ++i) fence_regs(acc[i]);
      if (ks > 0) mbar_arrive(&sm.empty[(it - 1) % S]);
    }
    // ping-pong: hand the tensor cores to the other warpgroup's next tile
    if (!COOP && blockIdx.x + (q + 1) * gridDim.x < tiles) named_arrive(5 - wg, CONSUMERS);
    wg_wait<0>();
#pragma unroll
    for (int i = 0; i < MI; ++i) fence_regs(acc[i]);
    mbar_arrive(&sm.empty[(it - 1) % S]);

    // + bias, GELU or the residual, one rounding, into this warpgroup's
    // staged rows (its last tile's stores have read them: the barrier)
    named_sync(2 + wg, 128);
#pragma unroll
    for (int i = 0; i < MI; ++i)
      acc_pairs(acc[i], 64 * i, 0, [&](int r, int c, float v0, float v1) {
        const float2 bv = __ldg(reinterpret_cast<const float2*>(ea.bias + n0 + c));
        v0 += bv.x;
        v1 += bv.y;
        if constexpr (EPI == EPI_GELU) {
          v0 = gelu_exact(v0);
          v1 = gelu_exact(v1);
        } else if constexpr (EPI == EPI_RESID) {
          const int row = m0 + row0 + r;
          if (row < M) {
            const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                ea.x + (size_t)row * N + n0 + c));
            v0 = __fadd_rn(xf.x, v0);
            v1 = __fadd_rn(xf.y, v1);
          }
        }
        *reinterpret_cast<uint32_t*>(&stage_out[r * OUT_LD + c]) = pack_bf16(v0, v1);
      });
    named_sync(2 + wg, 128);
    // 16-byte stores: a thread keeps its 8 columns of the tile and takes
    // every 8th row (for qkv a head's 64 columns of a token are 128
    // contiguous bytes): column col is third col / C, head (col % C) / 64,
    // dim col % 64
    const int cc = 8 * (wtid % (GEMM_COLS / 8)), col = n0 + cc;
    size_t col_off = col;
    if constexpr (EPI == EPI_QKV)
      col_off = ((size_t)(col / C) * B * ea.heads + (col % C) / ROWS_HD) * ea.Np * ROWS_HD +
                col % ROWS_HD;
    for (int r = wtid / (GEMM_COLS / 8); r < WG_ROWS; r += 128 / (GEMM_COLS / 8)) {
      const int row = m0 + row0 + r;
      if (row >= M) break;
      size_t row_off;
      if constexpr (EPI == EPI_QKV) {
        const int bb = row / ea.Np;
        row_off = ((size_t)bb * ea.heads * ea.Np + (row - bb * ea.Np)) * ROWS_HD;
      } else {
        row_off = (size_t)row * N;
      }
      *reinterpret_cast<uint4*>(ea.out + row_off + col_off) =
          *reinterpret_cast<const uint4*>(&stage_out[r * OUT_LD + cc]);
    }
  }
}

static int ln_rows(const void* x, void* out, const void* ln_w, const void* ln_b, int rows,
                   float eps, cudaStream_t s) {
  vit_ln_rows_kernel<ROWS_WIDTH><<<(rows + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), rows, eps);
  return (int)cudaGetLastError();
}

// grid: the plan's persistent blocks (ops/vit_plan.py: at most one an SM)
template <int EPI, bool COOP>
static int gemm_s(const void* a, const void* w, int M, int N, int K, int grid, const EpiArgs& ea,
                  cudaStream_t s) {
  const long tiles = (long)(N / GEMM_COLS) * ((M + RG_ROWS - 1) / RG_ROWS);
  if (M <= 0 || N % GEMM_COLS || K % GEMM_BK || K <= 0 || grid <= 0 || grid > tiles)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const uint64_t da[2] = {(uint64_t)K, (uint64_t)M}, db[2] = {(uint64_t)K, (uint64_t)N};
  const uint32_t box[2] = {BOX, BOX};
  int err = make_tensor_map(&ma, a, 2, da, box);
  if (!err) err = make_tensor_map(&mb, w, 2, db, box);
  if (err) return err;
  constexpr size_t smem = rows_gemm_smem_bytes();
  static_assert(smem <= SMEM_LIMIT, "shared memory over the sm_90 limit");
  auto kernel = vit_rows_gemm_kernel<EPI, COOP>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, smem, s>>>(ma, mb, M, N, K, ea);
  return (int)cudaGetLastError();
}

// plan: the persistent blocks (at most one an SM); cooperative where every
// block has one tile at most (ops/vit_plan.py)
template <int EPI>
static int gemm(const void* a, const void* w, int M, int N, int K, int grid, const EpiArgs& ea,
                cudaStream_t s) {
  const long tiles = (long)(N / GEMM_COLS) * ((M + RG_ROWS - 1) / RG_ROWS);
  return tiles <= grid ? gemm_s<EPI, true>(a, w, M, N, K, grid, ea, s)
                       : gemm_s<EPI, false>(a, w, M, N, K, grid, ea, s);
}

}  // namespace hmdt

// C interface for ctypes. Each returns cudaGetLastError() after its last
// launch (0 on success), or the error that stopped it before. The launch
// plan (ops/vit_plan.py) gives each GEMM's grid (its persistent blocks).
//
// vit_qkv_rows_launch: x (n_tokens, C) bf16, n_tokens = B Np, Np a multiple
// of 16; h (n_tokens, C) bf16, LN1(x) (the caller's buffer, also its
// return_ln output); qkv (3, B, heads, Np, 64) bf16; w (3C, C) bf16; b,
// ln_w, ln_b float32; C 1024. Two launches: the row pass, the GEMM.
extern "C" int vit_qkv_rows_launch(const void* x, void* qkv, void* h, const void* w_qkv,
                                   const void* b_qkv, const void* ln_w, const void* ln_b,
                                   int n_tokens, int Np, int C, int heads, int grid, float eps,
                                   void* stream) {
  using namespace hmdt;
  if (C != ROWS_WIDTH || n_tokens <= 0 || Np <= 0 || Np % 16 || n_tokens % Np ||
      heads * ROWS_HD != C || h == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = ln_rows(x, h, ln_w, ln_b, n_tokens, eps, s);
  if (err) return err;
  const EpiArgs ea = {static_cast<const float*>(b_qkv), static_cast<bf16*>(qkv), nullptr, Np,
                      heads};
  return gemm<EPI_QKV>(h, w_qkv, n_tokens, 3 * C, C, grid, ea, s);
}

// vit_mlp_rows_launch: x and out distinct (n_tokens, C) bf16; h (n_tokens,
// C) and g (n_tokens, hidden) bf16 workspaces; w1 (hidden, C), w2 (C,
// hidden) bf16; b1, b2, ln_w, ln_b float32; C 1024, hidden a multiple of
// 128. Three launches: the row pass, fc1 (+ b1, GELU), fc2 (+ b2, + x).
extern "C" int vit_mlp_rows_launch(const void* x, void* out, void* h, void* g, const void* ln_w,
                                   const void* ln_b, const void* w_fc1, const void* b_fc1,
                                   const void* w_fc2, const void* b_fc2, int n_tokens, int C,
                                   int hidden, int grid1, int grid2, float eps, void* stream) {
  using namespace hmdt;
  if (C != ROWS_WIDTH || n_tokens <= 0 || hidden <= 0 || hidden % GEMM_COLS || h == nullptr ||
      g == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = ln_rows(x, h, ln_w, ln_b, n_tokens, eps, s);
  if (err) return err;
  const EpiArgs e1 = {static_cast<const float*>(b_fc1), static_cast<bf16*>(g), nullptr, 1, 1};
  err = gemm<EPI_GELU>(h, w_fc1, n_tokens, hidden, C, grid1, e1, s);
  if (err) return err;
  const EpiArgs e2 = {static_cast<const float*>(b_fc2), static_cast<bf16*>(out),
                      static_cast<const bf16*>(x), 1, 1};
  return gemm<EPI_RESID>(g, w_fc2, n_tokens, C, hidden, grid2, e2, s);
}
