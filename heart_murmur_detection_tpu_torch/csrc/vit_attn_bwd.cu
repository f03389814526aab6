// vit_attn_bwd: backward of the attention half of a ViT training block,
//   h1 = x + proj(concat_h softmax(q_h k_h^T, keys >= n_real masked) v_h),
//   [q | k | v] = LN1(x) W_qkv^T + b_qkv (the q rows carry 1/sqrt(hd)),
// given dh1 (B, Np, C) bf16: dx = dh1 + LN1^T(dh), where per clip and head
//   do = dh1 W_proj,  P = softmax(S),  dP = do_h v_h^T,
//   dS = P (dP - rowsum(dP P)),  dq = dS k,  dk = dS^T q,  dv = P^T do_h,
//   dh = [dq | dk | dv] W_qkv.
//
// Replaces the attention half of the TPU backward of the ViT training block,
// `_attn_bwd_core` (heart_murmur_detection_tpu/ops/pallas_vit_train.py:246)
// as the kernels `_bwd_attn_acc_kernel` (:336) and `_bwd_attn_emit_kernel`
// (:364) of fused_vit_block_train (:703, K9) run it.
//
// Outputs, besides dx: the per-token operands of the two weight products,
// bf16 rows h_g = LN1(x), opre_g = the attention output before proj (B Np, C)
// and dqkv_g = [dq | dk | dv] (B Np, 3C), from which swin_wgrad.cu forms
// dW_qkv = dqkv^T LN1(x) and dW_proj = dh1^T o_pre; and one float32 partial
// row per block of the last launch, [db_qkv (3C) | db_proj (C) | dLN1 w (C) |
// dLN1 b (C)], summed later in block order by swin_reduce. No atomics: every
// element is written by one thread, every sum taken by one thread in order.
//
// Bound on this card: per block of n tokens ~14 n C^2 operations for the
// qkv recompute and the do and dh products plus ~12 Np n C for the six
// attention products, against ~6 n C bytes in and out, so the operations
// bind; at the Audio-MAE CP shape the three weight-shaped products are
// about 85% of them. Design: six grid launches on the caller's stream (one
// call of the wrapper), each on wgmma with TMA-fed operands (the pieces of
// wgmma_gemm.cuh and vit_attn.cu), every kernel named vit_attn_bwd_* so
// that a profile groups them:
//  1. qkv: vit_qkv.cu's LN1 + qkv body as vit_attn_bwd_qkv_kernel (one LN1
//     a token, the W_qkv tiles streamed over all 3C columns), with its h_g
//     output; q, k, v land head-major in scratch, rounded as the forward
//     rounds them.
//  2. do = dh1 W_proj on the GEMM core with A K-major (token rows) and B
//     MN-major (the torch (out, in) weight read as (K, N)), rounded once and
//     scattered head-major to scratch from the accumulator registers.
//  3. query pass, a warpgroup a block of 64 query rows of one clip and head
//     and a producer warp streaming that head's K and V tiles through a TMA
//     ring: pass one forms S = Q K^T and dP = dO V^T with wgmma and keeps,
//     per row, the max, sum of exp(s - max) and sum of exp(s - max) dP
//     (rescaled together when the max moves), so D = rowsum(P dP) comes
//     from the unrounded float32 P and dP in the same pass as the
//     statistics; pass two forms S and dP again, P, o_pre = bf16(P) V and
//     dS = P (dP - D), dq = bf16(dS) K, the last two as wgmma with the
//     rounded P / dS in registers as A. It writes o_pre and dq rows and
//     (max log2 e, 1 / sum, D) of each query row. dq's sum over key tiles
//     stays in the warpgroup's registers: no atomics.
//  4. key pass, a warpgroup a block of 64 key rows, the head's Q and dO
//     tiles streamed: S^T = K Q^T and dP^T = V dO^T with wgmma, P^T and
//     dS^T from the query rows' statistics, dv += bf16(P^T) dO and
//     dk += bf16(dS^T) Q in float32 registers over all query tiles, rounded
//     once. Padded keys (>= n_real) have P exactly 0: their key tiles are
//     skipped in pass 3 and their dk / dv rows written as zeros. Padded
//     query rows take part as in the plain version (their dh1 is 0 on the
//     training path, so they add exact zeros).
//  5. dh = dqkv W_qkv (K = 3C) on the GEMM core (A K-major, B MN-major),
//     float32 rows to scratch.
//  6. a row pass over contiguous runs of 64-token tiles: the LN1 backward
//     (dx = dh1 + LN1^T(dh)), one warp a token, and the column sums of each
//     run in token order, in 8- and 16-byte loads.
// Nothing either attention pass keeps grows with Np, so both stream at every
// sequence length (80 to 1040 tokens); each computes S and dP twice (query
// pass) or once (key pass).
#include "vit_attn_common.cuh"
#include "wgmma_gemm.cuh"

namespace hmdt {

// vit_qkv.cu's launch; recompute = true runs it as vit_attn_bwd_qkv_kernel
int qkv_launch(const void* x, void* qkv, void* h_out, const void* w_qkv, const void* b_qkv,
               const void* ln_w, const void* ln_b, int n_tokens, int Np, int C, int heads,
               float eps, bool recompute, cudaStream_t s);

using namespace hop;

// ---------------------------------------------------------------------------
// 2, 5. token-row products on the GEMM core: A (M, K) K-major, B (K, N)
// MN-major, a 128 x 128 tile a block over all of K (in a profile,
// vit_attn_bwd_mm_kernel<1> is do, <0> dh)
// ---------------------------------------------------------------------------

enum RowsEpilogue : int {
  EPI_F32 = 0,    // out (M, N) float32 rows
  EPI_HEADS = 1,  // out (B, heads, Np, 64) bf16, one rounding (N = heads 64)
};

template <int EPI>
__global__ void __launch_bounds__(THREADS, 2)
vit_attn_bwd_mm_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb, void* __restrict__ out, int M,
                       int N, int K, int Np, int heads) {
  extern __shared__ uint8_t smem_raw[];
  GemmSmem<1>& sm = gemm_smem<1>(smem_raw);
  gemm_init(sm);
  __syncthreads();
  const int n0 = blockIdx.x * GEMM_COLS, m0 = blockIdx.y * GemmCfg<1>::ROWS;
  float acc[1][64];
  gemm_core<false, true, 1>(sm, &ta, &tb, m0, n0, 0, (K + GEMM_BK - 1) / GEMM_BK, acc);
  if (threadIdx.x >= CONSUMERS) return;
  acc_pairs(acc[0], m0 + (threadIdx.x / 128) * 64, n0, [&](int row, int col, float v0, float v1) {
    if (row >= M || col >= N) return;
    if (EPI == EPI_F32) {
      *reinterpret_cast<float2*>(static_cast<float*>(out) + (size_t)row * N + col) =
          make_float2(v0, v1);
    } else {
      const int b = row / Np, t = row % Np;
      const size_t off = (((size_t)b * heads + col / AHD) * Np + t) * AHD + col % AHD;
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + off) =
          __floats2bfloat162_rn(v0, v1);
    }
  });
}

// out = a (M, K) b (K, N), bf16 row-major operands, K and N multiples of 8.
template <int EPI>
static int launch_mm(const void* a, const void* b, void* out, int M, int N, int K, int Np,
                     int heads, cudaStream_t stream) {
  CUtensorMap ma, mb;
  const uint64_t da[2] = {(uint64_t)K, (uint64_t)M}, db[2] = {(uint64_t)N, (uint64_t)K};
  const uint32_t box[2] = {BOX, BOX};
  int err = make_tensor_map(&ma, a, 2, da, box);
  if (!err) err = make_tensor_map(&mb, b, 2, db, box);
  if (err) return err;
  constexpr size_t smem = gemm_smem_bytes<1>();
  cudaError_t e = cudaFuncSetAttribute(vit_attn_bwd_mm_kernel<EPI>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + GEMM_COLS - 1) / GEMM_COLS, (M + GemmCfg<1>::ROWS - 1) / GemmCfg<1>::ROWS);
  vit_attn_bwd_mm_kernel<EPI><<<grid, THREADS, smem, stream>>>(ma, mb, out, M, N, K, Np, heads);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 3, 4. the attention passes: one consumer warpgroup (64 rows) and one
// producer warp a block
// ---------------------------------------------------------------------------

constexpr int BT = 64;                        // rows a block, and rows a streamed tile
constexpr int BWD_CONSUMERS = 128;
constexpr int BWD_THREADS = BWD_CONSUMERS + 32;
constexpr int BSLOT = 8;                      // streamed tiles in flight
constexpr int TILE_BYTES = BT * AHD * 2;      // 8 KB
constexpr float LOG2E = 1.4426950408889634f;  // exp(x) = exp2(x log2 e), as vit_attn.cu

struct BwdSmem {
  uint8_t a[TILE_BYTES];  // the block's own tiles: Q and dO (query pass), K and V (key pass)
  uint8_t b[TILE_BYTES];
  uint8_t ring[BSLOT][TILE_BYTES];
  float stats[2][3][BT];  // key pass: (max log2 e, 1 / sum, D) of a query tile, two buffers
  uint64_t abar;
  uint64_t full[BSLOT];
  uint64_t empty[BSLOT];
};
constexpr size_t BWD_SMEM = sizeof(BwdSmem) + 1024;  // with the alignment slack
static_assert(2 * BWD_SMEM <= SMEM_LIMIT, "two blocks an SM must fit");

__device__ __forceinline__ void bwd_init(BwdSmem& sm) {
  if (threadIdx.x == 0) {
    mbar_init(&sm.abar, 1);
    for (int i = 0; i < BSLOT; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], BWD_CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// The producer's ring: the tiles in the order the consumers take them.
struct Ring {
  BwdSmem& sm;
  int it = 0;
  __device__ __forceinline__ void push(const CUtensorMap* map, int slab, int row0) {
    const int slot = it % BSLOT;
    mbar_wait(&sm.empty[slot], ((it / BSLOT) & 1) ^ 1);
    mbar_expect_tx(&sm.full[slot], TILE_BYTES);
    tma_load_3d(sm.ring[slot], map, &sm.full[slot], 0, row0, slab);
    ++it;
  }
  // the consumers' side: tile k after the next, waited for; release(n)
  // frees the next n tiles
  __device__ __forceinline__ const uint8_t* tile(int k) {
    const int i = it + k, slot = i % BSLOT;
    mbar_wait(&sm.full[slot], (i / BSLOT) & 1);
    return sm.ring[slot];
  }
  __device__ __forceinline__ void release(int n) {
    for (int k = 0; k < n; ++k) mbar_arrive(&sm.empty[(it + k) % BSLOT]);
    it += n;
  }
};

// s = A B^T for a 64-row tile A and a 64-row tile B, both (rows, 64 dims)
// K-major in shared memory (Q K^T, dO V^T and their transposes); issued,
// not waited for.
__device__ __forceinline__ void tile_scores(float (&s)[32], const uint8_t* a, const uint8_t* b) {
  wgmma_m64n64_ss_first<0, 0>(s, desc_sw128(a, 16, ATOM), desc_sw128(b, 16, ATOM));
#pragma unroll
  for (int kk = 1; kk < AHD / 16; ++kk)
    wgmma_m64n64_ss<0, 0>(s, desc_sw128(a + kk * 32, 16, ATOM), desc_sw128(b + kk * 32, 16, ATOM));
}

// A 64 x 64 accumulator p rounded to bf16 as the register A operand of
// tile_pv: keys (or queries) 16 kk .. 16 kk + 15 are its column blocks 2 kk
// and 2 kk + 1. Packed before the products' wg_fence, so the compiler need
// not fence the registers again.
__device__ __forceinline__ void pack_a(const float (&p)[32], uint32_t (&pa)[BT / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) pa[kk][q] = pack_bf16(p[8 * kk + 2 * q], p[8 * kk + 2 * q + 1]);
}

// acc += P V for P packed by pack_a (rows x the tile's 64 rows of V) and V
// (64 rows, 64 dims) MN-major in shared memory; issued, not waited for.
__device__ __forceinline__ void tile_pv(float (&acc)[32], const uint32_t (&pa)[BT / 16][4],
                                        const uint8_t* v) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk)
    wgmma_m64n64_rs<1>(acc, pa[kk], desc_sw128(v + kk * 2048, ATOM, ATOM));
}

// Store a 64 x 64 accumulator's rows r < Np (this thread's rows row0,
// row0 + 8), rounded to bf16, at dst + r * ld + its columns.
__device__ __forceinline__ void store_rows(const float (&acc)[32], bf16* dst, size_t ld,
                                           int row0, int Np, int t) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = row0 + 8 * hr;
    if (r >= Np) continue;
    bf16* d = dst + (size_t)r * ld + 2 * t;
#pragma unroll
    for (int j = 0; j < AHD / 8; ++j)
      *reinterpret_cast<uint32_t*>(d + 8 * j) = pack_bf16(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
  }
}

// grid (ceil(Np / 64), heads, B). tqkv: the head-major q, k, v scratch as
// (3 B heads, Np, 64); tdo: do as (B heads, Np, 64); boxes of 64 rows.
// stats (3, B heads Np): max log2 e, 1 / sum, D of each query row.
__global__ void __launch_bounds__(BWD_THREADS, 2)
vit_attn_bwd_q_kernel(const __grid_constant__ CUtensorMap tqkv,
                      const __grid_constant__ CUtensorMap tdo, bf16* __restrict__ opre_g,
                      bf16* __restrict__ dqkv_g, float* __restrict__ stats, int Np, int n_real) {
  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int heads = gridDim.y, B = gridDim.z, C = heads * AHD;
  extern __shared__ uint8_t smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(align_1024(smem_raw));
  bwd_init(sm);
  Ring ring{sm};
  const int n_kt = (n_real + BT - 1) / BT;  // key tiles holding real keys
  if (threadIdx.x >= BWD_CONSUMERS) {
    if (threadIdx.x == BWD_CONSUMERS) {
      const int bh = b * heads + h;
      mbar_expect_tx(&sm.abar, 2 * TILE_BYTES);
      tma_load_3d(sm.a, &tqkv, &sm.abar, 0, q0, bh);
      tma_load_3d(sm.b, &tdo, &sm.abar, 0, q0, bh);
      for (int pass = 0; pass < 2; ++pass)
        for (int kt = 0; kt < n_kt; ++kt) {
          ring.push(&tqkv, B * heads + bh, kt * BT);      // K
          ring.push(&tqkv, 2 * B * heads + bh, kt * BT);  // V
        }
    }
    return;
  }
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int row0 = q0 + (threadIdx.x / 32) * 16 + (lane >> 2);  // rows row0, row0 + 8
  // this tile's S and dP; the key columns >= n_real get the masked logit
  float s[32], dp[32];
  auto scores = [&](int kt, const uint8_t* ks, const uint8_t* vs) {
    wg_fence();
    tile_scores(s, sm.a, ks);
    tile_scores(dp, sm.b, vs);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    if ((kt + 1) * BT > n_real) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (kt * BT + 8 * (i >> 2) + 2 * t + (i & 1) >= n_real) s[i] = MASK_LOGIT;
    }
  };
  mbar_wait(&sm.abar, 0);

  // pass 1: per row (element i is row hr = (i >> 1) & 1) the max m, and
  // l = sum exp(s - m), d = sum exp(s - m) dP over this thread's columns,
  // rescaled together when m moves
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, d[2] = {0.f, 0.f};
  for (int kt = 0; kt < n_kt; ++kt) {
    scores(kt, ring.tile(0), ring.tile(1));
    ring.release(2);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float tmax = m[hr];
#pragma unroll
      for (int j = 0; j < 8; ++j) tmax = fmaxf(tmax, fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
      const float ml = tmax * LOG2E;
      const float scale = exp2f(fmaf(m[hr], LOG2E, -ml));
      float le = 0.f, de = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hr + e;
          const float p = exp2f(fmaf(s[i], LOG2E, -ml));
          le += p;
          de += p * dp[i];
        }
      l[hr] = l[hr] * scale + le;
      d[hr] = d[hr] * scale + de;
      m[hr] = tmax;
    }
  }
  // merge over the 4 threads of each row, in a fixed order
  float ml[2], inv[2], D[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[hr], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[hr], o);
      const float dd = __shfl_xor_sync(0xffffffffu, d[hr], o);
      const float mn = fmaxf(m[hr], mo);
      const float a = exp2f((m[hr] - mn) * LOG2E), c = exp2f((mo - mn) * LOG2E);
      l[hr] = l[hr] * a + lo * c;
      d[hr] = d[hr] * a + dd * c;
      m[hr] = mn;
    }
    ml[hr] = m[hr] * LOG2E;
    inv[hr] = 1.f / l[hr];
    D[hr] = d[hr] * inv[hr];
  }

  // pass 2: P, o_pre = bf16(P) V, dS = P (dP - D), dq = bf16(dS) K
  float o[32], dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = dq[i] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const uint8_t* ks = ring.tile(0);
    const uint8_t* vs = ring.tile(1);
    scores(kt, ks, vs);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hr = (i >> 1) & 1;
      const float p = exp2f(fmaf(s[i], LOG2E, -ml[hr])) * inv[hr];
      s[i] = p;
      dp[i] = p * (dp[i] - D[hr]);
    }
    uint32_t pa[BT / 16][4], da[BT / 16][4];
    pack_a(s, pa);
    pack_a(dp, da);
    wg_fence();
    fence_regs(o);
    fence_regs(dq);
    tile_pv(o, pa, vs);
    tile_pv(dq, da, ks);
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    fence_regs(dq);
    ring.release(2);
  }
  store_rows(o, opre_g + (size_t)b * Np * C + h * AHD, C, row0, Np, t);
  store_rows(dq, dqkv_g + (size_t)b * Np * 3 * C + h * AHD, 3 * (size_t)C, row0, Np, t);
  if (t == 0) {
    const size_t bhn = (size_t)B * heads * Np, srow = ((size_t)b * heads + h) * Np;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = row0 + 8 * hr;
      if (r >= Np) continue;
      stats[srow + r] = ml[hr];
      stats[bhn + srow + r] = inv[hr];
      stats[2 * bhn + srow + r] = D[hr];
    }
  }
}

// grid (ceil(Np / 64), heads, B): 64 key rows a block, the query tiles
// streamed (maps and stats as the query pass).
__global__ void __launch_bounds__(BWD_THREADS, 2)
vit_attn_bwd_kv_kernel(const __grid_constant__ CUtensorMap tqkv,
                       const __grid_constant__ CUtensorMap tdo, const float* __restrict__ stats,
                       bf16* __restrict__ dqkv_g, int Np, int n_real) {
  const int k0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int heads = gridDim.y, B = gridDim.z, C = heads * AHD;
  const size_t C3 = 3 * (size_t)C;
  if (k0 >= n_real) {
    // keys past n_real: P is exactly 0 in their columns, so dk = dv = 0
    for (int i = threadIdx.x; i < BT * 16; i += BWD_THREADS) {
      const int r = k0 + i / 16;
      const int which = 1 + (i % 16) / 8;
      if (r < Np)
        reinterpret_cast<int4*>(dqkv_g + ((size_t)b * Np + r) * C3 + which * C + h * AHD)[i % 8] =
            make_int4(0, 0, 0, 0);
    }
    return;
  }
  extern __shared__ uint8_t smem_raw[];
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(align_1024(smem_raw));
  bwd_init(sm);
  Ring ring{sm};
  const int n_qt = (Np + BT - 1) / BT;
  const int bh = b * heads + h;
  if (threadIdx.x >= BWD_CONSUMERS) {
    if (threadIdx.x == BWD_CONSUMERS) {
      mbar_expect_tx(&sm.abar, 2 * TILE_BYTES);
      tma_load_3d(sm.a, &tqkv, &sm.abar, 0, k0, B * heads + bh);      // K
      tma_load_3d(sm.b, &tqkv, &sm.abar, 0, k0, 2 * B * heads + bh);  // V
      for (int qt = 0; qt < n_qt; ++qt) {
        ring.push(&tqkv, bh, qt * BT);  // Q
        ring.push(&tdo, bh, qt * BT);   // dO
      }
    }
    return;
  }
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int kr0 = k0 + (threadIdx.x / 32) * 16 + (lane >> 2);  // key rows kr0, kr0 + 8
  const bool live[2] = {kr0 < n_real, kr0 + 8 < n_real};
  const size_t bhn = (size_t)B * heads * Np, srow = (size_t)bh * Np;
  // the statistics of a query tile, element e = 64 array + column of the
  // 3 x 64 block: thread i holds e = i and i + 128 in registers one tile
  // ahead; queries >= Np read as (0, 0, 0), so their P is 0 (their Q rows
  // read as zeros, so s = 0 there and exp2 stays finite)
  auto fetch = [&](int qt, int e) {
    const int q = qt * BT + e % BT;
    return e < 3 * BT && q < Np ? __ldg(stats + (e / BT) * bhn + srow + q) : 0.f;
  };
  float st0 = fetch(0, threadIdx.x), st1 = fetch(0, threadIdx.x + BWD_CONSUMERS);
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(&sm.abar, 0);
  for (int qt = 0; qt < n_qt; ++qt) {
    // this tile's statistics into buffer qt & 1 (every thread finished
    // reading that buffer, two tiles ago, before the last barrier)
    float* sb = &sm.stats[qt & 1][0][0];
    sb[threadIdx.x] = st0;
    if (threadIdx.x + BWD_CONSUMERS < 3 * BT) sb[threadIdx.x + BWD_CONSUMERS] = st1;
    if (qt + 1 < n_qt) {
      st0 = fetch(qt + 1, threadIdx.x);
      st1 = fetch(qt + 1, threadIdx.x + BWD_CONSUMERS);
    }
    named_sync(1, BWD_CONSUMERS);
    const uint8_t* qs = ring.tile(0);
    const uint8_t* ds = ring.tile(1);
    float s[32], dp[32];
    wg_fence();
    tile_scores(s, sm.a, qs);   // S^T: keys x queries
    tile_scores(dp, sm.b, ds);  // dP^T = V dO^T
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // the statistics of this thread's query columns 8 j + 2 t, + 1
      const float2 mlq = *reinterpret_cast<const float2*>(sb + 8 * j + 2 * t);
      const float2 invq = *reinterpret_cast<const float2*>(sb + BT + 8 * j + 2 * t);
      const float2 Dq = *reinterpret_cast<const float2*>(sb + 2 * BT + 8 * j + 2 * t);
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * hr + e;
          const float pe = exp2f(fmaf(s[i], LOG2E, -(e ? mlq.y : mlq.x))) * (e ? invq.y : invq.x);
          const float p = live[hr] ? pe : 0.f;
          s[i] = p;
          dp[i] = p * (dp[i] - (e ? Dq.y : Dq.x));
        }
    }
    uint32_t pa[BT / 16][4], da[BT / 16][4];
    pack_a(s, pa);
    pack_a(dp, da);
    wg_fence();
    fence_regs(dv);
    fence_regs(dk);
    tile_pv(dv, pa, ds);  // dv += P^T dO
    tile_pv(dk, da, qs);  // dk += dS^T Q
    wg_commit();
    wg_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    ring.release(2);
  }
  bf16* rows = dqkv_g + (size_t)b * Np * C3 + h * AHD;
  store_rows(dk, rows + C, C3, kr0, Np, t);
  store_rows(dv, rows + 2 * C, C3, kr0, Np, t);
}

// ---------------------------------------------------------------------------
// 6. the row pass: LN1 backward and the column sums
// ---------------------------------------------------------------------------

constexpr int VT = 64;  // tokens a tile of the row pass

// Four bf16 (8 bytes) or float32 (16 bytes) values at p as float32.
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// grid: blocks of `tpb` consecutive 64-token tiles. A lane takes columns
// 4 (lane + 32 g) .. + 3 of a token (g < C / 128), a thread 8 columns of
// dqkv or 4 of the other sums.
template <int C>
__global__ void __launch_bounds__(NTHREADS)
vit_attn_bwd_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dh1,
                         const bf16* __restrict__ dqkv_g, const float* __restrict__ dh,
                         const float* __restrict__ ln_w, bf16* __restrict__ dx,
                         float* __restrict__ part, int n_tiles, int tpb, float eps) {
  constexpr int G4 = C / 128;
  constexpr int C3 = 3 * C;
  __shared__ float cols[6 * C];  // [db_qkv | db_proj | dLN1 w | dLN1 b]; one owner a column
  __shared__ float mu[VT], rstd[VT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 6 * C; i += NTHREADS) cols[i] = 0.f;
  float4 w[G4];
#pragma unroll
  for (int g = 0; g < G4; ++g) w[g] = load4(ln_w + 4 * (lane + 32 * g));

  const int tile_end = min(n_tiles, (int)(blockIdx.x + 1) * tpb);
  for (int tile = blockIdx.x * tpb; tile < tile_end; ++tile) {
    const size_t tok0 = (size_t)tile * VT;
    // 1. per token (one warp): LN1 statistics, then
    //    dx = dh1 + rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)), dxhat = dh w
    for (int t = warp; t < VT; t += NWARPS) {
      const size_t row = (tok0 + t) * C;
      float4 xv[G4], dxh[G4];
      float s = 0.f;
#pragma unroll
      for (int g = 0; g < G4; ++g) {
        xv[g] = load4(x + row + 4 * (lane + 32 * g));
        dxh[g] = load4(dh + row + 4 * (lane + 32 * g));
        s += (xv[g].x + xv[g].y) + (xv[g].z + xv[g].w);
      }
      const float m = warp_sum(s) / (float)C;
      float q = 0.f;
#pragma unroll
      for (int g = 0; g < G4; ++g) {
        xv[g] = make_float4(xv[g].x - m, xv[g].y - m, xv[g].z - m, xv[g].w - m);
        q += (xv[g].x * xv[g].x + xv[g].y * xv[g].y) + (xv[g].z * xv[g].z + xv[g].w * xv[g].w);
      }
      const float rs = rsqrtf(warp_sum(q) / (float)C + eps);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int g = 0; g < G4; ++g) {
        xv[g] = make_float4(xv[g].x * rs, xv[g].y * rs, xv[g].z * rs, xv[g].w * rs);
        dxh[g] = make_float4(dxh[g].x * w[g].x, dxh[g].y * w[g].y, dxh[g].z * w[g].z,
                             dxh[g].w * w[g].w);
        s1 += (dxh[g].x + dxh[g].y) + (dxh[g].z + dxh[g].w);
        s2 += (dxh[g].x * xv[g].x + dxh[g].y * xv[g].y) + (dxh[g].z * xv[g].z + dxh[g].w * xv[g].w);
      }
      const float m1 = warp_sum(s1) / (float)C;
      const float m2 = warp_sum(s2) / (float)C;
#pragma unroll
      for (int g = 0; g < G4; ++g) {
        const size_t off = row + 4 * (lane + 32 * g);
        const float4 d1 = load4(dh1 + off);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            d1.x + rs * (dxh[g].x - m1 - xv[g].x * m2), d1.y + rs * (dxh[g].y - m1 - xv[g].y * m2));
        const __nv_bfloat162 hi = __floats2bfloat162_rn(
            d1.z + rs * (dxh[g].z - m1 - xv[g].z * m2), d1.w + rs * (dxh[g].w - m1 - xv[g].w * m2));
        uint2 u;
        u.x = *reinterpret_cast<const uint32_t*>(&lo);
        u.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(dx + off) = u;
      }
      if (lane == 0) {
        mu[t] = m;
        rstd[t] = rs;
      }
    }
    __syncthreads();
    // 2. column sums in token order: db_qkv of the bf16 dqkv rows, db_proj
    //    of dh1, dLN1 w = sum dh xhat, dLN1 b = sum dh
    for (int c8 = threadIdx.x; c8 < C3 / 8; c8 += NTHREADS) {
      float a[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 8  // 8 loads in flight; the sums stay in token order
      for (int t = 0; t < VT; ++t) {
        const int4 u = *reinterpret_cast<const int4*>(dqkv_g + (tok0 + t) * C3 + 8 * c8);
        const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = __bfloat1622float2(v[k]);
          a[2 * k] += f.x;
          a[2 * k + 1] += f.y;
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) cols[8 * c8 + k] += a[k];
    }
    for (int c4 = threadIdx.x; c4 < C / 4; c4 += NTHREADS) {
      float sp[4] = {0.f, 0.f, 0.f, 0.f}, sw[4] = {0.f, 0.f, 0.f, 0.f}, sb[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int t = 0; t < VT; ++t) {
        const size_t off = (tok0 + t) * C + 4 * c4;
        const float4 p4 = load4(dh1 + off), x4 = load4(x + off), d4 = load4(dh + off);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w}, xv[4] = {x4.x, x4.y, x4.z, x4.w},
                    dv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          sp[k] += pv[k];
          sw[k] += dv[k] * ((xv[k] - mu[t]) * rstd[t]);
          sb[k] += dv[k];
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cols[C3 + 4 * c4 + k] += sp[k];
        cols[C3 + C + 4 * c4 + k] += sw[k];
        cols[C3 + 2 * C + 4 * c4 + k] += sb[k];
      }
    }
    __syncthreads();
  }
  // this block's column sums -> its partial row
  for (int i = threadIdx.x; i < 6 * C; i += NTHREADS) part[(size_t)blockIdx.x * 6 * C + i] = cols[i];
}

template <int C>
static int launch_attn_bwd(const void* x, const void* dh1, void* dx, const void* w_qkv,
                           const void* b_qkv, const void* w_proj, const void* ln_w,
                           const void* ln_b, void* h_g, void* opre_g, void* dqkv_g, void* part,
                           void* qkv_ws, void* do_ws, void* stats_ws, void* dh_ws, int B, int Np,
                           int heads, int n_real, int tpb, float eps, cudaStream_t stream) {
  const int n = B * Np;
  int err = qkv_launch(x, qkv_ws, h_g, w_qkv, b_qkv, ln_w, ln_b, n, Np, C, heads, eps, true,
                       stream);
  if (!err) err = launch_mm<EPI_HEADS>(dh1, w_proj, do_ws, n, C, C, Np, heads, stream);
  if (!err) {
    CUtensorMap mqkv, mdo;
    const uint64_t d_qkv[3] = {(uint64_t)AHD, (uint64_t)Np, (uint64_t)3 * B * heads};
    const uint64_t d_do[3] = {(uint64_t)AHD, (uint64_t)Np, (uint64_t)B * heads};
    const uint32_t box[3] = {AHD, BT, 1};
    err = make_tensor_map(&mqkv, qkv_ws, 3, d_qkv, box);
    if (!err) err = make_tensor_map(&mdo, do_ws, 3, d_do, box);
    const dim3 grid((Np + BT - 1) / BT, heads, B);
    if (!err) {
      err = (int)cudaFuncSetAttribute(vit_attn_bwd_q_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BWD_SMEM);
      if (!err) {
        vit_attn_bwd_q_kernel<<<grid, BWD_THREADS, BWD_SMEM, stream>>>(
            mqkv, mdo, static_cast<bf16*>(opre_g), static_cast<bf16*>(dqkv_g),
            static_cast<float*>(stats_ws), Np, n_real);
        err = (int)cudaGetLastError();
      }
    }
    if (!err) {
      err = (int)cudaFuncSetAttribute(vit_attn_bwd_kv_kernel,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BWD_SMEM);
      if (!err) {
        vit_attn_bwd_kv_kernel<<<grid, BWD_THREADS, BWD_SMEM, stream>>>(
            mqkv, mdo, static_cast<const float*>(stats_ws), static_cast<bf16*>(dqkv_g), Np,
            n_real);
        err = (int)cudaGetLastError();
      }
    }
  }
  if (!err) err = launch_mm<EPI_F32>(dqkv_g, w_qkv, dh_ws, n, C, 3 * C, Np, heads, stream);
  if (!err) {
    const int n_tiles = n / VT;
    vit_attn_bwd_rows_kernel<C><<<(n_tiles + tpb - 1) / tpb, NTHREADS, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dh1),
        static_cast<const bf16*>(dqkv_g), static_cast<const float*>(dh_ws),
        static_cast<const float*>(ln_w), static_cast<bf16*>(dx), static_cast<float*>(part),
        n_tiles, tpb, eps);
    err = (int)cudaGetLastError();
  }
  return err;
}

}  // namespace hmdt

// C interfaces for ctypes. Each returns the first launch error (0 on
// success).
//
// vit_attn_bwd_launch: x, dh1, dx (B, Np, C) bf16 with B Np a multiple of
// 64; w_qkv (3C, C) and w_proj (C, C) bf16 (torch layout, q rows scaled);
// b_qkv, ln_w, ln_b f32; h_g, opre_g (B Np, C) and dqkv_g (B Np, 3C) bf16;
// part (ceil(B Np / 64 / tpb), 6C) f32; scratch qkv_ws (3, B, heads, Np, 64)
// and do_ws (B, heads, Np, 64) bf16, stats_ws (3, B heads Np) and dh_ws
// (B Np, C) f32. Keys >= n_real are masked.
extern "C" int vit_attn_bwd_launch(const void* x, const void* dh1, void* dx, const void* w_qkv,
                                   const void* b_qkv, const void* w_proj, const void* ln_w,
                                   const void* ln_b, void* h_g, void* opre_g, void* dqkv_g,
                                   void* part, void* qkv_ws, void* do_ws, void* stats_ws,
                                   void* dh_ws, int B, int Np, int C, int heads, int n_real,
                                   int tpb, float eps, void* stream) {
  using namespace hmdt;
  if (B <= 0 || B > 65535 || Np <= 0 || (B * Np) % VT || n_real <= 0 || n_real > Np ||
      heads * AHD != C || tpb <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HMDT_VIT_ATTN_BWD_CASE(CC)                                                            \
  case CC:                                                                                    \
    return launch_attn_bwd<CC>(x, dh1, dx, w_qkv, b_qkv, w_proj, ln_w, ln_b, h_g, opre_g,    \
                               dqkv_g, part, qkv_ws, do_ws, stats_ws, dh_ws, B, Np, heads,   \
                               n_real, tpb, eps, s);
  switch (C) {
    HMDT_VIT_ATTN_BWD_CASE(384)
    HMDT_VIT_ATTN_BWD_CASE(768)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef HMDT_VIT_ATTN_BWD_CASE
}

// vit_mm_launch: out (M, N) f32 = a (M, K) b (K, N), a and b bf16 row-major,
// K and N multiples of 8: the token-row product of launches 2 and 5 (A
// K-major, B MN-major on the GEMM core) alone, for the tests only (edge
// tiles on every side); no path calls it.
extern "C" int vit_mm_launch(const void* a, const void* b, void* out, int M, int N, int K,
                             void* stream) {
  using namespace hmdt;
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8 || (M + 127) / 128 > 65535)
    return (int)cudaErrorInvalidValue;
  return launch_mm<EPI_F32>(a, b, out, M, N, K, 1, 1, static_cast<cudaStream_t>(stream));
}
