// vit_qkv: LayerNorm 1 and the qkv product of a ViT block's attention half,
//   [q | k | v] = LN1(x) W_qkv^T + b_qkv,  x (n_tokens, C) bf16 (n_tokens = B Np),
//   LN eps an argument (1e-6 for the MAE encoders); the q rows of W_qkv and
//   the q part of b_qkv carry 1/sqrt(hd), folded in at weight load.
//   Written head-major: qkv (3, B, heads, Np, 64) bf16; optionally also
//   LN1(x) itself as bf16 rows (n_tokens, C) (h_g of vit_attn_bwd.cu, which
//   runs this kernel, as vit_attn_bwd_qkv_kernel, to recompute the forward).
//
// Replaces the LN1 and qkv part of the ViT attention body `_attn_half`
// (heart_murmur_detection_tpu/ops/pallas_vit.py:66) that the TPU kernels
// fused_vit_block (:296, K5) and fused_vit_attn (:341, K6) run, and the same
// recompute in the training backward `_attn_bwd_core`
// (heart_murmur_detection_tpu/ops/pallas_vit_train.py:256-262, K9). The TPU
// kept q, k and v of a whole sequence in VMEM; on Hopper they go once
// through device memory in the layout vit_attn.cu streams (each head's rows
// of one clip contiguous).
//
// Bound on this card: 6 C^2 operations a token against 8 C bytes (x in, q,
// k, v out): on the line between the two at C = 384 (about 0.06 ms for an
// operaGT batch of 64 clips), the operations at C = 768. W_qkv (0.9 / 3.5
// MB) stays in L2 and is read once a panel; at C = 768 those L2 reads
// (about 566 MB at the Audio-MAE CP shape) are what holds the kernel back.
// Design (wgmma_gemm.cuh's pieces):
//  - a block owns a panel of PR token rows (128 at C = 384, 64 at C = 768,
//    so the panel is 96 KB either way) times all of K = C. The producer warp
//    loads the panel's x rows by TMA in the 128-byte-swizzle layout of a
//    K-major A operand; the two consumer warpgroups compute LN1 of the panel
//    once (one warp a token, float32 statistics from shared memory, rounded
//    to bf16) and write it back in place, so the panel is the A operand of
//    every product of the block;
//  - the producer warp streams W_qkv in K-major tiles of 64 K x SN output
//    columns (SN = 128 at C = 384, 256 at C = 768) through a TMA ring of full /
//    empty mbarriers over all 3C output columns, from the first instruction,
//    while the consumers are still in LN1;
//  - each consumer warpgroup runs m64n128k16 wgmma over its 64 rows x 128
//    columns of each tile (at PR = 128 the warpgroups split the rows, at
//    PR = 64 the columns) into one of two accumulators in turn; while the
//    first stage of the next 128 columns runs on the tensor cores, it adds
//    the float32 bias to the other, rounds once to bf16 into shared memory
//    as the swizzled boxes of 16 rows x one head, which TMA stores
//    head-major in the background (4-byte stores straight from the
//    registers, 16 bytes a row a warp instruction, stalled the warpgroups
//    for most of each column step on an H100);
//  - rows past n_tokens read as zeros and are never stored; a panel may
//    span clips (each row maps to its own (b, t));
//  - where the panels do not fill the card, the 3C columns split into
//    their q, k and v thirds over three blocks, each recomputing LN1.
// No split-K: each output is one block's sum, so two launches agree bitwise.
#include "swin_common.cuh"
#include "wgmma_gemm.cuh"

namespace hmdt {

using namespace hop;

constexpr int VIT_HD = 64;  // head dim of the ViT kernels

template <int C>
struct QkvCfg {
  static constexpr int PR = C == 384 ? 128 : 64;       // token rows a panel
  static constexpr int SN = PR == 128 ? 128 : 256;     // output columns a stage
  static constexpr int N_STEPS = 3 * C / SN;           // 9 at both widths
  static constexpr int K_STEPS = C / BOX;
  static constexpr int STAGE_BYTES = SN * 128;         // SN rows of 64 K
  static constexpr int STAGES = C == 384 ? 6 : 3;
  static constexpr int PANEL_BYTES = PR * C * 2;
  // a stage's columns stay inside one of the q, k, v thirds
  static_assert(C % SN == 0 && N_STEPS == 9, "three thirds of 3 stages each");
};

constexpr int OUT_ROWS = 16;  // token rows a TMA store box (Np is a multiple of 16)

template <int C>
struct QkvSmem {
  uint8_t panel[QkvCfg<C>::PANEL_BYTES];  // x, then LN1(x) in place
  uint8_t ring[QkvCfg<C>::STAGES][QkvCfg<C>::STAGE_BYTES];
  // each warpgroup's 64 x 128 output tile, rounded, as the swizzled boxes
  // of its two heads' 64 rows, for the TMA stores
  uint8_t out[2][2][64 * 128];
  uint64_t xbar;
  uint64_t full[QkvCfg<C>::STAGES];
  uint64_t empty[QkvCfg<C>::STAGES];
};

template <int C>
constexpr size_t qkv_smem_bytes() {
  return sizeof(QkvSmem<C>) + 1024;
}

// grid (ceil(n_tokens / PR), splits): blockIdx.y takes output column steps
// [y 9 / splits, (y + 1) 9 / splits). tx: x (n_tokens, C) in boxes of 64 x
// PR; tw: W_qkv (3C, C) in boxes of 64 x 128; tq: qkv as (3 B heads, Np,
// 64) in boxes of 16 rows.
template <int C>
__device__ __forceinline__ void qkv_panel(const CUtensorMap* tx, const CUtensorMap* tw,
                                          const CUtensorMap* tq, bf16* __restrict__ h_out,
                                          const float* __restrict__ bias,
                                          const float* __restrict__ ln_w,
                                          const float* __restrict__ ln_b, int n_tokens, int Np,
                                          int heads, float eps) {
  using Cfg = QkvCfg<C>;
  constexpr int PR = Cfg::PR, SN = Cfg::SN, S = Cfg::STAGES;
  extern __shared__ uint8_t smem_raw[];
  QkvSmem<C>& sm = *reinterpret_cast<QkvSmem<C>*>(align_1024(smem_raw));
  if (threadIdx.x == 0) {
    mbar_init(&sm.xbar, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(&sm.full[i], 1);
      mbar_init(&sm.empty[i], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int p0 = blockIdx.x * PR;
  const int splits = gridDim.y;
  const int ns_beg = blockIdx.y * Cfg::N_STEPS / splits;
  const int ns_end = (blockIdx.y + 1) * Cfg::N_STEPS / splits;

  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == PRODUCER) {
      // the panel's x rows (rows past n_tokens read as zeros), then W
      mbar_expect_tx(&sm.xbar, Cfg::PANEL_BYTES);
      for (int kb = 0; kb < Cfg::K_STEPS; ++kb)
        tma_load_2d(sm.panel + (size_t)kb * PR * 128, tx, &sm.xbar, kb * BOX, p0);
      int it = 0;
      for (int ns = ns_beg; ns < ns_end; ++ns)
        for (int kb = 0; kb < Cfg::K_STEPS; ++kb, ++it) {
          const int st = it % S;
          mbar_wait(&sm.empty[st], ((it / S) & 1) ^ 1);
          mbar_expect_tx(&sm.full[st], Cfg::STAGE_BYTES);
#pragma unroll
          for (int j = 0; j < SN / 128; ++j)
            tma_load_2d(sm.ring[st] + j * 128 * 128, tw, &sm.full[st], kb * BOX,
                        ns * SN + 128 * j);
        }
    }
    return;
  }

  // LN1 of the panel, in place: the TMA boxes hold x in the swizzled
  // K-major layout of the A operand, element (r, c) in the box of columns
  // 64 (c / 64) at row r, 16-byte chunk (c % 64) / 8 ^ (r % 8); lane l
  // takes columns 64 i + 2 l, + 1 of a row and writes LN1 back over them
  // (and to h_out); a warp takes two rows at a time
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int PER = C / 64;
  const bool write_h = h_out != nullptr && blockIdx.y == 0;
  float2 w[PER], b[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    w[i] = *reinterpret_cast<const float2*>(ln_w + 64 * i + 2 * lane);
    b[i] = *reinterpret_cast<const float2*>(ln_b + 64 * i + 2 * lane);
  }
  mbar_wait(&sm.xbar, 0);
  for (int r0 = 2 * warp; r0 < PR; r0 += 2 * CONSUMERS / 32) {
    uint8_t* row[2];
    float2 v[2][PER];
    float s[2] = {0.f, 0.f}, q[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + u;
      row[u] = sm.panel + r * 128 + (((lane >> 2) ^ (r & 7)) * 16 + (lane & 3) * 4);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        v[u][i] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(row[u] + (size_t)i * PR * 128));
        s[u] += v[u][i].x + v[u][i].y;
      }
    }
    float mu[2], rstd[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) mu[u] = warp_sum(s[u]) / (float)C;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const float d0 = v[u][i].x - mu[u], d1 = v[u][i].y - mu[u];
        q[u] += d0 * d0 + d1 * d1;
      }
#pragma unroll
    for (int u = 0; u < 2; ++u) rstd[u] = rsqrtf(warp_sum(q[u]) / (float)C + eps);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int tok = p0 + r0 + u;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const __nv_bfloat162 hv =
            __floats2bfloat162_rn((v[u][i].x - mu[u]) * rstd[u] * w[i].x + b[i].x,
                                  (v[u][i].y - mu[u]) * rstd[u] * w[i].y + b[i].y);
        *reinterpret_cast<__nv_bfloat162*>(row[u] + (size_t)i * PR * 128) = hv;
        if (write_h && tok < n_tokens)
          *reinterpret_cast<__nv_bfloat162*>(h_out + (size_t)tok * C + 64 * i + 2 * lane) = hv;
      }
    }
  }
  fence_async_smem();
  named_sync(1, CONSUMERS);

  // this warpgroup's rows / columns of each stage
  const int wg = threadIdx.x / 128;
  const int row_off = PR == 128 ? 64 * wg : 0;
  const int col_off = PR == 128 ? 0 : 128 * wg;
  const bool leader = (threadIdx.x & 127) == 0;  // issues the warpgroup's stores
  const int B = n_tokens / Np;
  uint8_t* out = sm.out[wg][0];

  // + bias, one rounding, head-major: output column c is third c / C,
  // head (c % C) / 64, dim c % 64. The tile goes through shared memory as
  // the boxes of its two heads x four 16-row groups (a group lies inside
  // one clip, Np being a multiple of 16), stored by TMA in the background;
  // groups past n_tokens are not stored.
  auto epilogue = [&](const float (&acc)[64], int ns) {
    const int c0 = ns * SN + col_off;
    const int which = c0 / C;
    if (leader) bulk_wait_read<0>();  // the last tile's stores are done reading
    named_sync(2 + wg, 128);
    acc_pairs(acc, 0, 0, [&](int rr, int col, float v0, float v1) {
      const float2 bv = *reinterpret_cast<const float2*>(bias + c0 + col);
      const int d = col % VIT_HD;
      *reinterpret_cast<__nv_bfloat162*>(out + (col / VIT_HD) * (64 * 128) + rr * 128 +
                                         (((d >> 3) ^ (rr & 7)) << 4) + (d & 7) * 2) =
          __floats2bfloat162_rn(v0 + bv.x, v1 + bv.y);
    });
    fence_async_smem();
    named_sync(2 + wg, 128);
    if (leader) {
      const int head0 = (c0 - which * C) / VIT_HD;
#pragma unroll
      for (int g = 0; g < 64 / OUT_ROWS; ++g) {
        const int tok = p0 + row_off + OUT_ROWS * g;
        if (tok >= n_tokens) break;
        const int bb = tok / Np, t = tok % Np;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          tma_store_3d(tq, out + hh * (64 * 128) + g * (OUT_ROWS * 128), 0, t,
                       (which * B + bb) * heads + head0 + hh);
      }
      bulk_commit();
    }
  };
  // one stage (64 of K) of the products into acc
  int it = 0;
  auto stage = [&](float (&acc)[64], int kb) {
    const int st = it % S;
    mbar_wait(&sm.full[st], (it / S) & 1);
    const uint8_t* sa = sm.panel + (size_t)kb * PR * 128 + row_off * 128;
    const uint8_t* sb = sm.ring[st] + col_off * 128;
    wg_fence();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BOX / 16; ++kk)
      wgmma_m64n128_ss<0, 0>(acc, desc_sw128(sa + kk * 32, 16, ATOM),
                             desc_sw128(sb + kk * 32, 16, ATOM));
    wg_commit();
    wg_wait<1>();  // the stage before this one is done: release it
    fence_regs(acc);
    if (it > 0) mbar_arrive(&sm.empty[(it - 1) % S]);
    ++it;
  };
  // one column step into acc; the previous step's accumulator `prev`,
  // complete once this step's first stage has waited, is stored while that
  // stage runs on the tensor cores
  auto column_step = [&](float (&acc)[64], float (&prev)[64], int ns) {
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    stage(acc, 0);
    if (ns > ns_beg) {
      fence_regs(prev);
      epilogue(prev, ns - 1);
    }
    for (int kb = 1; kb < Cfg::K_STEPS; ++kb) stage(acc, kb);
  };
  float acc0[64], acc1[64];
  for (int ns = ns_beg; ns < ns_end; ns += 2) {
    column_step(acc0, acc1, ns);
    if (ns + 1 < ns_end) column_step(acc1, acc0, ns + 1);
  }
  wg_wait<0>();
  fence_regs(acc0);
  fence_regs(acc1);
  if ((ns_end - ns_beg) & 1) epilogue(acc0, ns_end - 1);
  else epilogue(acc1, ns_end - 1);
  if (leader) bulk_wait<0>();  // shared memory stays until the stores are done
}

// The forward's launch and vit_attn_bwd.cu's recompute run the same body
// under two names, so that a profile tells the two apart.
#define HMDT_QKV_KERNEL(NAME)                                                                  \
  template <int C>                                                                            \
  __global__ void __launch_bounds__(THREADS, 1)                                               \
  NAME(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,        \
       const __grid_constant__ CUtensorMap tq, bf16* __restrict__ h_out,                      \
       const float* __restrict__ bias, const float* __restrict__ ln_w,                        \
       const float* __restrict__ ln_b, int n_tokens, int Np, int heads, float eps) {          \
    qkv_panel<C>(&tx, &tw, &tq, h_out, bias, ln_w, ln_b, n_tokens, Np, heads, eps);           \
  }
HMDT_QKV_KERNEL(vit_qkv_kernel)
HMDT_QKV_KERNEL(vit_attn_bwd_qkv_kernel)
#undef HMDT_QKV_KERNEL

template <int C>
static int launch_qkv(const void* x, void* qkv, void* h_out, const void* w, const void* b,
                      const void* ln_w, const void* ln_b, int n_tokens, int Np, int heads,
                      float eps, bool recompute, cudaStream_t stream) {
  using Cfg = QkvCfg<C>;
  CUtensorMap mx, mw, mq;
  const uint64_t dx[2] = {(uint64_t)C, (uint64_t)n_tokens}, dw[2] = {(uint64_t)C, (uint64_t)3 * C};
  const uint64_t dq[3] = {(uint64_t)VIT_HD, (uint64_t)Np, (uint64_t)3 * (n_tokens / Np) * heads};
  const uint32_t bx[2] = {BOX, Cfg::PR}, bw[2] = {BOX, 128}, bq[3] = {VIT_HD, OUT_ROWS, 1};
  int err = make_tensor_map(&mx, x, 2, dx, bx);
  if (!err) err = make_tensor_map(&mw, w, 2, dw, bw);
  if (!err) err = make_tensor_map(&mq, qkv, 3, dq, bq);
  if (err) return err;
  constexpr size_t smem = qkv_smem_bytes<C>();
  static_assert(smem <= SMEM_LIMIT, "shared memory over the sm_90 limit");
  auto kernel = recompute ? vit_attn_bwd_qkv_kernel<C> : vit_qkv_kernel<C>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  // split the columns into thirds where one block a panel leaves SMs idle:
  // the fewer waves, counting a third's block as a third of the work plus
  // its LN1 (about a tenth of a whole block)
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long panels = (n_tokens + Cfg::PR - 1) / Cfg::PR;
  const double whole = (double)((panels + sms - 1) / sms) * 1.0;
  const double thirds = (double)((3 * panels + sms - 1) / sms) * (1.0 / 3.0 + 0.1);
  const int splits = thirds < whole ? 3 : 1;
  if (panels > 2147483647L) return (int)cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)panels, splits), THREADS, smem, stream>>>(
      mx, mw, mq, static_cast<bf16*>(h_out),
      static_cast<const float*>(b), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), n_tokens, Np, heads, eps);
  return (int)cudaGetLastError();
}

// The launch of either name (recompute: vit_attn_bwd.cu's); the argument
// rules of vit_qkv_launch.
int qkv_launch(const void* x, void* qkv, void* h_out, const void* w_qkv, const void* b_qkv,
               const void* ln_w, const void* ln_b, int n_tokens, int Np, int C, int heads,
               float eps, bool recompute, cudaStream_t s) {
  if (n_tokens <= 0 || Np <= 0 || Np % OUT_ROWS || n_tokens % Np || heads * VIT_HD != C)
    return (int)cudaErrorInvalidValue;
  switch (C) {
    case 384:
      return launch_qkv<384>(x, qkv, h_out, w_qkv, b_qkv, ln_w, ln_b, n_tokens, Np, heads, eps,
                             recompute, s);
    case 768:
      return launch_qkv<768>(x, qkv, h_out, w_qkv, b_qkv, ln_w, ln_b, n_tokens, Np, heads, eps,
                             recompute, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace hmdt

// C interface for ctypes. Returns cudaGetLastError() after the launch (0 on
// success), or the error that stopped it before. x (n_tokens, C) bf16 with
// n_tokens = B * Np, Np a multiple of 16; qkv (3, B, heads, Np, 64) bf16; h_out (n_tokens, C)
// bf16 or null; w (3C, C) bf16; b, ln_w, ln_b float32; C 384 or 768.
extern "C" int vit_qkv_launch(const void* x, void* qkv, void* h_out, const void* w_qkv,
                              const void* b_qkv, const void* ln_w, const void* ln_b,
                              int n_tokens, int Np, int C, int heads, float eps,
                              void* stream) {
  return hmdt::qkv_launch(x, qkv, h_out, w_qkv, b_qkv, ln_w, ln_b, n_tokens, Np, C, heads, eps,
                          false, static_cast<cudaStream_t>(stream));
}
