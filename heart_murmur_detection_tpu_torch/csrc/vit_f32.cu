// vit_f32: the attention half of a ViT block in float32 as three launches,
//   qkv = LN1(x) W_qkv^T + b_qkv               (vit_qkv_f32)
//   o_pre = concat_h softmax(q_h k_h^T, keys >= n_real masked) v_h
//                                              (vit_attn_f32)
//   h1 = x + o_pre W_proj^T + b_proj           (vit_proj_f32)
// on x (B, Np, C) float32, C 384 (ViT-S, 6 heads) or 768 (ViT-B, 12 heads),
// head dim 64, the q rows of W_qkv carrying 1/sqrt(hd) (folded by the
// caller); the MLP half is swin_mlp_f32.cu's launch with eps 1e-6.
//
// Replaces the TPU body `_attn_half` (heart_murmur_detection_tpu/ops/
// pallas_vit.py:66) at mm_dtype=float32, where every product runs at
// Precision.HIGHEST with float32 accumulation (prec = HI, :80): the float32
// mode of the TPU kernels fused_vit_block (:296, K5) and fused_vit_attn
// (:341, K6), and the forward of fused_vit_block_train (pallas_vit_train.py
// :703, K9: `_fwd_attn_kernel` :140 runs `_attn_half`). The softmax is the
// stable one: the training forward never passes fast_softmax, and the JAX
// package passes it to the ViT kernels on its bf16 extraction path alone
// (extract/extract.py:98-113). There is no rounding point: operands,
// accumulators, q, k, v and o_pre are float32. LN1 from two-pass float32
// row statistics, eps 1e-6.
//
// Bound on this card: 8 C^2 + 4 Np C operations a token (qkv 6 C^2, proj
// 2 C^2, the scores and P v 2 Np C each) against about 8 C bytes, so the
// operations bind, at the FFMA rate (wgmma's float32 input is TF32, which
// misses Precision.HIGHEST). Design:
//  1. vit_qkv_f32: the token-row product of swin_f32_common.cuh with its
//     LayerNorm prologue (each block normalises its 64 rows from statistics
//     it computes first), + b_qkv, into token-major (B Np, 3C) float32 rows;
//  2. vit_attn_f32: the core (vit_f32_attn.cuh), a block of 128 threads a
//     (tile of 64 query rows, head, clip): the q tile in shared memory, the
//     head's k and v tiles of 64 keys streamed over the keys < n_real in two
//     sweeps (the row statistics, then P = exp(s - m) / l and P v), each
//     row's output written to its head's 64 columns of o_pre (B Np, C);
//  3. vit_proj_f32: the token-row product over o_pre and W_proj, + b_proj,
//     + x.
// No atomics; every sum has one order fixed by the shapes, so two launches
// agree bitwise. B Np may be any multiple of 16: the products' last row
// tile is partial, and the core's last query and key tiles are.
#include "swin_f32_common.cuh"
#include "vit_f32_attn.cuh"

namespace hmdt {
namespace vf32 {

// Shared floats of a core block: the q tile and P^T (row tiles), the k and
// v tiles (column tiles) (ops/vit_plan.py::attn_f32_plan computes the same).
constexpr size_t core_floats() { return 2 * (size_t)AHD * RS + 2 * (size_t)AHD * CS; }
constexpr size_t core_smem_bytes() { return sizeof(float) * core_floats(); }

// grid (ceil(Np / 64), heads, B): block (tile, h, b) takes query rows [64
// tile, 64 tile + 64) of clip b, head h. qkv (B Np, 3C), o (B Np, C).
__global__ void __launch_bounds__(ATHREADS)
    vit_attn_f32_core_kernel(const float* __restrict__ qkv, float* __restrict__ o, int Np, int C,
                             int n_real) {
  extern __shared__ float4 smem4[];
  float* QT = reinterpret_cast<float*>(smem4);  // [64 d][RS]
  float* PT = QT + AHD * RS;                    // [64 keys][RS]
  float* KT = PT + AT * RS;                     // [64 d][CS]
  float* VT = KT + AHD * CS;                    // [64 d][CS]
  const int ti = threadIdx.x >> 4, tj = threadIdx.x & 15;
  const int i0 = blockIdx.x * AT, h = blockIdx.y, b = blockIdx.z;
  const int ld = 3 * C;
  const float* base = qkv + (size_t)b * Np * ld + h * AHD;
  load_tile<RS>(QT, base + (size_t)i0 * ld, ld, min(AT, Np - i0));
  const int ktiles = (n_real + AT - 1) / AT;

  // sweep 1: each row's max and sum of exp(s - max)
  float m[8], l[8], t[8], s[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    m[a] = -INFINITY;
    l[a] = t[a] = 0.f;
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    const int j0 = kt * AT;
    __syncthreads();
    load_tile<CS>(KT, base + (size_t)j0 * ld + C, ld, min(AT, Np - j0));
    __syncthreads();
    score_tile(QT, KT, s);
    mask_keys(s, j0, n_real);
    stats_tile<false>(s, s, m, l, t);
  }
  float rl[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) rl[a] = 1.f / l[a];

  // sweep 2: P and P v
  float acc[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int j0 = kt * AT, kv = min(AT, Np - j0);
    __syncthreads();
    load_tile<CS>(KT, base + (size_t)j0 * ld + C, ld, kv);
    load_tile<CS>(VT, base + (size_t)j0 * ld + 2 * C, ld, kv);
    __syncthreads();
    score_tile(QT, KT, s);
    mask_keys(s, j0, n_real);
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) p[c] = __fmul_rn(expf(s[a][c] - m[a]), rl[a]);
      store_row_t(PT, ti * 8 + a, p);
    }
    __syncthreads();
    accum_tile(PT, VT, acc);
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int row = i0 + ti * 8 + a;
    if (row >= Np) break;
    float* orow = o + ((size_t)b * Np + row) * C + h * AHD;
#pragma unroll
    for (int c = 0; c < 4; ++c) orow[tj + 16 * c] = acc[a][c];
  }
}

}  // namespace vf32
}  // namespace hmdt

namespace {

bool vit_width_ok(int n_tokens, int C) {
  return n_tokens > 0 && n_tokens % 16 == 0 && (C == 384 || C == 768);
}

bool gemm_plan_ok(int tile_rows, int tile_cols, int threads, int smem) {
  using namespace hmdt::f32;
  return tile_rows == GBM && tile_cols == GBN && threads == GTHREADS &&
         (size_t)smem == gemm_smem_bytes();
}

}  // namespace

// x (n, C) float32, n = B Np; qkv (n, 3C) float32 rows [q | k | v]; w_qkv
// (3C, C), b_qkv, ln_w, ln_b float32; the plan (ops/vit_plan.py::
// qkv_f32_plan): the product's tile rows, columns, threads and shared
// bytes, checked against the compiled ones.
extern "C" int vit_qkv_f32_launch(const void* x, void* qkv, const void* w_qkv, const void* b_qkv,
                                  const void* ln_w, const void* ln_b, int n_tokens, int C,
                                  int tile_rows, int tile_cols, int threads, int smem, float eps,
                                  void* stream) {
  using namespace hmdt::f32;
  if (!vit_width_ok(n_tokens, C) || !gemm_plan_ok(tile_rows, tile_cols, threads, smem))
    return (int)cudaErrorInvalidValue;
  const WinGeom none{0, 0, 1, 1, 0};
  return (int)launch_gemm<true, EPI_STORE, false>(
      static_cast<const float*>(x), static_cast<const float*>(w_qkv),
      static_cast<const float*>(b_qkv), static_cast<const float*>(ln_w),
      static_cast<const float*>(ln_b), nullptr, nullptr, static_cast<float*>(qkv), n_tokens,
      3 * C, C, 1, none, eps, static_cast<cudaStream_t>(stream));
}

// qkv (B Np, 3C) float32 rows; o (B Np, C) float32; n_real in (0, Np]; the
// plan (ops/vit_plan.py::attn_f32_plan): the core's threads and shared
// bytes.
extern "C" int vit_attn_f32_launch(const void* qkv, void* o, int B, int Np, int C, int heads,
                                   int n_real, int threads, int smem, void* stream) {
  using namespace hmdt::vf32;
  if (B <= 0 || B > 65535 || Np <= 0 || Np % 16 || !vit_width_ok(B * Np, C) ||
      heads * AHD != C || n_real <= 0 || n_real > Np)
    return (int)cudaErrorInvalidValue;
  if (threads != ATHREADS || (size_t)smem != core_smem_bytes()) return (int)cudaErrorInvalidValue;
  static bool attr = false;  // set once, at the first (warm-up) launch
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(vit_attn_f32_core_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)core_smem_bytes());
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  vit_attn_f32_core_kernel<<<dim3((Np + AT - 1) / AT, heads, B), ATHREADS, core_smem_bytes(),
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qkv), static_cast<float*>(o), Np, C, n_real);
  return (int)cudaGetLastError();
}

// o (n, C) float32 head outputs; x, out (n, C) float32; w_proj (C, C),
// b_proj float32; the plan (ops/vit_plan.py::proj_f32_plan): the product's
// tile rows, columns, threads and shared bytes.
extern "C" int vit_proj_f32_launch(const void* o, const void* x, void* out, const void* w_proj,
                                   const void* b_proj, int n_tokens, int C, int tile_rows,
                                   int tile_cols, int threads, int smem, void* stream) {
  using namespace hmdt::f32;
  if (!vit_width_ok(n_tokens, C) || !gemm_plan_ok(tile_rows, tile_cols, threads, smem))
    return (int)cudaErrorInvalidValue;
  const WinGeom none{0, 0, 1, 1, 0};
  return (int)launch_gemm<false, EPI_RESID, false>(
      static_cast<const float*>(o), static_cast<const float*>(w_proj),
      static_cast<const float*>(b_proj), nullptr, nullptr, static_cast<const float*>(x), nullptr,
      static_cast<float*>(out), n_tokens, C, C, n_tokens, none, 0.f,
      static_cast<cudaStream_t>(stream));
}
