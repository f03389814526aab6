// swin_wgrad and swin_reduce: the weight gradients of the training swin and
// ViT backward without unordered atomics on data.
//
//   swin_wgrad   out = A^T B for A (n, M), B (n, N) bf16 rows of per-token
//                operands (swin_attn_bwd.cu, swin_mlp_bwd.cu, vit_attn_bwd.cu),
//                float32 (M, N), in one launch: split over fixed token chunks,
//                the chunks' float32 partials summed in chunk order.
//   swin_reduce  out[l] = ws[0][l] + ws[1][l] + ... + ws[S-1][l], float32, in
//                that order: the per-block column-sum rows of the backward
//                kernels (bias, LayerNorm and rel-pos bias gradients).
//
// Together they replace the weight-gradient accumulation of the TPU
// backward bodies `_bwd_mlp_kernel` (:271) and `_bwd_attn_kernel` (:320) of
// heart_murmur_detection_tpu/ops/pallas_swin_train.py (K8), and of K9's
// "acc" plan (pallas_vit_train.py `_acc2` :206), which sum into a VMEM block
// that stays resident across the TPU's sequential grid.
//
// Bound on this card. 2 M N n operations against (M + N) n bf16 bytes: at
// the COLA stage-0 shapes (n = 262144 tokens, M, N <= 384) the bytes bind
// (~300 FLOP a byte are needed for the tensor cores to), at the ViT shapes
// (n ~ 10-20k, widths 768-3072) the operations. Design, for both:
//  - a block computes one output tile over one token chunk with the wgmma
//    GEMM core of wgmma_gemm.cuh: a producer warp keeps 64-token slices of
//    A and B in flight by TMA (each operand row is read once per tile row /
//    column, not once per 32 x 32 tile), two consumer warpgroups run wgmma
//    m64n128k16 with both operands MN-major (transposed) from shared
//    memory, so nothing is transposed in memory. Tiles of 256 x 128 (one
//    block an SM, four stages) where M >= 512, else 128 x 128 (two blocks
//    an SM, three stages); widths of 96 read zeros past the edge.
//  - split-K fixed by (n, M, N) alone (ops/swin_train.py::wgrad_split): the
//    chunk count that minimises waves of blocks times a chunk's time, so the
//    narrow stage-0 products still fill all 132 SMs.
//  - left for later: the products reach about 450-630 TFLOP/s a busy SM
//    (half to two thirds of the tensor rate) and the grids end in a short
//    wave. Measured without effect on the card: TMA multicast of the shared
//    operand in 2-block clusters (1-2%), 32-token stages in twice the
//    slots (slower), wider loads in the ordered sum. A persistent
//    (stream-K) schedule would even the waves; the operands could stay on
//    chip altogether if the products were fused into the backward kernels,
//    as in the TPU bodies.
//  - the ordered sum lives in the same launch: each chunk's block writes
//    its float32 partial tile to a workspace and takes a ticket on an
//    integer arrival counter (an atomic on a counter, never on data). The
//    last of a group of `group` consecutive chunks sums the group's
//    partials in chunk order; the last group sums the group sums in group
//    order and writes out. Every output element is thus summed in one fixed
//    order, whichever blocks finish first, so two launches agree bitwise.
//    Past 8 chunks two levels keep the serial tail of the last block to
//    about 2 sqrt(S) tiles read, not S; up to 8, one level is faster.
// swin_reduce reads S L floats once: bound by HBM.
#include "wgmma_gemm.cuh"

namespace hmdt {

using namespace hop;

// After this block's writes: a ticket on `counter`; true in the block that
// takes the last of `arrivals` tickets, which then sees every write made
// before the other tickets.
__device__ __forceinline__ bool last_arrival(unsigned* counter, unsigned arrivals, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counter, 1u) == arrivals - 1;
  __syncthreads();
  const bool last = *reinterpret_cast<volatile int*>(flag) != 0;
  if (last) __threadfence();
  return last;
}

// sum_j src[j * stride] over j = 0 .. count-1 in that order, one tile of
// `floats` floats each (tile-local row-major, 128 columns): into the tile
// `dst`, or, if dst is null, into out's (m0, n0) tile, clipped to M x N.
// The consumer threads take 4 float4s each at once, so that 4 loads are in
// flight.
template <int FLOATS>
__device__ __forceinline__ void sum_tiles(const float* __restrict__ src, size_t stride,
                                          int count, float* __restrict__ dst,
                                          float* __restrict__ out, int m0, int n0, int M,
                                          int N) {
  constexpr int V = FLOATS / 4, U = 4;
  static_assert(V % (CONSUMERS * U) == 0, "the tile splits evenly");
  if (threadIdx.x >= CONSUMERS) return;
  for (int i0 = threadIdx.x; i0 < V; i0 += CONSUMERS * U) {
    float4 a[U];
#pragma unroll
    for (int u = 0; u < U; ++u) a[u] = __ldcg(reinterpret_cast<const float4*>(src) + i0 + u * CONSUMERS);
    for (int j = 1; j < count; ++j) {
      const float4* sj = reinterpret_cast<const float4*>(src + (size_t)j * stride) + i0;
      float4 b[U];
#pragma unroll
      for (int u = 0; u < U; ++u) b[u] = __ldcg(sj + u * CONSUMERS);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        a[u].x += b[u].x;
        a[u].y += b[u].y;
        a[u].z += b[u].z;
        a[u].w += b[u].w;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * CONSUMERS;
      if (dst) {
        __stcg(reinterpret_cast<float4*>(dst) + i, a[u]);
      } else {
        const int r = m0 + (4 * i) / GEMM_COLS, c = n0 + (4 * i) % GEMM_COLS;
        if (r < M && c < N) *reinterpret_cast<float4*>(out + (size_t)r * N + c) = a[u];
      }
    }
  }
}

// grid (tiles, S): blockIdx.x the output tile of 128 MT x 128 (row-major
// over the tile grid), blockIdx.y the token chunk. ws: S partial tiles a
// tile, then (when there is more than one group) one group-sum tile per
// group and tile; cnt: tiles x groups first-level counters, then tiles
// second-level ones, all 0 at launch.
template <int MT>
__global__ void __launch_bounds__(THREADS, 3 - MT)
swin_wgrad_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  float* __restrict__ out, float* __restrict__ ws, unsigned* __restrict__ cnt,
                  int n, int M, int N, int chunk, int group) {
  constexpr int ROWS = GemmCfg<MT>::ROWS, FLOATS = ROWS * GEMM_COLS;
  extern __shared__ uint8_t smem_raw[];
  GemmSmem<MT>& sm = gemm_smem<MT>(smem_raw);
  gemm_init(sm);
  __syncthreads();

  const int tiles = gridDim.x, tile = blockIdx.x;
  const int S = gridDim.y, s = blockIdx.y;
  const int tiles_n = (N + GEMM_COLS - 1) / GEMM_COLS;
  const int m0 = (tile / tiles_n) * ROWS, n0 = (tile % tiles_n) * GEMM_COLS;
  const int t0 = s * chunk;
  const int steps = (min(n, t0 + chunk) - t0) / GEMM_BK;
  float acc[MT][64];
  gemm_core<true, MT>(sm, &ta, &tb, m0, n0, t0, steps, acc);

  // this thread's accumulator rows (r + 64 i, + 8) and column pairs of the tile
  const bool consumer = threadIdx.x < CONSUMERS;
  const int lane = threadIdx.x & 31;
  const int r = (threadIdx.x / 128) * 64 * MT + ((threadIdx.x / 32) & 3) * 16 + (lane >> 2);
  const int c = 2 * (lane & 3);
  if (S == 1) {
    if (consumer) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = m0 + r + 64 * i + 8 * h, col = n0 + 8 * j + c;
            if (row < M && col < N)
              *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
                  make_float2(acc[i][4 * j + 2 * h], acc[i][4 * j + 2 * h + 1]);
          }
    }
    return;
  }
  const size_t tstride = (size_t)tiles * FLOATS;  // chunk s + 1's tile after chunk s's
  if (consumer) {
    float* part = ws + (size_t)s * tstride + (size_t)tile * FLOATS;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          __stcg(reinterpret_cast<float2*>(part + (r + 64 * i + 8 * h) * GEMM_COLS + 8 * j + c),
                 make_float2(acc[i][4 * j + 2 * h], acc[i][4 * j + 2 * h + 1]));
  }
  const int G = (S + group - 1) / group, g = s / group;
  const int g_beg = g * group, g_end = min(S, g_beg + group);
  if (!last_arrival(&cnt[tile * G + g], g_end - g_beg, &sm.flag)) return;
  const float* first = ws + (size_t)g_beg * tstride + (size_t)tile * FLOATS;
  if (G == 1) {
    sum_tiles<FLOATS>(first, tstride, g_end - g_beg, nullptr, out, m0, n0, M, N);
    return;
  }
  float* gsum = ws + (size_t)S * tstride;  // the group sums, group-major like the partials
  sum_tiles<FLOATS>(first, tstride, g_end - g_beg,
                    gsum + (size_t)g * tstride + (size_t)tile * FLOATS, nullptr, m0, n0, M, N);
  if (!last_arrival(&cnt[tiles * G + tile], G, &sm.flag)) return;
  sum_tiles<FLOATS>(gsum + (size_t)tile * FLOATS, tstride, G, nullptr, out, m0, n0, M, N);
}

template <int MT>
static int launch_wgrad(const CUtensorMap& ma, const CUtensorMap& mb, void* out, void* ws,
                        void* cnt, int n, int M, int N, int chunk, int group,
                        cudaStream_t stream) {
  constexpr int ROWS = GemmCfg<MT>::ROWS;
  constexpr size_t smem = gemm_smem_bytes<MT>();
  const int S = (n + chunk - 1) / chunk;
  const int tiles = ((M + ROWS - 1) / ROWS) * ((N + GEMM_COLS - 1) / GEMM_COLS);
  cudaError_t e = cudaFuncSetAttribute(swin_wgrad_kernel<MT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  swin_wgrad_kernel<MT><<<dim3(tiles, S), THREADS, smem, stream>>>(
      ma, mb, static_cast<float*>(out), static_cast<float*>(ws), static_cast<unsigned*>(cnt), n,
      M, N, chunk, group);
  return (int)cudaGetLastError();
}

__global__ void swin_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                   int S, int L) {
  for (int l = blockIdx.x * blockDim.x + threadIdx.x; l < L; l += gridDim.x * blockDim.x) {
    float s = ws[l];
    for (int i = 1; i < S; ++i) s += ws[(size_t)i * L + l];
    out[l] = s;
  }
}

}  // namespace hmdt

// C interfaces for ctypes. Each returns cudaGetLastError() after the launch
// (0 on success), or the error that stopped it before.
// a (n, M), b (n, N) bf16 row-major; out (M, N) f32; n and chunk multiples
// of 64, M and N multiples of 32; rows, the output tile's rows, 128 or 256.
// With S = ceil(n / chunk) > 1 chunks in groups of `group`,
// G = ceil(S / group): ws holds (S + (G > 1 ? G : 0)) tiles x rows x 128
// floats and cnt tiles x (G + 1) zeroed uint32, where
// tiles = ceil(M / rows) ceil(N / 128); with S = 1 neither is read.
extern "C" int swin_wgrad_launch(const void* a, const void* b, void* out, void* ws, void* cnt,
                                 int n, int M, int N, int chunk, int group, int rows,
                                 void* stream) {
  using namespace hmdt;
  if (n <= 0 || n % GEMM_BK || M <= 0 || M % 32 || N <= 0 || N % 32 || chunk <= 0 ||
      chunk % GEMM_BK || group <= 0 || (rows != 128 && rows != 256) ||
      (n + chunk - 1) / chunk > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const uint64_t da[2] = {(uint64_t)M, (uint64_t)n}, db[2] = {(uint64_t)N, (uint64_t)n};
  const uint32_t box[2] = {BOX, BOX};
  int err = make_tensor_map(&ma, a, 2, da, box);
  if (!err) err = make_tensor_map(&mb, b, 2, db, box);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return rows == 256 ? launch_wgrad<2>(ma, mb, out, ws, cnt, n, M, N, chunk, group, st)
                     : launch_wgrad<1>(ma, mb, out, ws, cnt, n, M, N, chunk, group, st);
}

// ws (S, L) f32 -> out (L,) f32.
extern "C" int swin_reduce_launch(const void* ws, void* out, int S, int L, void* stream) {
  using namespace hmdt;
  if (S <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int need = (L + threads - 1) / threads;
  const int blocks = need < 8192 ? need : 8192;
  swin_reduce_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), S, L);
  return (int)cudaGetLastError();
}
