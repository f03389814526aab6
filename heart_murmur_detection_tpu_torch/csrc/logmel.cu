// logmel: the fused log-mel frontend,
//   frame t = wav[(t-1)*512 : (t+1)*512] (zero outside the clip: the centre
//   pad of 512 each side), re = frame . (hann cos), im = frame . (-hann sin)
//   over 1024 samples for each bin, power = re^2 + im^2,
//   mel = power . slaney_fb (64 mels), out = log10(max(mel, 1e-10)),
//   wav (B, N) float32 with N % 512 == 0 -> out (B, N/512 + 1, 64) float32.
//
// Replaces the TPU kernel fused_logmel (heart_murmur_detection_tpu/ops/
// pallas_mel.py:64, body _kernel :54), whose three products run at
// Precision.HIGHEST: strict float32. This kernel is float32 throughout:
// every product is an FFMA on the SIMT units (no tensor-core pass, no TF32,
// no bf16 operand), and log10f is the accurate library function (the source
// is built without --use_fast_math).
//
// What it keeps out of device memory, as the TPU kernel does: the framed
// signal (B, T, 1024) and the power spectrum (B, T, 513). Only the waveform
// is read and only the (B, T, 64) log-mel is written.
//
// Bound on this card: 2 * 2 * 1024 * 513 + 2 * 513 * 64 = 2,166,912 FLOPs a
// frame against 2 KB read and 256 B written, so the operations bound it:
// 43.4 GFLOP for 64 ten-second clips, 0.65 ms at the 67 TFLOP/s float32
// non-tensor peak.
//
// Design. One block of 8 warps takes one clip and a tile of 64 frames. The
// 65 hop-chunks the tile needs (133 KB) go into shared memory once, zero
// where the tile reaches past the clip, so the centre pad costs no copy.
// A frame is then a row of that buffer: frame f of the tile is
// seg[f*512 : f*512 + 1024]. The bins go in 4 tiles of 128 (bins 0..511:
// the slaney filterbank weights bin 512, the Nyquist bin, by exactly zero
// at fmax 8000 and sr 16000, and the host checks that; bins 0..3 carry zero
// weight too and are computed all the same). For each bin tile, the
// (1024 x 128) cos and sin bases stream from L2 in k-tiles of 32 rows
// through a two-stage cp.async ring; each thread holds re and im of 8
// frames x 4 bins in registers (warp w: frames 8w..8w+7, lane l: bins
// 4l..4l+3), so a k step reads the 8 frame samples as warp-wide broadcasts
// and the cos / sin rows as conflict-free 16-byte loads. After the k loop
// the tile's power (64 x 128) and its 128 filterbank rows go through shared
// memory once, and each thread adds their product into its 4 frames x 4
// mels of the mel accumulator, kept in registers across the bin tiles. The
// sums run over k = 0..1023 in order for each (frame, bin), and over the
// bins in order for each (frame, mel): two launches give the same bits.
//
// Later work: the windowed bases are symmetric in n <-> 1024 - n, which
// halves the DFT products; mma.sync in a split-TF32 (3xTF32) form would
// run them on the tensor cores at float32 accuracy.
#include <cuda_runtime.h>
#include <stdint.h>

namespace hmdt_mel {

constexpr int HOP = 512;
constexpr int NFFT = 1024;
constexpr int TF = 64;      // frames a block
constexpr int TB = 128;     // bins a bin tile
constexpr int NBIN = 512;   // bins computed (the bases' columns)
constexpr int NMEL = 64;
constexpr int KT = 32;      // DFT depth of one pipeline stage
constexpr int NTHREADS = 256;
constexpr int SEG = (TF + 1) * HOP;            // floats: the tile's hop-chunks
constexpr int STAGE = 2 * KT * TB;             // floats: a cos and a sin k-tile
constexpr int PSTRIDE = TB + 4;                // floats: a power row in shared memory
constexpr int EPI = TF * PSTRIDE + TB * NMEL;  // floats: power tile + filterbank tile
constexpr int WORK = (2 * STAGE > EPI) ? 2 * STAGE : EPI;
constexpr size_t SMEM_BYTES = (size_t)(SEG + WORK) * sizeof(float);
static_assert(SMEM_BYTES <= 232448, "shared memory over the sm_90 limit");
static_assert(NBIN % TB == 0 && NFFT % KT == 0, "tiles must divide the shapes");

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one k-tile (rows k0..k0+KT-1) of the cos and sin bases, bins bt*TB.. , into a stage
__device__ __forceinline__ void load_stage(float* stage, const float* __restrict__ cosb,
                                           const float* __restrict__ sinb, int k0, int bt) {
  constexpr int PER_BASE = KT * TB / 4;  // float4s of one base's k-tile
  for (int q = threadIdx.x; q < 2 * PER_BASE; q += NTHREADS) {
    const int which = q / PER_BASE;
    const int rem = q - which * PER_BASE;
    const int row = rem / (TB / 4);
    const int c4 = rem - row * (TB / 4);
    const float* src = (which ? sinb : cosb) + (size_t)(k0 + row) * NBIN + bt * TB + c4 * 4;
    cp_async16(stage + which * KT * TB + row * TB + c4 * 4, src);
  }
}

__device__ __forceinline__ float comp(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(NTHREADS, 1)
logmel_kernel(const float* __restrict__ wav, float* __restrict__ out,
              const float* __restrict__ cosb, const float* __restrict__ sinb,
              const float* __restrict__ fb, int N, int T) {
  extern __shared__ __align__(16) float smem[];
  float* seg = smem;          // SEG floats
  float* work = smem + SEG;   // the base stages, then power + filterbank
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TF;
  const int n_chunks = N / HOP;
  const float* x = wav + (size_t)b * N;

  // the hop-chunks t0-1 .. t0+TF-1; chunk -1 and chunks past the clip are the pad
  for (int q = tid; q < SEG / 4; q += NTHREADS) {
    const int j = q / (HOP / 4);
    const int r4 = q - j * (HOP / 4);
    const int c = t0 - 1 + j;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c >= 0 && c < n_chunks) v = *reinterpret_cast<const float4*>(x + (size_t)c * HOP + r4 * 4);
    *reinterpret_cast<float4*>(seg + j * HOP + r4 * 4) = v;
  }

  float mel[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < 4; ++m) mel[i][m] = 0.f;
  const int f0 = warp * 8;      // this thread's DFT frames
  const int mf0 = (tid >> 4) * 4;  // its mel-product frames
  const int m0 = (tid & 15) * 4;   // and mels

  for (int bt = 0; bt < NBIN / TB; ++bt) {
    float re[8][4], im[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

    load_stage(work, cosb, sinb, 0, bt);
    cp_async_commit();
    for (int kt = 0; kt < NFFT / KT; ++kt) {
      if (kt + 1 < NFFT / KT) {
        load_stage(work + ((kt + 1) & 1) * STAGE, cosb, sinb, (kt + 1) * KT, bt);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* cs = work + (kt & 1) * STAGE;
      const float* ss = cs + KT * TB;
      const int k0 = kt * KT;
#pragma unroll 2
      for (int kk = 0; kk < KT; kk += 4) {
        float4 a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = *reinterpret_cast<const float4*>(seg + (f0 + i) * HOP + k0 + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 c = *reinterpret_cast<const float4*>(cs + (kk + j) * TB + lane * 4);
          const float4 s = *reinterpret_cast<const float4*>(ss + (kk + j) * TB + lane * 4);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float v = comp(a[i], j);
            re[i][0] = fmaf(v, c.x, re[i][0]);
            re[i][1] = fmaf(v, c.y, re[i][1]);
            re[i][2] = fmaf(v, c.z, re[i][2]);
            re[i][3] = fmaf(v, c.w, re[i][3]);
            im[i][0] = fmaf(v, s.x, im[i][0]);
            im[i][1] = fmaf(v, s.y, im[i][1]);
            im[i][2] = fmaf(v, s.z, im[i][2]);
            im[i][3] = fmaf(v, s.w, im[i][3]);
          }
        }
      }
      __syncthreads();
    }

    // the tile's power and filterbank rows through shared memory (no cp.async
    // is in flight: the last k step waited for every group)
    float* pw = work;
    float* fbs = work + TF * PSTRIDE;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float4 p;
      p.x = __fadd_rn(__fmul_rn(re[i][0], re[i][0]), __fmul_rn(im[i][0], im[i][0]));
      p.y = __fadd_rn(__fmul_rn(re[i][1], re[i][1]), __fmul_rn(im[i][1], im[i][1]));
      p.z = __fadd_rn(__fmul_rn(re[i][2], re[i][2]), __fmul_rn(im[i][2], im[i][2]));
      p.w = __fadd_rn(__fmul_rn(re[i][3], re[i][3]), __fmul_rn(im[i][3], im[i][3]));
      *reinterpret_cast<float4*>(pw + (f0 + i) * PSTRIDE + lane * 4) = p;
    }
    for (int q = tid; q < TB * NMEL / 4; q += NTHREADS)
      reinterpret_cast<float4*>(fbs)[q] =
          reinterpret_cast<const float4*>(fb + (size_t)bt * TB * NMEL)[q];
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < TB; k += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(pw + (mf0 + i) * PSTRIDE + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 w = *reinterpret_cast<const float4*>(fbs + (k + j) * NMEL + m0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = comp(p[i], j);
          mel[i][0] = fmaf(v, w.x, mel[i][0]);
          mel[i][1] = fmaf(v, w.y, mel[i][1]);
          mel[i][2] = fmaf(v, w.z, mel[i][2]);
          mel[i][3] = fmaf(v, w.w, mel[i][3]);
        }
      }
    }
    __syncthreads();  // the next bin tile's stages overwrite pw / fbs
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + mf0 + i;
    if (t >= T) continue;
    float4 o;
    o.x = log10f(fmaxf(mel[i][0], 1e-10f));
    o.y = log10f(fmaxf(mel[i][1], 1e-10f));
    o.z = log10f(fmaxf(mel[i][2], 1e-10f));
    o.w = log10f(fmaxf(mel[i][3], 1e-10f));
    *reinterpret_cast<float4*>(out + ((size_t)b * T + t) * NMEL + m0) = o;
  }
}

}  // namespace hmdt_mel

// wav (B, N) float32, N % 512 == 0; out (B, N/512 + 1, 64) float32;
// cos / sin (1024, 512) float32 (hann-windowed, bins 0..511); fb (512, 64)
// float32. Every pointer 16-byte aligned. Returns a cudaError_t as int.
extern "C" int logmel_launch(const void* wav, void* out, const void* cosb, const void* sinb,
                             const void* fb, int B, int N, void* stream) {
  using namespace hmdt_mel;
  if (B <= 0 || N <= 0 || N % HOP || B > 65535) return (int)cudaErrorInvalidValue;
  const int T = N / HOP + 1;
  cudaError_t e = cudaFuncSetAttribute(logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + TF - 1) / TF, B);
  logmel_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wav), static_cast<float*>(out), static_cast<const float*>(cosb),
      static_cast<const float*>(sinb), static_cast<const float*>(fb), N, T);
  return (int)cudaGetLastError();
}
