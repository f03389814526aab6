// logmel: the fused log-mel frontend,
//   frame t = wav[(t-1)*512 : (t+1)*512] (zero outside the clip: the centre
//   pad of 512 each side), X = DFT_1024(frame * hann), power = |X|^2 over
//   bins 0..511, mel = power . slaney_fb (64 mels),
//   out = log10(max(mel, 1e-10)),
//   wav (B, N) float32 with N % 512 == 0 -> out (B, N/512 + 1, 64) float32.
//
// Replaces the TPU kernel fused_logmel (heart_murmur_detection_tpu/ops/
// pallas_mel.py:64, body _kernel :54), which computes the DFT and the mel
// as three dense products at Precision.HIGHEST: strict float32. This kernel
// is float32 throughout: every operation on the SIMT units (no tensor-core
// pass, no TF32, no bf16 operand), the window and twiddles from tables
// computed in float64 on the host (no __sinf / __cosf), and log10f the
// accurate library function (the source is built without --use_fast_math).
// What it keeps out of device memory, as the TPU kernel does: the framed
// signal and the power spectrum. Only the waveform and the small tables are
// read and only the (B, T, 64) log-mel is written.
//
// Bound on this card: a frame needs ~30,200 operations (a real 1024-point
// FFT, the power, the filterbank's 990 nonzeros) against 2 KB of waveform
// read and 256 B written, so bytes bound it: 0.69 ns a frame at 3.35 TB/s
// against 0.45 ns of float32 work at 67 TFLOP/s. The dense form (two
// 1024 x 512 DFT products and a 512 x 64 mel product, 2.17 MFLOP a frame)
// would be operations-bound at 72x the least work. What limits this kernel
// is instruction issue: ~1,100 warp instructions a frame (the FFT's
// butterflies and twiddles, shared-memory exchanges, the split step).
//
// Design. A block of 8 warps takes TF = 16 consecutive frames of one clip.
// Their 17 hop-chunks go into shared memory once by 16-byte cp.async, zero
// where the run reaches past the clip, so the centre pad costs no copy; the
// window, the twiddles and the filterbank's nonzeros come in beside them
// (84 KB a block, two blocks an SM). A warp takes one frame at a time:
// - the 1024-point real transform as a 512-point complex FFT of
//   z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1], a Stockham radix-8 x 8 x 8
//   schedule: a lane does the butterflies j = lane and lane + 32 of each
//   pass in registers (read z[j + 64 r], twiddle by W_(8 Ns)^(r (j % Ns)),
//   radix 8, write at (j / Ns) 8 Ns + j % Ns + r Ns). The passes exchange
//   through a per-warp buffer of 512 float2 under the XOR swizzle
//   i ^ ((i >> 3) & 15), which keeps the three access patterns free of bank
//   conflicts; the last pass leaves Z[lane + 32 m] in the lane's registers.
// - the split step X[k] = (Z[k] + Z*[512-k]) / 2 - i W_1024^k (Z[k] -
//   Z*[512-k]) / 2: Z[512-k] comes from lane (32 - lane) % 32 by shuffle.
// - the power re*re + im*im, rounded as written (no FMA contraction), into
//   the warp's buffer; each lane then sums mels lane and 63 - lane over
//   their bins in ascending order, one FMA a nonzero (the filterbank weights
//   only bins 4..511 at sr 16000, and bin 512 not at all: the host checks),
//   and writes their log10f: a frame's 64 outputs are two coalesced stores.
// The sums run in a fixed order for each frame: two launches give the same
// bits.
#include <cuda_runtime.h>

namespace hmdt_mel {

constexpr int HOP = 512;
constexpr int NFFT = 1024;
constexpr int NZ = NFFT / 2;    // points of the complex FFT
constexpr int NMEL = 64;
constexpr int WARPS = 8;
constexpr int NTHREADS = WARPS * 32;
constexpr int TF = 16;          // frames a block
constexpr int SEG = (TF + 1) * HOP;  // floats: the block's hop-chunks
constexpr int TW2 = 7 * 8;      // pass-2 twiddles W_64^(r l)
constexpr int TW3 = 7 * 64;     // pass-3 twiddles W_512^(r j)
constexpr int TWS = NZ;         // split twiddles W_1024^k
constexpr int TABLE = NFFT + 2 * (TW2 + TW3 + TWS);  // floats: window + twiddles
constexpr int NNZ_MAX = 2 * NZ;  // filterbank weights (a bin feeds at most two mels)
constexpr int IDX = 2 * NMEL + 1;  // ints: first bin of each mel, offsets of its weights
constexpr size_t SMEM_BYTES =
    (size_t)(SEG + TABLE + NNZ_MAX + WARPS * 2 * NZ) * sizeof(float) + IDX * sizeof(int);
static_assert(TABLE % 4 == 0 && SEG % 4 == 0, "16-byte copies");
static_assert(2 * (SMEM_BYTES + 1024) <= 233472, "two blocks an SM");

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 3) & 15); }

__device__ __forceinline__ float2 add(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 sub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}

// u0..u3 -> their 4-point DFT in place (W_4 = -i)
__device__ __forceinline__ void fft4(float2& u0, float2& u1, float2& u2, float2& u3) {
  const float2 s0 = add(u0, u2), d0 = sub(u0, u2), s1 = add(u1, u3), e = sub(u1, u3);
  const float2 d1 = make_float2(e.y, -e.x);  // (u1 - u3) (-i)
  u0 = add(s0, s1);
  u1 = add(d0, d1);
  u2 = sub(s0, s1);
  u3 = sub(d0, d1);
}

// v -> its 8-point DFT in place: a radix-2 step on (r, r + 4), the odd half
// twiddled by W_8^r, then two 4-point DFTs (even and odd outputs)
__device__ __forceinline__ void fft8(float2 (&v)[8]) {
  constexpr float S = 0.70710678118654752f;
  float2 a[4], b[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    a[r] = add(v[r], v[r + 4]);
    b[r] = sub(v[r], v[r + 4]);
  }
  b[1] = make_float2((b[1].x + b[1].y) * S, (b[1].y - b[1].x) * S);
  b[2] = make_float2(b[2].y, -b[2].x);
  b[3] = make_float2((b[3].y - b[3].x) * S, -(b[3].x + b[3].y) * S);
  fft4(a[0], a[1], a[2], a[3]);
  fft4(b[0], b[1], b[2], b[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = a[k];
    v[2 * k + 1] = b[k];
  }
}

__global__ void __launch_bounds__(NTHREADS, 2)
logmel_kernel(const float* __restrict__ wav, float* __restrict__ out,
              const float* __restrict__ tables, const float* __restrict__ mel_w,
              const int* __restrict__ mel_idx, int N, int T) {
  extern __shared__ __align__(16) float smem[];
  float* seg = smem;
  float* tab = seg + SEG;
  float* mw = tab + TABLE;
  float2* bufs = reinterpret_cast<float2*>(mw + NNZ_MAX);
  int* midx = reinterpret_cast<int*>(bufs + WARPS * NZ);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TF;
  const int n_chunks = N / HOP;
  const float* x = wav + (size_t)b * N;

  // the hop-chunks t0-1 .. t0+TF-1 (chunk -1 and chunks past the clip are
  // the pad), the tables, the filterbank's nonzeros
  for (int q = tid; q < SEG / 4; q += NTHREADS) {
    const int j = q / (HOP / 4);
    const int r4 = q - j * (HOP / 4);
    const int c = t0 - 1 + j;
    float* dst = seg + j * HOP + r4 * 4;
    if (c >= 0 && c < n_chunks)
      cp_async16(dst, x + (size_t)c * HOP + r4 * 4);
    else
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int q = tid; q < TABLE / 4; q += NTHREADS) cp_async16(tab + 4 * q, tables + 4 * q);
  for (int q = tid; q < NNZ_MAX / 4; q += NTHREADS) cp_async16(mw + 4 * q, mel_w + 4 * q);
  for (int q = tid; q < IDX; q += NTHREADS) midx[q] = mel_idx[q];
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const float2* win = reinterpret_cast<const float2*>(tab);
  const float2* tw2 = reinterpret_cast<const float2*>(tab + NFFT);
  const float2* tw3 = tw2 + TW2;
  const float2* tws = tw3 + TW3;
  float2* buf = bufs + warp * NZ;
  float* pw = reinterpret_cast<float*>(buf);
  const int mirror = (32 - lane) & 31;

  for (int f = warp; f < TF; f += WARPS) {
    const int t = t0 + f;
    if (t >= T) break;
    const float2* fr = reinterpret_cast<const float2*>(seg + f * HOP);
    float2 v[2][8];
    // pass 1 (Ns = 1): the windowed input, no twiddles
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float2 a = fr[j + 64 * r], w = win[j + 64 * r];
        v[h][r] = make_float2(__fmul_rn(a.x, w.x), __fmul_rn(a.y, w.y));
      }
      fft8(v[h]);
#pragma unroll
      for (int r = 0; r < 8; ++r) buf[swz(8 * j + r)] = v[h][r];
    }
    __syncwarp();
    // pass 2 (Ns = 8)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
#pragma unroll
      for (int r = 0; r < 8; ++r) v[h][r] = buf[swz(j + 64 * r)];
#pragma unroll
      for (int r = 1; r < 8; ++r) v[h][r] = cmul(v[h][r], tw2[(r - 1) * 8 + (j & 7)]);
      fft8(v[h]);
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
#pragma unroll
      for (int r = 0; r < 8; ++r) buf[swz(64 * (j >> 3) + (j & 7) + 8 * r)] = v[h][r];
    }
    __syncwarp();
    // pass 3 (Ns = 64): Z[lane + 32 m] lands in v[m & 1][m >> 1]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = lane + 32 * h;
#pragma unroll
      for (int r = 0; r < 8; ++r) v[h][r] = buf[swz(j + 64 * r)];
#pragma unroll
      for (int r = 1; r < 8; ++r) v[h][r] = cmul(v[h][r], tw3[(r - 1) * 64 + j]);
      fft8(v[h]);
    }
    __syncwarp();  // every lane has read the buffer: the power overwrites it
    // the split step and the power of bins k = lane + 32 m; Z[512 - k] is
    // Z[(32 - lane) + 32 (15 - m)] of lane 32 - lane, or lane 0's own
    // Z[32 (16 - m) % 512]
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      const int mm = 15 - m, m0 = (16 - m) & 15;
      const float2 zk = v[m & 1][m >> 1];
      float2 zm;
      zm.x = __shfl_sync(0xffffffffu, v[mm & 1][mm >> 1].x, mirror);
      zm.y = __shfl_sync(0xffffffffu, v[mm & 1][mm >> 1].y, mirror);
      if (lane == 0) zm = v[m0 & 1][m0 >> 1];
      const float er = 0.5f * (zk.x + zm.x), ei = 0.5f * (zk.y - zm.y);
      const float orr = 0.5f * (zk.y + zm.y), oi = 0.5f * (zm.x - zk.x);
      const int k = lane + 32 * m;
      const float2 w = tws[k];
      const float re = er + (w.x * orr - w.y * oi);
      const float im = ei + (w.x * oi + w.y * orr);
      pw[k] = __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
    }
    __syncwarp();
    // mels lane and 63 - lane: their bins in ascending order
    float* o = out + ((size_t)b * T + t) * NMEL;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = h ? NMEL - 1 - lane : lane;
      const int lo = midx[m], beg = midx[NMEL + m], end = midx[NMEL + m + 1];
      float acc = 0.f;
      for (int i = beg; i < end; ++i) acc = fmaf(pw[lo + i - beg], mw[i], acc);
      o[m] = log10f(fmaxf(acc, 1e-10f));
    }
    __syncwarp();  // the next frame's pass 1 overwrites the power
  }
}

}  // namespace hmdt_mel

// wav (B, N) float32, N % 512 == 0; out (B, N/512 + 1, 64) float32;
// tables float32 [hann window (1024) | twiddles (2 x 1016)]; mel_w float32
// (1024: the filterbank's nonzeros, zero past them); mel_idx int32 (129:
// first bin of each mel, offsets of its weights in mel_w). Every pointer
// 16-byte aligned. Returns a cudaError_t as int.
extern "C" int logmel_launch(const void* wav, void* out, const void* tables, const void* mel_w,
                             const void* mel_idx, int B, int N, void* stream) {
  using namespace hmdt_mel;
  if (B <= 0 || N <= 0 || N % HOP || B > 65535) return (int)cudaErrorInvalidValue;
  const int T = N / HOP + 1;
  cudaError_t e = cudaFuncSetAttribute(logmel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + TF - 1) / TF, B);
  logmel_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wav), static_cast<float*>(out), static_cast<const float*>(tables),
      static_cast<const float*>(mel_w), static_cast<const int*>(mel_idx), N, T);
  return (int)cudaGetLastError();
}
