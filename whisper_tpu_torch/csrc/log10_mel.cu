// Fused raw log10-mel for Hopper (sm_90a).
//
// Replaces the TPU kernel whisper_tpu/ops/mel_pallas.py:log10_mel_pallas
// (_mel_kernel): from reflect-padded audio (B, L) fp32 to the raw log10 mel
// (B, n_mels, n_frames) fp32, before the per-utterance -8 clamp and scaling
// (which stay in PyTorch, as they stay outside the TPU kernel). Frame f is
// samples [f * 160, f * 160 + 400) (zeros past L), windowed by the periodic
// Hann window inside the DFT bank; power = re^2 + im^2 over 201 bins; mel =
// slaney filterbank . power; out = log10(max(mel, 1e-10)). n_fft 400, hop
// 160; any n_mels (80 and 128 in the model's configurations).
//
// What bounds it on the card: operations. At turbo's batch 64 (3000 frames,
// 128 mels) the DFT is 2 * 64 * 3000 * 400 * 402 = 6.2e10 fp32 operations
// and the dense mel projection 6.6e9 more: 1.07 ms at 67 TFLOP/s without
// tensor cores, against 0.066 ms for its 221 MB in and out. The math stays
// fp32 on the FMA units (no TF32): log10 of the power follows.
//
// What the design does about it. One block of 256 threads per (batch, tile
// of 32 frames):
//   - the tile's audio window ((32 - 1) * 160 + 400 samples) is staged in
//     shared memory once, and frame f reads samples f * 160 + n straight
//     from it: no framed copy reaches device memory, the TPU kernel's point;
//   - the Hann-windowed DFT bank (400 x 201 complex, padded to 224 bins and
//     stored as (n, bin, {cos, sin}) float2) is 717 KB, over the 227 KB a
//     block holds, so it streams through shared memory in slabs of 40
//     samples that every frame of the tile reuses;
//   - warp w owns frames 4w..4w+3 and lane l bins l, l+32, ..., l+192 (7
//     bins, 201..223 are zero padding): 56 fp32 accumulators (re and im of
//     4 frames x 7 bins) a thread, so a thread holds both parts of a bin and
//     forms its power itself. Each step reads 4 window samples (broadcast)
//     and 7 float2 bank entries (adjacent lanes, adjacent addresses) for 56
//     FMAs;
//   - the power tile (201 bins x 32 frames, rows padded to 33 floats so the
//     bin-per-lane writes hit distinct banks) takes the slab's place in
//     shared memory; then lane l is frame l and warp w takes mels w, w+8,
//     ...: each mel sums only its filter's nonzero bins [lo, hi) (the rest
//     of the dense product adds exact zeros), reading the filter weight
//     warp-uniform and the power along adjacent addresses, and the row of
//     32 frames is written to out (b, m, f0..f0+31) in one coalesced store.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C interface, loaded with ctypes (whisper_tpu_torch/ops/log10_mel.py).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int NF = N_FFT / 2 + 1;  // 201 bins
constexpr int FP = 224;            // bins padded to 7 per lane
constexpr int BINS = FP / 32;      // bins a lane owns
constexpr int FT = 32;             // frames per block: one per lane in the mel stage
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int FPW = FT / WARPS;    // frames per warp in the DFT stage
constexpr int KS = 40;             // bank rows per slab
constexpr int WIN = (FT - 1) * HOP + N_FFT;
constexpr int PROW = FT + 1;       // power-tile row, padded
constexpr size_t SMEM_FLOATS = WIN + (size_t)KS * FP * 2;
static_assert(N_FFT % KS == 0, "slabs tile the bank");
static_assert((size_t)NF * PROW <= (size_t)KS * FP * 2, "the power tile fits in the slab");
static_assert(WIN % 4 == 0, "the slab starts 16-byte aligned");

__global__ void __launch_bounds__(THREADS)
log10_mel_kernel(const float* __restrict__ audio, long long L, int n_frames,
                 const float4* __restrict__ bank, const float* __restrict__ fb,
                 const int* __restrict__ lo, const int* __restrict__ hi, int n_mels,
                 float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* win = reinterpret_cast<float*>(smem4);
  float2* slab = reinterpret_cast<float2*>(win + WIN);
  float* power = win + WIN;  // after the DFT, in the slab's place

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, f0 = blockIdx.x * FT;
  const float* x = audio + (size_t)b * L;
  const long long base = (long long)f0 * HOP;
  for (int i = tid; i < WIN; i += THREADS) {
    const long long s = base + i;
    win[i] = s < L ? x[s] : 0.f;
  }

  float re[FPW][BINS], im[FPW][BINS];
#pragma unroll
  for (int i = 0; i < FPW; ++i)
#pragma unroll
    for (int j = 0; j < BINS; ++j) re[i][j] = im[i][j] = 0.f;

  const float* wf = win + warp * FPW * HOP;  // this warp's first frame
  for (int n0 = 0; n0 < N_FFT; n0 += KS) {
    __syncthreads();  // the last slab is consumed (and the window is staged)
    const float4* src = bank + (size_t)n0 * FP / 2;
    float4* dst = reinterpret_cast<float4*>(slab);
    for (int i = tid; i < KS * FP / 2; i += THREADS) dst[i] = src[i];
    __syncthreads();
#pragma unroll 4
    for (int nn = 0; nn < KS; ++nn) {
      float xs[FPW];
#pragma unroll
      for (int i = 0; i < FPW; ++i) xs[i] = wf[i * HOP + n0 + nn];
      const float2* row = slab + nn * FP + lane;
#pragma unroll
      for (int j = 0; j < BINS; ++j) {
        const float2 c = row[32 * j];
#pragma unroll
        for (int i = 0; i < FPW; ++i) {
          re[i][j] = fmaf(xs[i], c.x, re[i][j]);
          im[i][j] = fmaf(xs[i], c.y, im[i][j]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with the slab: the power tile replaces it
#pragma unroll
  for (int j = 0; j < BINS; ++j) {
    const int k = lane + 32 * j;
    if (k < NF) {
#pragma unroll
      for (int i = 0; i < FPW; ++i)
        power[k * PROW + warp * FPW + i] = re[i][j] * re[i][j] + im[i][j] * im[i][j];
    }
  }
  __syncthreads();

  const int f = f0 + lane;
  for (int m = warp; m < n_mels; m += WARPS) {
    const float* w = fb + (size_t)m * NF;
    float acc = 0.f;
    for (int k = lo[m]; k < hi[m]; ++k) acc = fmaf(w[k], power[k * PROW + lane], acc);
    if (f < n_frames) out[((size_t)b * n_mels + m) * n_frames + f] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

// audio (B, L) fp32 reflect-padded; bank (400, 224, 2) fp32: Hann-windowed
// cos and -sin per (sample, bin), zero past bin 200; fb (n_mels, 201) fp32;
// lo, hi (n_mels,) int32: each filter's nonzero bins; out (B, n_mels,
// n_frames) fp32. Returns a cudaError_t.
extern "C" int log10_mel_f32(const void* audio, long long L, int B, int n_frames,
                             const void* bank, const void* fb, const void* lo, const void* hi,
                             int n_mels, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = SMEM_FLOATS * sizeof(float);
  err = cudaFuncSetAttribute(log10_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_frames + FT - 1) / FT, B);
  log10_mel_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)audio, L, n_frames, (const float4*)bank, (const float*)fb,
      (const int*)lo, (const int*)hi, n_mels, (float*)out);
  return (int)cudaGetLastError();
}
