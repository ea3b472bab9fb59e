// Fused raw log10-mel for Hopper (sm_90a).
//
// Replaces the TPU kernel whisper_tpu/ops/mel_pallas.py:log10_mel_pallas
// (_mel_kernel): from reflect-padded audio (B, L) fp32 to the raw log10 mel
// (B, n_mels, n_frames) fp32, before the per-utterance -8 clamp and scaling
// (which stay in PyTorch, as they stay outside the TPU kernel). Frame f is
// samples [f * 160, f * 160 + 400) (zeros past L), windowed by the periodic
// Hann window; power = |DFT|^2 over 201 bins; mel = slaney filterbank .
// power; out = log10(max(mel, 1e-10)). n_fft 400, hop 160; any n_mels (80
// and 128 in the model's configurations).
//
// What bounds it on the card: bytes, once the transform is an FFT. At
// turbo's batch 64 (3000 frames, 128 mels) the function moves 221 MB
// (0.066 ms at 3.35 TB/s); the TPU kernel's dense DFT matmul would be 6.2e10
// fp32 operations (1.07 ms at 67 TFLOP/s without tensor cores), the FFT
// below about 1e4 a frame (2e9 in all, 0.06 ms even at the float64 rate).
// What sets its pace in practice is shared memory and latency: every stage
// reads and writes a frame's 200 complex values.
//
// Why the FFT runs in float64: at a bin whose power is near zero against
// the frame's (noise makes some in every batch) any fp32 transform errs by
// ~1e-7 of the frame's magnitude, so the raw log10 mel there is off by up
// to several 1e-4; the plain version's dense fp32 DFT is off by as much
// (up to 7e-4 on turbo B64 noise), and an fp32 FFT's error adds to it past
// the 5e-4 the kernel is held to (PERF.md: 3 of 10 noise draws). In float64
// the kernel's spectrum is exact to its fp32 output, so it differs from the
// plain version by the plain version's own error only. The mel projection
// and log10 stay fp32 (sums of positive terms, well conditioned).
//
// What the design does about it. One block of 8 threads a frame per (batch,
// tile of FT = 16 frames): 128 threads, 70 KB of shared memory, three blocks
// an SM (the probes chose 16 frames over 32, PERF.md):
//   - the tile's audio window ((FT - 1) * 160 + 400 samples) is staged in
//     shared memory once, by cp.async, every copy in flight at once; frame
//     f reads samples f * 160 + n straight from it: no framed copy reaches
//     device memory, the TPU kernel's point;
//   - a real 400-point frame is one complex 200-point FFT of
//     z[m] = x[2m] w[2m] + i x[2m+1] w[2m+1] (the Hann window applied as the
//     samples are read), 200 = 8 x 25 by Cooley-Tukey:
//       1. a thread per (frame, m2 < 25): the 8-point DFT over
//          z[25 m1 + m2] in registers (radix 2), times W_200^(m2 k1), into
//          the frame's buffer at [k1][m2];
//       2. a thread per (frame, k1 < 8): the 25-point DFT of row k1 in
//          registers, as 5 x 5 with the twiddles W_25^(b c) between, which
//          leaves Z[k1 + 8 k2] in its registers;
//       3. the same thread: the real spectrum's bins k = k1 + 8 k2 <= 100
//          and 200 - k from Z[k] and Z[200 - k] (one twiddle W_400^k); Z[200
//          - k] sits in the registers of the frame's row 8 - k1, a
//          neighbouring lane, and comes by shuffle. Their powers, rounded
//          to fp32, go into the power tile (201 bins x FT frames, rows padded
//          to FT + 4 floats: the bins a warp writes at once and the
//          frame-per-lane reads of the mel stage both fall on distinct
//          banks);
//     every twiddle, the window and the radix-5 constants come from one
//     table computed on the host in float64 (ops/log10_mel.py fft_table),
//     read through L1: no recurrence on the card. Stage 1's strides (25
//     complex between lanes) and stage 2's (200 complex between frames)
//     keep each quarter-warp's 16-byte accesses on distinct banks.
//   - the mel stage: lane l is frame l % FT, the warp's two half-warps take
//     two mels at once: each mel sums only its filter's nonzero span (the
//     rest of the dense product adds exact zeros), with the filters'
//     weights packed by span in shared memory, reading the weight
//     half-warp-uniform and the power along adjacent addresses, and each row
//     of FT frames is written to out (b, m, f0..) in one coalesced store.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C interface, loaded with ctypes (whisper_tpu_torch/ops/log10_mel.py).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int NF = N_FFT / 2 + 1;  // 201 bins
constexpr int NZ = N_FFT / 2;      // the complex FFT's 200 points
// the FFT table (ops/log10_mel.py: HANN, TW200, TW25, TW400, CONST)
constexpr int HANN = 0, TW200 = 400, TW25 = 800, TW400 = 850, CONST = 1052;

// A block of FT frames, 8 threads a frame (stage 2: one (frame, k1) row a
// thread). Shared memory: the audio window, later the power tile (floats) |
// the frames' FFT buffers (FT x 200 complex double) | the mel filters'
// first bins, offsets and packed weights. The table stays in global
// memory, read through L1.
constexpr int FT = 16;
constexpr int THREADS = FT * 8;
constexpr int WARPS = THREADS / 32;
constexpr int WIN = (FT - 1) * HOP + N_FFT;
// power-tile row, padded to 4 mod 16: the (frame, k1) lanes of stage 3
// write bins k1 + 8 j of four frames on distinct banks, and the mel stage's
// frame-per-lane reads are adjacent
constexpr int PROW = FT + 4;
constexpr int REGION = ((WIN > NF * PROW ? WIN : NF * PROW) + 3) & ~3;  // floats
constexpr size_t BUF_AT = REGION * sizeof(float);
constexpr size_t MEL_AT = BUF_AT + (size_t)FT * NZ * 2 * sizeof(double);
static_assert(32 % FT == 0, "the mel stage tiles a warp with frames");
inline size_t smem_bytes(int nnz, int n_mels) {
  return MEL_AT + 4 * ((size_t)nnz + 2 * n_mels + 1);
}

struct cx {
  double r, i;
};

__device__ __forceinline__ cx add(cx a, cx b) { return {a.r + b.r, a.i + b.i}; }
__device__ __forceinline__ cx sub(cx a, cx b) { return {a.r - b.r, a.i - b.i}; }
__device__ __forceinline__ cx mul(cx a, cx b) {
  return {a.r * b.r - a.i * b.i, a.r * b.i + a.i * b.r};
}
__device__ __forceinline__ cx mul_mi(cx a) { return {a.i, -a.r}; }  // a * (-i)
__device__ __forceinline__ cx ld(const double* p) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  return {v.x, v.y};
}
__device__ __forceinline__ void st(double* p, cx a) {
  *reinterpret_cast<double2*>(p) = make_double2(a.r, a.i);
}

struct Radix5 {
  double c1, s1, c2, s2;  // cos, sin of 2 pi / 5 and 4 pi / 5
};

// x[0..4] <- its 5-point DFT (W_5 = exp(-2 pi i / 5)), in place
__device__ __forceinline__ void dft5(cx* x, const Radix5& k) {
  const cx t1 = add(x[1], x[4]), t2 = add(x[2], x[3]);
  const cx t3 = sub(x[1], x[4]), t4 = sub(x[2], x[3]);
  const cx a = {x[0].r + k.c1 * t1.r + k.c2 * t2.r, x[0].i + k.c1 * t1.i + k.c2 * t2.i};
  const cx b = {x[0].r + k.c2 * t1.r + k.c1 * t2.r, x[0].i + k.c2 * t1.i + k.c1 * t2.i};
  const cx u = mul_mi({k.s1 * t3.r + k.s2 * t4.r, k.s1 * t3.i + k.s2 * t4.i});
  const cx v = mul_mi({k.s2 * t3.r - k.s1 * t4.r, k.s2 * t3.i - k.s1 * t4.i});
  x[0] = add(x[0], add(t1, t2));
  x[1] = add(a, u);
  x[4] = sub(a, u);
  x[2] = add(b, v);
  x[3] = sub(b, v);
}

// x[0..3] <- its 4-point DFT, in place
__device__ __forceinline__ void dft4(cx* x) {
  const cx c0 = add(x[0], x[2]), c1 = sub(x[0], x[2]);
  const cx c2 = add(x[1], x[3]), c3 = mul_mi(sub(x[1], x[3]));
  x[0] = add(c0, c2);
  x[2] = sub(c0, c2);
  x[1] = add(c1, c3);
  x[3] = sub(c1, c3);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__global__ void __launch_bounds__(THREADS)
log10_mel_kernel(const float* __restrict__ audio, long long L, int n_frames,
                 const double* __restrict__ table, const float* __restrict__ mel_w,
                 const int* __restrict__ mel_lo, const int* __restrict__ mel_start, int n_mels,
                 float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const double* tab = table;  // read through L1: no shared memory for it
  float* win = reinterpret_cast<float*>(smem);
  float* power = win;  // after stage 1, in the window's place
  double* buf = reinterpret_cast<double*>(smem + BUF_AT);
  int* lo = reinterpret_cast<int*>(smem + MEL_AT);
  int* start = lo + n_mels;  // n_mels + 1 offsets into w
  float* w = reinterpret_cast<float*>(start + n_mels + 1);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, f0 = blockIdx.x * FT;
  const float* x = audio + (size_t)b * L;
  const long long base = (long long)f0 * HOP;
  // the audio window by cp.async, all in flight at once (16 bytes a copy
  // where the rows are 16-byte aligned, else 4)
  if ((L & 3) == 0 && (reinterpret_cast<uintptr_t>(audio) & 15) == 0) {
    for (int i = 4 * tid; i < WIN; i += 4 * THREADS) {
      if (base + i < L)
        cp_async16(win + i, x + base + i);
      else
        *reinterpret_cast<float4*>(win + i) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  } else {
    for (int i = tid; i < WIN; i += THREADS) {
      if (base + i < L)
        cp_async4(win + i, x + base + i);
      else
        win[i] = 0.f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = tid; i < n_mels; i += THREADS) lo[i] = mel_lo[i];
  for (int i = tid; i <= n_mels; i += THREADS) start[i] = mel_start[i];
  const int nnz = mel_start[n_mels];
  for (int i = tid; i < nnz; i += THREADS) w[i] = mel_w[i];
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 1. the 8-point DFTs over m1 of z[25 m1 + m2], twiddled by W_200^(m2 k1)
  const double r2 = tab[CONST + 4];
  for (int t = tid; t < FT * 25; t += THREADS) {
    const int f = t / 25, m2 = t % 25;
    cx v[8];
#pragma unroll
    for (int m1 = 0; m1 < 8; ++m1) {  // samples 2m and 2m+1, m = 25 m1 + m2
      const int n = 50 * m1 + 2 * m2;
      const float2 s = *reinterpret_cast<const float2*>(win + f * HOP + n);
      const cx h = ld(tab + HANN + n);
      v[m1] = {double(s.x) * h.r, double(s.y) * h.i};
    }
    cx e[4], o[4];  // radix 2 by frequency: the even and odd outputs
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      e[j] = add(v[j], v[j + 4]);
      o[j] = sub(v[j], v[j + 4]);
    }
    // o[j] *= W_8^j
    o[1] = {r2 * (o[1].r + o[1].i), r2 * (o[1].i - o[1].r)};
    o[2] = mul_mi(o[2]);
    o[3] = {r2 * (o[3].i - o[3].r), -r2 * (o[3].r + o[3].i)};
    dft4(e);
    dft4(o);
    double* y = buf + f * (2 * NZ) + 2 * m2;  // row k1 at y + 50 k1
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      st(y + 50 * (2 * q), mul(e[q], ld(tab + TW200 + 2 * (m2 * 8 + 2 * q))));
      st(y + 50 * (2 * q + 1), mul(o[q], ld(tab + TW200 + 2 * (m2 * 8 + 2 * q + 1))));
    }
  }
  __syncthreads();

  // 2. the 25-point DFT of row k1 (5 x 5): Z[k1 + 8 k2] in registers, and
  // 3. the real spectrum's bins k and 200 - k: with A = Z[k], B =
  // conj(Z[200 - k]), E = (A + B) / 2 and O = (A - B) / 2i are the DFTs of
  // the even and odd samples, X[k] = E + W_400^k O and X[200 - k] =
  // conj(E - W_400^k O). Z[200 - k] of k = k1 + 8 k2 is Z[(8 - k1) + 8 (24 -
  // k2)]: the thread of (frame, 8 - k1), a neighbouring lane, holds it (row
  // 0 holds its own partners, Z[8 (25 - k2)]), so it comes by shuffle
  {
    const Radix5 k5 = {tab[CONST], tab[CONST + 1], tab[CONST + 2], tab[CONST + 3]};
    const int f = tid / 8, k1 = tid % 8;
    const double* z = buf + f * (2 * NZ);
    cx y[25];  // y[5 a + b] = row k1 at m2 = 5 a + b
#pragma unroll
    for (int m2 = 0; m2 < 25; ++m2) y[m2] = ld(z + 2 * (k1 * 25 + m2));
#pragma unroll
    for (int bb = 0; bb < 5; ++bb) {  // over a, for each b: u[b][c] at y[5 c + b]
      cx u[5];
#pragma unroll
      for (int a = 0; a < 5; ++a) u[a] = y[5 * a + bb];
      dft5(u, k5);
#pragma unroll
      for (int c = 0; c < 5; ++c) y[5 * c + bb] = mul(u[c], ld(tab + TW25 + 2 * (bb * 5 + c)));
    }
#pragma unroll
    for (int c = 0; c < 5; ++c) dft5(y + 5 * c, k5);  // over b: Z[k1 + 8 k2] at y[slot(k2)]
    auto slot = [](int k2) { return 5 * (k2 % 5) + k2 / 5; };
    const int partner = lane + 8 - 2 * k1;  // (frame, 8 - k1)
#pragma unroll
    for (int j = 0; j < 25; ++j) {
      const cx send = y[slot(24 - j)];  // the partner's k2 = j pairs with our 24 - j
      cx Bz = {__shfl_sync(0xffffffffu, send.r, partner),
               __shfl_sync(0xffffffffu, send.i, partner)};
      if (k1 == 0) Bz = y[slot((25 - j) % 25)];
      const int k = k1 + 8 * j;
      if (k <= NZ / 2) {
        const cx A = y[slot(j)];
        const double half = 0.5;
        const cx E = {half * (A.r + Bz.r), half * (A.i - Bz.i)};
        const cx O = mul_mi({half * (A.r - Bz.r), half * (A.i + Bz.i)});
        const cx WO = mul(O, ld(tab + TW400 + 2 * k));
        const cx P = add(E, WO);
        power[k * PROW + f] = (float)(P.r * P.r + P.i * P.i);
        if (k != NZ / 2) {
          const cx M = sub(E, WO);
          power[(NZ - k) * PROW + f] = (float)(M.r * M.r + M.i * M.i);
        }
      }
    }
  }
  __syncthreads();

  // mels: lane l is frame l % FT of mel (warp, l / FT) of each round;
  // log10 as log2 (MUFU) times log10(2), within ~3e-6 of log10f, and
  // exactly -10 (log10f(1e-10f)) at and below the clamp
  constexpr int MPW = 32 / FT;  // mels a warp takes at once
  const int fl = lane % FT, f = f0 + fl;
  for (int m = warp * MPW + lane / FT; m < n_mels; m += WARPS * MPW) {
    const float* wm = w + start[m] - lo[m];
    float acc = 0.f;
    for (int k = lo[m], hi = lo[m] + start[m + 1] - start[m]; k < hi; ++k)
      acc = fmaf(wm[k], power[k * PROW + fl], acc);
    if (f < n_frames)
      out[((size_t)b * n_mels + m) * n_frames + f] =
          acc > 1e-10f ? __log2f(acc) * 0.30102999566398120f : -10.f;
  }
}

}  // namespace

// audio (B, L) fp32 reflect-padded; table (1060,) float64: the FFT table
// (ops/log10_mel.py fft_table); mel_w (nnz,) fp32: filter m's weights of
// bins [lo[m], lo[m] + start[m+1] - start[m]) at mel_w[start[m]:start[m+1]];
// lo (n_mels,), start (n_mels + 1,) int32; out (B, n_mels, n_frames) fp32.
// Returns a cudaError_t.
extern "C" int log10_mel_f32(const void* audio, long long L, int B, int n_frames,
                             const void* table, const void* mel_w, const void* lo,
                             const void* start, int nnz, int n_mels, void* out, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(nnz, n_mels);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(log10_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_frames + FT - 1) / FT, B);
  log10_mel_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)audio, L, n_frames, (const double*)table, (const float*)mel_w,
      (const int*)lo, (const int*)start, n_mels, (float*)out);
  return (int)cudaGetLastError();
}
