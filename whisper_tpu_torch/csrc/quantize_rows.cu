// One-pass symmetric int8 row quantization (K8q) for Hopper (sm_90a): the
// activation half of the W8A8 linear.
//
// Replaces the quantization that XLA fuses into the JAX package's
// whisper_tpu/models/model.py:_linear_a8 (lines 103-105; no pallas_call):
//   sx = max(max_k |x[m, k]|, 1e-8) / 127        (fp32, IEEE division)
//   q[m, k] = clamp(round_half_even(x[m, k] / sx), -127, 127)   (int8)
// for bf16 or fp32 rows x (M, K); or, given sx, only the second line (the
// tensor-parallel row-parallel products quantize with a global row scale).
// Each step is rounded as the plain PyTorch version rounds it (fabs, fmaxf,
// __fdiv_rn, __float2int_rn), so the bits equal the CPU's and JAX's.
// (roundf would round a .5 tie away from zero; torch.round and jnp.round
// round it to even.)
//
// What bounds it on the card: bytes. It reads each element once (2 bytes
// bf16, 4 fp32) and writes one byte, plus 4 bytes of scale a row; at the
// turbo encoder's M = 96,000 and K = 1280 in bf16, 369 MB: 0.110 ms at
// 3.35 TB/s. The PyTorch composition it replaces moved ~49 bytes an element
// over eight launches.
//
// What the design does about it: a row is held in registers between its
// maximum and its quantization, so it is read from memory once. TPR threads
// share a row (a template argument: the fewest warps with at most MAXC
// chunks of 8 elements a thread, so K up to 8,192); each loads 16-byte
// vectors, the row maximum is a shuffle reduction (and across the row's
// warps through shared memory), and each thread writes its chunks as 8-byte
// stores. Blocks of 256 threads hold 256 / TPR rows.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C interface, loaded with ctypes (whisper_tpu_torch/ops/quantize_rows.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXC = 4;  // chunks of 8 elements a thread holds

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// clamp(round_half_even(x / s), -127, 127)
__device__ __forceinline__ uint32_t q8(float x, float s) {
  const int q = __float2int_rn(__fdiv_rn(x, s));
  return (uint32_t)(uint8_t)(int8_t)max(-127, min(127, q));
}

template <typename T, int TPR>
__global__ void __launch_bounds__(THREADS)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ sx_out,
                     const float* __restrict__ sx_in, int M, int K) {
  constexpr int ROWS = THREADS / TPR, WARPS = TPR / 32;
  __shared__ float warp_max[THREADS / 32];
  const int tid = threadIdx.x, t = tid % TPR;
  const long long row = (long long)blockIdx.x * ROWS + tid / TPR;
  const bool live = row < M;
  const int chunks = K / 8;
  const T* xr = x + row * K;

  float v[MAXC][8];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    const int c = t + i * TPR;
    if (live && c < chunks) {
      load8(xr + c * 8, v[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(v[i][e]));
    }
  }

  float s;
  if (sx_in != nullptr) {
    s = live ? sx_in[row] : 1.f;
  } else {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    if (WARPS > 1) {
      if ((tid & 31) == 0) warp_max[tid / 32] = amax;
      __syncthreads();
      const int w0 = (tid / TPR) * WARPS;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) amax = fmaxf(amax, warp_max[w0 + w]);
    }
    s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
    if (live && t == 0) sx_out[row] = s;
  }

  int8_t* qr = q + row * K;
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    const int c = t + i * TPR;
    if (live && c < chunks) {
      uint2 packed;
      packed.x = q8(v[i][0], s) | q8(v[i][1], s) << 8 | q8(v[i][2], s) << 16 |
                 q8(v[i][3], s) << 24;
      packed.y = q8(v[i][4], s) | q8(v[i][5], s) << 8 | q8(v[i][6], s) << 16 |
                 q8(v[i][7], s) << 24;
      *reinterpret_cast<uint2*>(qr + c * 8) = packed;
    }
  }
}

template <typename T>
int launch(const void* x, void* q, void* sx_out, const void* sx_in, int M, int K,
           cudaStream_t stream) {
  const int chunks = K / 8;
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(sx_out);
  const float* si = static_cast<const float*>(sx_in);
  if (chunks <= 32 * MAXC) {
    quantize_rows_kernel<T, 32><<<(M + 7) / 8, THREADS, 0, stream>>>(xt, qt, so, si, M, K);
  } else if (chunks <= 64 * MAXC) {
    quantize_rows_kernel<T, 64><<<(M + 3) / 4, THREADS, 0, stream>>>(xt, qt, so, si, M, K);
  } else if (chunks <= 128 * MAXC) {
    quantize_rows_kernel<T, 128><<<(M + 1) / 2, THREADS, 0, stream>>>(xt, qt, so, si, M, K);
  } else if (chunks <= 256 * MAXC) {
    quantize_rows_kernel<T, 256><<<M, THREADS, 0, stream>>>(xt, qt, so, si, M, K);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K) contiguous rows of bf16 (is_bf16 = 1) or fp32, 16-byte aligned;
// q (M, K) int8; K % 16 == 0 and K <= 8,192; M >= 1. With sx_in null the
// row scales are computed and written to sx_out (M,) fp32; otherwise the
// rows are quantized at the given sx_in (M,) and sx_out is not written.
// Returns a cudaError_t.
extern "C" int quantize_rows(const void* x, void* q, void* sx_out, const void* sx_in, int M,
                             int K, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return is_bf16 ? launch<__nv_bfloat16>(x, q, sx_out, sx_in, M, K, (cudaStream_t)stream)
                 : launch<float>(x, q, sx_out, sx_in, M, K, (cudaStream_t)stream);
}
