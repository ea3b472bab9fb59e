// LayerNorm to int8 rows (K8n) for Hopper (sm_90a): the W8A8 encoder's
// LayerNorm and the activation quantization of the products that read it,
// in one pass.
//
// Replaces no TPU kernel. In the JAX package the encoder block's LayerNorm
// (whisper_tpu/models/model.py layer_norm) and the quantization of its output
// inside _linear_a8 (lines 103-105) are XLA fusions; the port ran them as
// PyTorch's elementwise and reduction kernels (about 13 passes over the rows)
// and then K8q (quantize_rows.cu) over the bf16 output, whose only readers
// are the int8 products. For rows x (M, D) and gains g, bias b (D,) of x's
// dtype (bf16 or fp32):
//   mean = sum_d x / D,  var = sum_d (x - mean)^2 / D            (fp32)
//   y    = to_x_dtype((x - mean) * (1 / sqrt(var + eps)) * g + b) (fp32 ops)
//   sx   = max(max_d |y|, 1e-8) / 127
//   q    = clamp(round_half_even(y / sx), -127, 127)              (int8)
// Each step rounds as the plain version on the CPU rounds it (separate fp32
// products and sums, never fused, IEEE division and square root), so only
// the order of the two row sums differs from PyTorch's; y is rounded to x's
// dtype before its maximum, so the int8 rows are K8q's of the LayerNorm
// output.
//
// What bounds it on the card: bytes. It reads each element once (2 bytes
// bf16) and writes one byte, plus 4 bytes of scale a row; at the turbo
// encoder's M = 96,000 and D = 1280 in bf16, 369 MB: 0.110 ms at 3.35 TB/s.
// The PyTorch LayerNorm and K8q it replaces moved about 9 GB.
//
// What the design does about it: K8q's. A row is held in fp32 registers
// from its load to its quantization, so it is read from memory once. TPR
// threads share a row (the fewest warps with at most MAXC chunks of 8 a
// thread: one warp up to D = 1280, all of Whisper's widths); each loads
// 16-byte vectors. The three row reductions (sum, squared deviations,
// maximum) are shuffle butterflies, each lane ending with the same bits, and
// across a row's warps a fixed-order sum through shared memory: no atomics,
// so a launch repeats to the bit and a row's result does not depend on the
// rows launched with it. Blocks of 256 threads hold 256 / TPR rows.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C interface, loaded with ctypes (whisper_tpu_torch/ops/layer_norm_rows.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAXC = 5;  // chunks of 8 elements a thread holds

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

// y rounded to the rows' dtype, as PyTorch's cast back to it
__device__ __forceinline__ float to_dtype(float y, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(y));
}
__device__ __forceinline__ float to_dtype(float y, const float*) { return y; }

// clamp(round_half_even(x / s), -127, 127)
__device__ __forceinline__ uint32_t q8(float x, float s) {
  const int q = __float2int_rn(__fdiv_rn(x, s));
  return (uint32_t)(uint8_t)(int8_t)max(-127, min(127, q));
}

// The sum (or maximum) of v over a row's TPR threads, the same bits in every
// one: a butterfly in each warp, then the row's warps in order through
// shared memory (red, one slot a warp, written and read once a launch).
template <int TPR, bool MAX>
__device__ __forceinline__ float row_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = MAX ? fmaxf(v, o) : __fadd_rn(v, o);
  }
  constexpr int WARPS = TPR / 32;
  if (WARPS > 1) {
    const int tid = threadIdx.x;
    if ((tid & 31) == 0) red[tid / 32] = v;
    __syncthreads();
    const int w0 = (tid / TPR) * WARPS;
    v = red[w0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v = MAX ? fmaxf(v, red[w0 + w]) : __fadd_rn(v, red[w0 + w]);
  }
  return v;
}

template <typename T, int TPR>
__global__ void __launch_bounds__(THREADS)
layer_norm_rows_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ b,
                       int8_t* __restrict__ q, float* __restrict__ sx_out, int M, int D,
                       float eps) {
  constexpr int ROWS = THREADS / TPR;
  __shared__ float red[3][THREADS / 32];
  const int tid = threadIdx.x, t = tid % TPR;
  const long long row = (long long)blockIdx.x * ROWS + tid / TPR;
  const bool live = row < M;
  const int chunks = D / 8;
  const T* xr = x + row * D;

  float v[MAXC][8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    const int c = t + i * TPR;
    if (live && c < chunks) {
      load8(xr + c * 8, v[i]);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum = __fadd_rn(sum, v[i][e]);
    }
  }
  const float mean = __fdiv_rn(row_reduce<TPR, false>(sum, red[0]), (float)D);

  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    const int c = t + i * TPR;
    if (live && c < chunks) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[i][e] = __fsub_rn(v[i][e], mean);
        ss = __fadd_rn(ss, __fmul_rn(v[i][e], v[i][e]));
      }
    }
  }
  const float var = __fdiv_rn(row_reduce<TPR, false>(ss, red[1]), (float)D);
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));

  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    const int c = t + i * TPR;
    if (live && c < chunks) {
      float gv[8], bv[8];
      load8(g + c * 8, gv);
      load8(b + c * 8, bv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[i][e] = to_dtype(__fadd_rn(__fmul_rn(__fmul_rn(v[i][e], rstd), gv[e]), bv[e]), x);
        amax = fmaxf(amax, fabsf(v[i][e]));
      }
    }
  }
  amax = row_reduce<TPR, true>(amax, red[2]);
  const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  if (live && t == 0) sx_out[row] = s;

  int8_t* qr = q + row * D;
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
int launch(const void* x, const void* g, const void* b, void* q, void* sx_out, int M, int D,
           float eps, cudaStream_t stream) {
  const int chunks = D / 8;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  const T* bt = static_cast<const T*>(b);
  int8_t* qt = static_cast<int8_t*>(q);
  float* so = static_cast<float*>(sx_out);
  if (chunks <= 32 * MAXC) {
    layer_norm_rows_kernel<T, 32><<<(M + 7) / 8, THREADS, 0, stream>>>(xt, gt, bt, qt, so, M, D,
                                                                       eps);
  } else if (chunks <= 64 * MAXC) {
    layer_norm_rows_kernel<T, 64><<<(M + 3) / 4, THREADS, 0, stream>>>(xt, gt, bt, qt, so, M, D,
                                                                       eps);
  } else if (chunks <= 128 * MAXC) {
    layer_norm_rows_kernel<T, 128><<<(M + 1) / 2, THREADS, 0, stream>>>(xt, gt, bt, qt, so, M, D,
                                                                        eps);
  } else if (chunks <= 256 * MAXC) {
    layer_norm_rows_kernel<T, 256><<<M, THREADS, 0, stream>>>(xt, gt, bt, qt, so, M, D, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, D) contiguous rows, g and b (D,) gains and bias, all of bf16
// (bf16 = 1) or all of fp32, 16-byte aligned; q (M, D) int8, sx_out (M,)
// fp32; D % 16 == 0 and D <= 8,192; M >= 1. Returns a cudaError_t.
extern "C" int layer_norm_rows(const void* x, const void* g, const void* b, void* q,
                               void* sx_out, int M, int D, float eps, int bf16, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, g, b, q, sx_out, M, D, eps, s)
              : launch<float>(x, g, b, q, sx_out, M, D, eps, s);
}
