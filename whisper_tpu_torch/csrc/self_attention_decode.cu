// Decode-step self-attention over the KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// whisper_tpu/ops/decode_attention.py:self_attention_decode (_self_kernel):
// one query per (batch, head) against the self-attention cache, key position
// t visible iff pads[b] <= t <= offsets[b], fp32 softmax. The TPU kernel
// reads a (B, H, T, dh) cache; this one reads the port's own position-minor
// caches (whisper_tpu_torch/models/model.py) as they lie:
//   - float (a KVCache layer view): K and V (B, H, dh, T) in the query's
//     dtype;
//   - int8 (a QKVCache layer view): (B, H, 2, dh, T) int8, K at index 0 and
//     V at 1, with fp32 per-position scales (B, H, 2, T). Score columns scale
//     by s_k after q.k and weights by s_v before w.v, the math of
//     attention_int8kv_perpos.
// The offset is a per-row int64 array (the serving engine's slots) or one
// scalar argument (the pipeline's step), so the scalar case copies nothing
// from the host per step; pads is an optional per-row int64 array.
//
// What bounds it on the card: bytes. At turbo batch 64 with a 128-position
// cache the int8 layer view is 21 MB of payload and 1.3 MB of scales; the
// visible window of a 64-token decode averages ~36 of the 128 positions.
// The work is 4*dh fp32 operations per visible position and head.
//
// What the design does about it. The TPU kernel reads all of T and masks;
// here each block reads ONLY its row's visible window [lo, hi], so the bytes
// moved follow the decode's progress. One block of 128 threads per
// (batch, head):
//   - phase 1: thread i takes positions lo+i, lo+i+128, ... and walks the 64
//     K rows; a (dh, T) row is T contiguous elements, so a warp's 32 loads at
//     one row are adjacent addresses. Scores go to shared memory (T floats);
//   - phase 2: block max and sum in fp32, p = exp(s - max); the int8 cache's
//     V scales fold into the weights here;
//   - phase 3: warp w owns 16 of the 64 V rows; its lanes run over the
//     window (adjacent addresses again) with per-lane partial sums, reduced
//     across the warp once at the end.
// A window that is empty (pads[b] > offsets[b], or a negative offset) gets
// what the masked reference gives: every score is the same -1e30, so the
// weights are uniform over all T.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C interface, loaded with ctypes (whisper_tpu_torch/ops/decode_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = DH / WARPS;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// k, v: the (batch, head) rows are kv_stride elements apart; ks, vs: the
// per-position scales (QUANT only), s_stride floats apart.
template <typename Tq, typename Tc, bool QUANT>
__global__ void __launch_bounds__(THREADS)
self_decode_kernel(const Tq* __restrict__ q, const Tc* __restrict__ k,
                   const Tc* __restrict__ v, long long kv_stride,
                   const float* __restrict__ ks, const float* __restrict__ vs,
                   long long s_stride, Tq* __restrict__ out,
                   const long long* __restrict__ offsets,
                   const long long* __restrict__ pads, long long offset, int H,
                   int T, float scale) {
  extern __shared__ float sp[];  // the window's scores, then its weights
  __shared__ float sq[DH];
  __shared__ float red[WARPS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t bh = blockIdx.x;
  const int b = (int)(bh / H);
  long long hi = offsets ? offsets[b] : offset;
  long long lo = pads ? pads[b] : 0;
  if (hi > T - 1) hi = T - 1;
  if (lo < 0) lo = 0;
  const bool empty = hi < lo;
  if (empty) {
    lo = 0;
    hi = T - 1;
  }
  const int n = (int)(hi - lo + 1);
  const Tc* K = k + bh * kv_stride + lo;
  const Tc* V = v + bh * kv_stride + lo;
  const float* sk = QUANT ? ks + bh * s_stride + lo : nullptr;
  const float* sv = QUANT ? vs + bh * s_stride + lo : nullptr;

  if (tid < DH) sq[tid] = to_f32(q[bh * DH + tid]);
  __syncthreads();

  // phase 1: scores of the window
  float m = -INFINITY;
  for (int i = tid; i < n; i += THREADS) {
    float s = 0.f;
    if (!empty) {
#pragma unroll 16
      for (int d = 0; d < DH; ++d) s = fmaf(sq[d], to_f32(K[(size_t)d * T + i]), s);
      s = QUANT ? s * sk[i] * scale : s * scale;
    }
    sp[i] = s;
    m = fmaxf(m, s);
  }
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w]);
  __syncthreads();  // red is rewritten below

  // phase 2: weights (V scales folded in) and their denominator
  float l = 0.f;
  for (int i = tid; i < n; i += THREADS) {
    const float p = expf(sp[i] - m);
    l += p;
    sp[i] = QUANT ? p * sv[i] : p;
  }
  l = warp_sum(l);
  if (lane == 0) red[warp] = l;
  __syncthreads();  // sp and red complete
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) total += red[w];
  const float inv = 1.f / total;  // >= 1: the max position contributes exp(0)

  // phase 3: weighted V rows
  float acc[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) acc[r] = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float w = sp[i];
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r)
      acc[r] = fmaf(w, to_f32(V[(size_t)(warp * ROWS_PER_WARP + r) * T + i]), acc[r]);
  }
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const float sum = warp_sum(acc[r]);
    if (lane == 0) store(out + bh * DH + warp * ROWS_PER_WARP + r, sum * inv);
  }
}

template <typename Tq, typename Tc, bool QUANT>
int launch(const void* q, const void* k, const void* v, long long kv_stride,
           const void* ks, const void* vs, long long s_stride, void* out,
           const void* offsets, const void* pads, long long offset, int BH, int H,
           int T, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  self_decode_kernel<Tq, Tc, QUANT>
      <<<BH, THREADS, (size_t)T * sizeof(float), (cudaStream_t)stream>>>(
          (const Tq*)q, (const Tc*)k, (const Tc*)v, kv_stride, (const float*)ks,
          (const float*)vs, s_stride, (Tq*)out, (const long long*)offsets,
          (const long long*)pads, offset, H, T, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Float cache. q, out: (B*H, dh); k, v: (B*H, dh, T), all in the same dtype.
// offsets, pads: (B,) int64 or null (then every row attends to
// [0, offset]). Returns a cudaError_t.
extern "C" int self_attention_decode_bf16(const void* q, const void* k, const void* v,
                                          void* out, const void* offsets,
                                          const void* pads, long long offset, int BH,
                                          int H, int T, float scale, int device,
                                          void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16, false>(
      q, k, v, (long long)DH * T, nullptr, nullptr, 0, out, offsets, pads, offset, BH,
      H, T, scale, device, stream);
}

extern "C" int self_attention_decode_f32(const void* q, const void* k, const void* v,
                                         void* out, const void* offsets,
                                         const void* pads, long long offset, int BH,
                                         int H, int T, float scale, int device,
                                         void* stream) {
  return launch<float, float, false>(q, k, v, (long long)DH * T, nullptr, nullptr, 0,
                                     out, offsets, pads, offset, BH, H, T, scale,
                                     device, stream);
}

// Int8 cache. kvq: (B*H, 2, dh, T) int8; kvs: (B*H, 2, T) fp32; q, out:
// (B*H, dh) bf16 or fp32. offsets, pads as above.
extern "C" int self_attention_decode_int8_bf16(const void* q, const void* kvq,
                                               const void* kvs, void* out,
                                               const void* offsets, const void* pads,
                                               long long offset, int BH, int H, int T,
                                               float scale, int device, void* stream) {
  const int8_t* k = (const int8_t*)kvq;
  const float* s = (const float*)kvs;
  return launch<__nv_bfloat16, int8_t, true>(
      q, k, k + (size_t)DH * T, 2LL * DH * T, s, s + T, 2LL * T, out, offsets, pads,
      offset, BH, H, T, scale, device, stream);
}

extern "C" int self_attention_decode_int8_f32(const void* q, const void* kvq,
                                              const void* kvs, void* out,
                                              const void* offsets, const void* pads,
                                              long long offset, int BH, int H, int T,
                                              float scale, int device, void* stream) {
  const int8_t* k = (const int8_t*)kvq;
  const float* s = (const float*)kvs;
  return launch<float, int8_t, true>(q, k, k + (size_t)DH * T, 2LL * DH * T, s, s + T,
                                     2LL * T, out, offsets, pads, offset, BH, H, T,
                                     scale, device, stream);
}
