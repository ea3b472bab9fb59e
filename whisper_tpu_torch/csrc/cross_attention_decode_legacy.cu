// Head-batched decode-step cross-attention against the int8 cross-KV, one
// pass over the whole audio axis, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// whisper_tpu/ops/decode_attention.py:cross_attention_decode (_kernel, and
// _kernel_vpu for use_vpu=True): one query per (batch, head) against K and V
// stored int8 and TRANSPOSED, (B, H, dh, T), with fp32 per-channel scales
// (B, H, 1, dh). The K scales and dh^-0.5 fold into the query, the V scales
// into the output; the softmax is taken over the WHOLE of T at once (no
// online rescaling, which is what sets it apart from the flash-decode kernel
// in cross_attention_decode.cu), and the normalised weights multiply V.
//   - _kernel (use_vpu=False, the form the JAX model runs): the scaled query
//     and the normalised weights are rounded to the query's dtype before the
//     two products, which accumulate in fp32. For an fp32 query nothing is
//     rounded.
//   - _kernel_vpu (use_vpu=True): everything in fp32.
// Both are one template, instantiated with and without the roundings.
//
// What bounds it on the card: bytes. At turbo batch 64 one launch streams
// 2*B*H*dh*T = 246 MB of int8 K/V for 0.5 GFLOP of fp32 work.
//
// What the design does about it. The TPU program holds all heads of a batch
// row (halving the group while K+V exceed 8 MB of VMEM) because a grid step
// per (batch, head) cost more than the work. Blocks on the card are
// scheduled by the hardware, so the head group here is the smallest one, a
// single head: 1,280 blocks at B64 against 132 SMs, and what shared memory
// must hold is one head's T fp32 scores (6 KB at T = 1500):
//   - scores: thread i owns positions 4i..4i+3 of each 512-position stride
//     and walks the 64 K rows, so each warp load is 128 contiguous bytes of
//     one row. A row of (dh, T) int8 is T = 1500 bytes: 4-byte aligned, not
//     16-byte aligned, hence char4 loads along T (the wrapper requires
//     T % 4 == 0). The scores go to shared memory, with the block's max;
//   - the exponentials overwrite the scores in place, with the block's sum;
//   - weighted V: warp w owns 16 V rows; its lanes read 128 contiguous bytes
//     of a row per load, multiply by the normalised weights and keep
//     per-lane partial sums, reduced across the warp once at the end.
// K and V are each read once.
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
constexpr int STRIDE = 4 * THREADS;  // positions per pass of the block
constexpr int ROWS_PER_WARP = DH / WARPS;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// x rounded to the compute dtype Tq (and back to fp32 for the product)
template <typename Tq> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

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

template <typename Tq, bool kRound>
__global__ void __launch_bounds__(THREADS)
legacy_kernel(const Tq* __restrict__ q, const int8_t* __restrict__ kq,
              const float* __restrict__ ks, const int8_t* __restrict__ vq,
              const float* __restrict__ vs, Tq* __restrict__ out, int T, float scale) {
  extern __shared__ __align__(16) float sp[];  // T scores, then their exponentials
  __shared__ float sq[DH];
  __shared__ float red_max[WARPS], red_sum[WARPS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t bh = blockIdx.x;
  const int8_t* K = kq + bh * DH * (size_t)T;
  const int8_t* V = vq + bh * DH * (size_t)T;

  if (tid < DH) {
    const float x = to_f32(q[bh * DH + tid]) * ks[bh * DH + tid] * scale;
    sq[tid] = kRound ? round_to<Tq>(x) : x;
  }
  __syncthreads();

  // 1. the scores of the whole T, K read once
  float mx = -INFINITY;
  for (int p0 = 4 * tid; p0 < T; p0 += STRIDE) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 16
    for (int d = 0; d < DH; ++d) {
      const char4 kv = *reinterpret_cast<const char4*>(K + (size_t)d * T + p0);
      const float qd = sq[d];
      s0 = fmaf(qd, (float)kv.x, s0);
      s1 = fmaf(qd, (float)kv.y, s1);
      s2 = fmaf(qd, (float)kv.z, s2);
      s3 = fmaf(qd, (float)kv.w, s3);
    }
    *reinterpret_cast<float4*>(sp + p0) = make_float4(s0, s1, s2, s3);
    mx = fmaxf(mx, fmaxf(fmaxf(s0, s1), fmaxf(s2, s3)));
  }
  mx = warp_max(mx);
  if (lane == 0) red_max[warp] = mx;
  __syncthreads();
  mx = red_max[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, red_max[w]);

  // 2. exponentials in place, and their sum over the whole T (each thread
  //    rewrites only the positions it wrote)
  float sum = 0.f;
  for (int p0 = 4 * tid; p0 < T; p0 += STRIDE) {
    float4 s = *reinterpret_cast<const float4*>(sp + p0);
    s.x = expf(s.x - mx);
    s.y = expf(s.y - mx);
    s.z = expf(s.z - mx);
    s.w = expf(s.w - mx);
    *reinterpret_cast<float4*>(sp + p0) = s;
    sum += (s.x + s.y) + (s.z + s.w);
  }
  sum = warp_sum(sum);
  if (lane == 0) red_sum[warp] = sum;
  __syncthreads();  // sp and red_sum complete
  float l = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) l += red_sum[w];

  // 3. weighted V rows with the normalised weights, V read once
  float acc[ROWS_PER_WARP];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) acc[r] = 0.f;
  const int8_t* Vw = V + (size_t)warp * ROWS_PER_WARP * T;
  for (int off = 4 * lane; off < T; off += 128) {
    const float4 e = *reinterpret_cast<const float4*>(sp + off);
    float w0 = e.x / l, w1 = e.y / l, w2 = e.z / l, w3 = e.w / l;
    if (kRound) {
      w0 = round_to<Tq>(w0);
      w1 = round_to<Tq>(w1);
      w2 = round_to<Tq>(w2);
      w3 = round_to<Tq>(w3);
    }
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) {
      const char4 vv = *reinterpret_cast<const char4*>(Vw + (size_t)r * T + off);
      acc[r] = fmaf(w0, (float)vv.x, acc[r]);
      acc[r] = fmaf(w1, (float)vv.y, acc[r]);
      acc[r] = fmaf(w2, (float)vv.z, acc[r]);
      acc[r] = fmaf(w3, (float)vv.w, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const float total = warp_sum(acc[r]);
    if (lane == 0) {
      const int d = warp * ROWS_PER_WARP + r;
      store(out + bh * DH + d, total * vs[bh * DH + d]);
    }
  }
}

template <typename Tq>
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           void* out, int BH, int T, float scale, int use_vpu, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = sizeof(float) * (size_t)T;
  if (use_vpu)
    legacy_kernel<Tq, false><<<BH, THREADS, smem, (cudaStream_t)stream>>>(
        (const Tq*)q, (const int8_t*)kq, (const float*)ks, (const int8_t*)vq,
        (const float*)vs, (Tq*)out, T, scale);
  else
    legacy_kernel<Tq, true><<<BH, THREADS, smem, (cudaStream_t)stream>>>(
        (const Tq*)q, (const int8_t*)kq, (const float*)ks, (const int8_t*)vq,
        (const float*)vs, (Tq*)out, T, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B*H, dh) in the compute dtype; kq, vq: (B*H, dh, T) int8;
// ks, vs: (B*H, dh) fp32; T % 4 == 0 and T * 4 bytes <= 48 KB.
// use_vpu != 0: all fp32 (_kernel_vpu); 0: the roundings of _kernel.
// Returns a cudaError_t.
extern "C" int cross_attention_decode_legacy_bf16(const void* q, const void* kq,
                                                  const void* ks, const void* vq,
                                                  const void* vs, void* out, int BH, int T,
                                                  float scale, int use_vpu, int device,
                                                  void* stream) {
  return launch<__nv_bfloat16>(q, kq, ks, vq, vs, out, BH, T, scale, use_vpu, device, stream);
}

extern "C" int cross_attention_decode_legacy_f32(const void* q, const void* kq,
                                                 const void* ks, const void* vq,
                                                 const void* vs, void* out, int BH, int T,
                                                 float scale, int use_vpu, int device,
                                                 void* stream) {
  return launch<float>(q, kq, ks, vq, vs, out, BH, T, scale, use_vpu, device, stream);
}
