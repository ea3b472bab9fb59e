// Decode-step cross-attention against the int8 cross-KV, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// whisper_tpu/ops/decode_attention.py:cross_attention_decode_fd (_fd_kernel):
// one query per (batch, head) against K and V stored int8 and TRANSPOSED,
// (B, H, dh, T), with fp32 per-channel scales (B, H, 1, dh). The K scales and
// dh^-0.5 fold into the query, the V scales into the output, and the softmax
// is an online one over tiles of T, all in fp32.
//
// What bounds it on the card: bytes. At turbo batch 64 one launch streams
// 2*B*H*dh*T = 246 MB of int8 K/V for 0.5 GFLOP of fp32 work.
//
// What the design does about it. The TPU grid is (B, nT) with T innermost
// and sequential, carrying max/denominator/accumulator in VMEM scratch from
// one T tile to the next. Blocks on the card carry nothing between them, so
// here one block per (batch, head) (1,280 blocks at B64, against 132 SMs)
// loops over T tiles of 512 positions itself, with the running state in
// registers:
//   - scores: thread i owns positions 4i..4i+3 of the tile and walks the 64
//     K rows, so each warp load is 128 contiguous bytes of one row. A row of
//     (dh, T) int8 is T = 1500 bytes: 4-byte aligned, not 16-byte aligned,
//     hence char4 loads along T (the wrapper requires T % 4 == 0);
//   - weighted V: warp w owns 16 V rows; its lanes read 128 contiguous bytes
//     of a row per load and keep per-lane partial sums, reduced across the
//     warp once at the end (rescaling a partial sum by the softmax
//     correction is linear, so it needs no per-tile reduction);
//   - the tile's probabilities go through 2 KB of shared memory between the
//     two phases.
// Split-T across blocks with a combine pass is later work.
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
constexpr int TILE = 4 * THREADS;       // positions per tile
constexpr int ROWS_PER_WARP = DH / WARPS;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
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

template <typename Tq>
__global__ void __launch_bounds__(THREADS)
fd_kernel(const Tq* __restrict__ q, const int8_t* __restrict__ kq,
          const float* __restrict__ ks, const int8_t* __restrict__ vq,
          const float* __restrict__ vs, Tq* __restrict__ out, int T, float scale) {
  __shared__ float sq[DH];
  __shared__ __align__(16) float sp[TILE];
  __shared__ float red_max[WARPS], red_sum[WARPS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t bh = blockIdx.x;
  const int8_t* K = kq + bh * DH * (size_t)T;
  const int8_t* V = vq + bh * DH * (size_t)T;

  if (tid < DH) sq[tid] = to_f32(q[bh * DH + tid]) * ks[bh * DH + tid] * scale;
  __syncthreads();

  float m = -INFINITY, l = 0.f;  // running max / denominator (block-uniform)
  float acc[ROWS_PER_WARP];      // this lane's partial sums of its warp's V rows
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) acc[r] = 0.f;

  for (int t0 = 0; t0 < T; t0 += TILE) {
    // scores for positions p0..p0+3 (T % 4 == 0: a char4 is all in or all out)
    const int p0 = t0 + 4 * tid;
    float s[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    if (p0 < T) {
      s[0] = s[1] = s[2] = s[3] = 0.f;
#pragma unroll 16
      for (int d = 0; d < DH; ++d) {
        const char4 kv = *reinterpret_cast<const char4*>(K + (size_t)d * T + p0);
        const float qd = sq[d];
        s[0] = fmaf(qd, (float)kv.x, s[0]);
        s[1] = fmaf(qd, (float)kv.y, s[1]);
        s[2] = fmaf(qd, (float)kv.z, s[2]);
        s[3] = fmaf(qd, (float)kv.w, s[3]);
      }
    }
    float tmax = warp_max(fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3])));
    if (lane == 0) red_max[warp] = tmax;
    __syncthreads();
    tmax = red_max[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) tmax = fmaxf(tmax, red_max[w]);
    // the tile starts below T, so tmax is finite
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float p[4], psum = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = expf(s[i] - m_new);
      psum += p[i];
    }
    *reinterpret_cast<float4*>(sp + 4 * tid) = make_float4(p[0], p[1], p[2], p[3]);
    psum = warp_sum(psum);
    if (lane == 0) red_sum[warp] = psum;
    __syncthreads();  // sp and red_sum complete
    float tsum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) tsum += red_sum[w];
    l = l * corr + tsum;
    m = m_new;

    // weighted V rows: lane covers positions 4*lane + 128*j of the tile
#pragma unroll
    for (int r = 0; r < ROWS_PER_WARP; ++r) acc[r] *= corr;
#pragma unroll
    for (int j = 0; j < TILE / 128; ++j) {
      const int off = 4 * lane + 128 * j;
      if (t0 + off < T) {
        const float4 pv = *reinterpret_cast<const float4*>(sp + off);
#pragma unroll
        for (int r = 0; r < ROWS_PER_WARP; ++r) {
          const char4 vv = *reinterpret_cast<const char4*>(
              V + (size_t)(warp * ROWS_PER_WARP + r) * T + t0 + off);
          acc[r] = fmaf(pv.x, (float)vv.x, acc[r]);
          acc[r] = fmaf(pv.y, (float)vv.y, acc[r]);
          acc[r] = fmaf(pv.z, (float)vv.z, acc[r]);
          acc[r] = fmaf(pv.w, (float)vv.w, acc[r]);
        }
      }
    }
    __syncthreads();  // sp, red_max and red_sum are rewritten by the next tile
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const float total = warp_sum(acc[r]);
    if (lane == 0) {
      const int d = warp * ROWS_PER_WARP + r;
      store(out + bh * DH + d, total * inv * vs[bh * DH + d]);
    }
  }
}

template <typename Tq>
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, void* out, int BH, int T, float scale, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  fd_kernel<Tq><<<BH, THREADS, 0, (cudaStream_t)stream>>>(
      (const Tq*)q, (const int8_t*)kq, (const float*)ks, (const int8_t*)vq,
      (const float*)vs, (Tq*)out, T, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B*H, dh) in the compute dtype; kq, vq: (B*H, dh, T) int8;
// ks, vs: (B*H, dh) fp32. Returns a cudaError_t.
extern "C" int cross_attention_decode_fd_bf16(const void* q, const void* kq,
                                              const void* ks, const void* vq,
                                              const void* vs, void* out, int BH,
                                              int T, float scale, int device,
                                              void* stream) {
  return launch<__nv_bfloat16>(q, kq, ks, vq, vs, out, BH, T, scale, device, stream);
}

extern "C" int cross_attention_decode_fd_f32(const void* q, const void* kq,
                                             const void* ks, const void* vq,
                                             const void* vs, void* out, int BH,
                                             int T, float scale, int device,
                                             void* stream) {
  return launch<float>(q, kq, ks, vq, vs, out, BH, T, scale, device, stream);
}
