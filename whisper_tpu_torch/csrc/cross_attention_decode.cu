// Decode-step cross-attention against the int8 cross-KV, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// whisper_tpu/ops/decode_attention.py:cross_attention_decode_fd (_fd_kernel):
// one query per (batch, head) against K and V stored int8 and TRANSPOSED,
// (B, H, dh, T), with fp32 per-channel scales (B, H, 1, dh). The K scales and
// dh^-0.5 fold into the query, the V scales into the output, and the softmax
// runs over the whole T in fp32.
//
// What bounds it on the card: bytes. At turbo batch 64 one launch streams
// 2*B*H*dh*T = 246 MB of int8 K/V for 0.5 GFLOP of fp32 work.
//
// What the design does about it:
//   - A thread-block cluster of four CTAs takes one (batch, head); CTA c owns
//     K and V rows 16c..16c+15. Any 4 consecutive rows of a (dh, T) slab are
//     4T contiguous bytes starting at a multiple of 16 (T % 4 == 0, the slab
//     16-byte aligned), though no single row of T = 1500 is: so one 1-D bulk
//     copy (cp.async.bulk, the TMA) with an mbarrier moves a 4-row group,
//     and one thread issues all eight of a CTA's groups (four of K, four of
//     V) at the start. V's bytes are in flight while the scores run. The
//     grid is 4*B*H CTAs: 5,120 at B64, 640 at B8.
//   - Each CTA forms partial scores over all of T for its 16 K rows. After
//     one cluster barrier every CTA sums the four partials, in rank order,
//     through distributed shared memory, so all four hold the same full
//     scores (in K group 0's buffer, free by then), and runs an exact
//     two-pass fp32 softmax over the whole T itself: one cluster barrier,
//     no exchange of maxima or sums, no online rescaling, no combine pass.
//     Each CTA then forms its 16 outputs from its own V rows.
//   - int8 -> fp32 by a byte permute into 2^23's mantissa and one subtract
//     (decode_common.cuh), not I2F.
//   - Where 8 groups and the scores do not fit the 227 KB of shared memory
//     (T above 6,428) the groups stream through a ring of as many stages as
//     fit beside a second score array, each refilled once its group is
//     consumed.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C interface, loaded with ctypes (whisper_tpu_torch/ops/decode_attention.py).

#include <cooperative_groups.h>
#include <math.h>

#include "decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace decode;

constexpr int DH = 64;
constexpr int CLUSTER = 4;
constexpr int ROWS = DH / CLUSTER;       // K rows and V rows per CTA
constexpr int GROUP_ROWS = 4;            // rows per bulk copy
constexpr int K_GROUPS = ROWS / GROUP_ROWS;
constexpr int GROUPS = 2 * K_GROUPS;     // K groups first, then V groups
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_LIMIT = 232448;       // a block's shared memory on sm_90
constexpr int STATIC_RESERVE = 1024;     // the kernel's static shared memory, rounded up

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from 16-byte aligned global memory into this
// CTA's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// acc + w . (the four int8 values in k), elementwise
__device__ __forceinline__ float4 fma4(float w, uint32_t k, float4 acc) {
  const float4 f = s8x4_to_f32(k);
  return make_float4(fmaf(w, f.x, acc.x), fmaf(w, f.y, acc.y), fmaf(w, f.z, acc.z),
                     fmaf(w, f.w, acc.w));
}

// acc + p . (the four int8 values in v), a dot product
__device__ __forceinline__ float dot4(float4 p, uint32_t v, float acc) {
  const float4 f = s8x4_to_f32(v);
  return fmaf(p.w, f.w, fmaf(p.z, f.z, fmaf(p.y, f.y, fmaf(p.x, f.x, acc))));
}

// Block-wide max (MAX) or sum of x; every thread gets the result.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  x = MAX ? warp_max(x) : warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) x = MAX ? fmaxf(x, red[w]) : x + red[w];
  __syncthreads();  // red is rewritten by the next reduction
  return x;
}

template <typename Tq>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
fd_kernel(const Tq* __restrict__ q, const int8_t* __restrict__ kq,
          const float* __restrict__ ks, const int8_t* __restrict__ vq,
          const float* __restrict__ vs, Tq* __restrict__ out, int T, int stages,
          float scale) {
  // dynamic: `stages` group buffers of 4T bytes, then the T scores (fp32)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[GROUPS];
  __shared__ float sq[ROWS];
  __shared__ float red[WARPS];
  __shared__ float red_rows[WARPS][ROWS];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t bh = blockIdx.x / CLUSTER;
  const size_t row0 = bh * DH + (size_t)rank * ROWS;  // this CTA's first K/V row
  const uint32_t group_bytes = GROUP_ROWS * T;
  float4* sp = reinterpret_cast<float4*>(smem + (size_t)stages * group_bytes);

  auto issue = [&](int g) {
    const int s = g % stages;
    const int8_t* src = (g < K_GROUPS ? kq : vq) +
                        (row0 + (size_t)(g % K_GROUPS) * GROUP_ROWS) * (size_t)T;
    mbar_expect_tx(&bar[s], group_bytes);
    bulk_load(smem + (size_t)s * group_bytes, src, group_bytes, &bar[s]);
  };
  auto group = [&](int g) -> const unsigned char* {
    const int s = g % stages;
    mbar_wait(&bar[s], (uint32_t)(g / stages) & 1);
    return smem + (size_t)s * group_bytes;
  };
  // after group g is consumed: refill its stage with group g + stages
  auto refill = [&](int g) {
    if (g + stages < GROUPS) {
      __syncthreads();
      if (tid == 0) issue(g + stages);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int g = 0; g < stages && g < GROUPS; ++g) issue(g);
  }
  if (tid < ROWS) sq[tid] = to_f32(q[row0 + tid]) * ks[row0 + tid] * scale;
  __syncthreads();

  // partial scores of this CTA's 16 K rows; thread i owns positions 4i..4i+3
  const int nq = T / 4;
#pragma unroll
  for (int g = 0; g < K_GROUPS; ++g) {
    const unsigned char* kg = group(g);
    const float q0 = sq[4 * g], q1 = sq[4 * g + 1], q2 = sq[4 * g + 2], q3 = sq[4 * g + 3];
    for (int i = tid; i < nq; i += THREADS) {
      const uint32_t* k = reinterpret_cast<const uint32_t*>(kg) + i;
      float4 s = g == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : sp[i];
      s = fma4(q0, k[0], s);
      s = fma4(q1, k[nq], s);
      s = fma4(q2, k[2 * nq], s);
      s = fma4(q3, k[3 * nq], s);
      sp[i] = s;
    }
    refill(g);
  }

  // the full scores: the four partials summed in rank order (every CTA of
  // the cluster gets the same bits), into the buffer of K group 0, free once
  // the K groups are consumed, or past the partials where the ring reuses it
  float4* sf = stages >= GROUPS ? reinterpret_cast<float4*>(smem) : sp + nq;
  cluster.sync();  // every partial is complete
  float m = -INFINITY;
  for (int i = tid; i < nq; i += THREADS) {
    float4 s = cluster.map_shared_rank(sp, 0)[i];
#pragma unroll
    for (int c = 1; c < CLUSTER; ++c) s = add4(s, cluster.map_shared_rank(sp, c)[i]);
    sf[i] = s;
    m = fmaxf(m, fmaxf(fmaxf(s.x, s.y), fmaxf(s.z, s.w)));
  }
  cluster_arrive();  // this CTA reads no peer's shared memory after here
  m = block_reduce<true>(m, red);  // finite: T >= 4
  float l = 0.f;
  for (int i = tid; i < nq; i += THREADS) {
    const float4 s = sf[i];
    const float4 p = make_float4(expf(s.x - m), expf(s.y - m), expf(s.z - m), expf(s.w - m));
    sf[i] = p;
    l += (p.x + p.y) + (p.z + p.w);
  }
  l = block_reduce<false>(l, red);  // its barriers also publish sf

  // weighted sums of this CTA's 16 V rows
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
#pragma unroll
  for (int g = K_GROUPS; g < GROUPS; ++g) {
    const unsigned char* vg = group(g);
    for (int i = tid; i < nq; i += THREADS) {
      const uint32_t* v = reinterpret_cast<const uint32_t*>(vg) + i;
      const float4 p = sf[i];
#pragma unroll
      for (int r = 0; r < GROUP_ROWS; ++r) {
        float& a = acc[(g - K_GROUPS) * GROUP_ROWS + r];
        a = dot4(p, v[r * nq], a);
      }
    }
    refill(g);
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float a = warp_sum(acc[r]);
    if (lane == 0) red_rows[warp][r] = a;
  }
  __syncthreads();
  if (tid < ROWS) {
    float total = red_rows[0][tid];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) total += red_rows[w][tid];
    store(out + row0 + tid, total / l * vs[row0 + tid]);
  }
  cluster_wait();  // no peer still reads this CTA's partial scores
}

template <typename Tq>
int launch(const void* q, const void* kq, const void* ks, const void* vq,
           const void* vs, void* out, int BH, int T, float scale, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (T < 4 || T % 4 || (reinterpret_cast<uintptr_t>(kq) | reinterpret_cast<uintptr_t>(vq)) % 16)
    return (int)cudaErrorInvalidValue;
  // all eight groups and the partial scores, the full scores in group 0's
  // buffer; else a ring of as many stages as fit beside both score arrays
  const size_t group_bytes = (size_t)GROUP_ROWS * T, score_bytes = 4 * (size_t)T;
  const size_t avail = SMEM_LIMIT - STATIC_RESERVE;
  size_t stages = GROUPS, smem = GROUPS * group_bytes + score_bytes;
  if (smem > avail) {
    if (2 * score_bytes + group_bytes > avail) return (int)cudaErrorInvalidValue;
    stages = (avail - 2 * score_bytes) / group_bytes;
    smem = stages * group_bytes + 2 * score_bytes;
  }
  err = cudaFuncSetAttribute(fd_kernel<Tq>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)avail);
  if (err != cudaSuccess) return (int)err;
  fd_kernel<Tq><<<BH * CLUSTER, THREADS, smem, (cudaStream_t)stream>>>(
      (const Tq*)q, (const int8_t*)kq, (const float*)ks, (const int8_t*)vq,
      (const float*)vs, (Tq*)out, T, (int)stages, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B*H, dh) in the compute dtype; kq, vq: (B*H, dh, T) int8, 16-byte
// aligned, T % 4 == 0; ks, vs: (B*H, dh) fp32. Returns a cudaError_t.
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
