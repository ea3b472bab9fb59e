// Decode-step cross-attention against the int8 cross-KV through bf16
// operands on the tensor cores, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// whisper_tpu/ops/decode_attention.py:cross_attention_decode_dense
// (_dense_kernel): for one batch row, the H per-head matvecs q_h . K_h as
// ONE product of a block-diagonal query (qd[h, h*dh + d] = q[h, d] * k_s[h,
// d] * dh^-0.5, zero elsewhere) with all heads' K, an fp32 softmax over the
// whole T per head, the weights w = exp(s - max) / sum rounded to bf16, then
// V times the weights, of which each head keeps its own column. The
// operands are ALWAYS bf16, whatever the query's dtype (the scaled query,
// the int8 K and V, the normalised weights; bf16 x int8 products are exact
// in fp32), with fp32 accumulation; the V scales fold into the output,
// which takes the query's dtype.
//
// What bounds it on the card: bytes. The function needs 2*B*H*dh*T = 246 MB
// of int8 K/V at turbo batch 64 (0.073 ms at 3.35 TB/s); the dense form's
// redundant multiply-adds on the tensor cores cost less (0.0099 ms at the
// bf16 peak for the TPU kernel's H-fold redundancy).
//
// What the design does about it: one launch, K and V read once as int8,
// no scores in device memory.
//   - A CTA of 256 threads owns one head of one batch row and a slice of S
//     positions of T (S a multiple of 32); the C slices of T form a
//     thread-block cluster. C is the fewest slices (up to 8) whose CTA
//     leaves two CTAs an SM: one at turbo's T = 1500 (105 KB), more only
//     above T ~1,600. The probes (PERF.md) chose one head, 256 threads and
//     the fewest slices at B64 and at B8 alike: the cluster's exchanges cost
//     more than its extra CTAs bring.
//   - Each of the CTA's 64 K rows, then its 64 V rows, is one 1-D bulk copy
//     (cp.async.bulk, the TMA) of its slice, widened to 16-byte boundaries
//     (no row of T = 1500 starts 16-byte aligned, so 2-D TMA does not apply;
//     the widening adds at most 30 bytes a row). Each group of 16 rows
//     completes on its own mbarrier, so the scores of one group run while
//     the later groups are in flight. V is copied into K's rows as soon as
//     the scores are done, so a CTA holds one operand at a time (two CTAs an
//     SM, one's copies under the other's products) and V arrives during the
//     softmax. Rows are padded in shared memory to a stride of 16 mod 64
//     bytes, so the four row pairs a warp reads at once fall on distinct
//     banks.
//   - Scores: mma.sync.m16n8k16 bf16 with fp32 accumulation. The A operand
//     is the block-diagonal query over the CTA's head (its row 0, the only
//     nonzero one); the B operand is built in registers from the int8 tile:
//     a lane reads one 32-bit word (4 positions) of each of its 4 channel
//     rows, converts it with a byte permute and one subtract
//     (decode_common.cuh, no I2F) and packs bf16 pairs, and n-tile i of a
//     32-position block takes position 4n + i of column n, so each word
//     feeds four mma. The scores stay in shared memory (S fp32).
//   - Softmax over the WHOLE T: each CTA takes its slice's max m_c and sum
//     l_c of exp(s - m_c); with C > 1 the cluster exchanges them once
//     through distributed shared memory, and every CTA forms the same
//     m = max m_c, l = sum_c l_c exp(m_c - m) in rank order. Only then are
//     the weights formed, exp(s - m) / l with the global m and l, and
//     rounded to bf16: normalisation comes before the rounding, as in the
//     TPU kernel.
//   - V: the head needs only its own column of V W^T (the rest of the dense
//     product is what the diagonal discards), so no weight is formed for
//     another head's rows: a warp takes 16 V rows and dots them with the
//     weights in fp32 (converted as above), lanes along T. With C > 1 the
//     slices' partial outputs (64 fp32) are summed in rank order through
//     distributed shared memory; times v_s.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C interface, loaded with ctypes (whisper_tpu_torch/ops/decode_attention.py).

#include <cooperative_groups.h>
#include <math.h>

#include "decode_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace decode;
typedef __nv_bfloat16 bf16;

constexpr int DH = 64;               // channels of a head: K rows, and V rows, of a CTA
constexpr int NT = 256;              // threads a CTA
constexpr int W = NT / 32;           // warps a CTA
constexpr int GROUP_ROWS = 16;       // rows per mbarrier: one k-step of the scores
constexpr int GROUPS = DH / GROUP_ROWS;  // per operand
constexpr int P = W / GROUPS;        // warps sharing a V group along T
constexpr int MAX_CLUSTER = 8;       // the portable cluster size
constexpr int SMEM_LIMIT = 232448;   // a block's shared memory on sm_90
constexpr int STATIC_RESERVE = 4096;  // the kernel's static shared memory, rounded up
constexpr int TWO_PER_SM = 110 * 1024;  // dynamic shared memory that fits two CTAs an SM

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's first phase has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar))
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (16x8 fp32) += A (16x16 bf16, row) * B (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
  for (int w = 1; w < W; ++w) x = MAX ? fmaxf(x, red[w]) : x + red[w];
  __syncthreads();  // red is rewritten by the next reduction
  return x;
}

// Bytes from the 16-byte boundary below a row's slice to its first position.
__device__ __forceinline__ uint32_t lead(size_t row, int T, int t0) {
  return (uint32_t)(((size_t)row * T + t0) & 15);
}

// Grid: (B * H) clusters of C CTAs; CTA `rank` of a cluster takes positions
// [rank * S, min((rank + 1) * S, T)) of one (batch, head). Dynamic shared
// memory: 64 rows of K, later of V (stride RS bytes) | the scores, later
// the weights, S fp32.
template <typename Tq>
__global__ void __launch_bounds__(NT)
dense_kernel(const Tq* __restrict__ q, const int8_t* __restrict__ kq,
             const float* __restrict__ ks, const int8_t* __restrict__ vq,
             const float* __restrict__ vs, Tq* __restrict__ out, int T, int S, int RS,
             float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[2 * GROUPS];
  __shared__ __align__(16) uint32_t sQ[DH / 2];  // the scaled query, bf16 pairs
  __shared__ float red[W];
  __shared__ float stat[2];                      // this slice's max and sum
  __shared__ float part[P][DH];                  // V partials of the warps of a group
  __shared__ float sO[DH];                       // this slice's output partial

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;  // mma groupID / thread-in-group
  const size_t row0 = (size_t)(blockIdx.x / C) * DH;  // first (head, channel) row
  const int t0 = min(rank * S, T), n = min(t0 + S, T) - t0;  // this slice
  unsigned char* sK = smem;  // K's rows, then V's
  float* sS = reinterpret_cast<float*>(smem + (size_t)DH * RS);

  if (tid == 0) {
    for (int j = 0; j < 2 * GROUPS; ++j) mbar_init(&bar[j], GROUP_ROWS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // one bulk copy a row: K rows r < DH (groups 0..GROUPS-1), then V rows
  auto issue = [&](int r) {
    const bool is_k = r < DH;
    const int rr = is_k ? r : r - DH;
    const size_t row = row0 + rr;
    const size_t first = row * T + t0 - lead(row, T, t0);
    const uint32_t bytes = n ? (uint32_t)(((row * T + t0 + n + 15) & ~(size_t)15) - first) : 0;
    mbar_expect_tx(&bar[r / GROUP_ROWS], bytes);
    if (bytes)
      bulk_load(sK + (size_t)rr * RS, (is_k ? kq : vq) + first, bytes, &bar[r / GROUP_ROWS]);
  };
  if (tid < DH) issue(tid);
  // the scaled query, rounded to bf16 as the TPU kernel's operand
  if (tid < DH / 2) {
    const size_t i = row0 + 2 * tid;
    sQ[tid] = pack_bf16(to_f32(q[i]) * ks[i] * scale, to_f32(q[i + 1]) * ks[i + 1] * scale);
  }
  __syncthreads();

  // ---- scores of 32-position blocks: n-tile i holds position 4 col + i;
  // lane (g, tg) reads channels 2tg, 2tg+1, 2tg+8, 2tg+9 of each k-step
  uint32_t koff[GROUPS][4];
#pragma unroll
  for (int kk = 0; kk < GROUPS; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = kk * GROUP_ROWS + 2 * tg + (j & 1) + (j >> 1) * 8;
      koff[kk][j] = (uint32_t)c * RS + lead(row0 + c, T, t0) + 4 * g;
    }
  const int n_blocks = (n + 31) / 32;
  for (int blk = warp; blk < n_blocks; blk += W) {
    const int p0 = 32 * blk;
    float acc[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < GROUPS; ++kk) {
      mbar_wait(&bar[kk]);
      // A: row 0 holds the query's 16 channels of this k-step, rows 1-15 zero
      const uint32_t a[4] = {g == 0 ? sQ[kk * 8 + tg] : 0u, 0u,
                             g == 0 ? sQ[kk * 8 + tg + 4] : 0u, 0u};
      float4 f[4];  // the four channels at positions 4g..4g+3 of the block
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[j] = s8x4_to_f32(*reinterpret_cast<const uint32_t*>(sK + koff[kk][j] + p0));
      mma_bf16(acc[0], a, pack_bf16(f[0].x, f[1].x), pack_bf16(f[2].x, f[3].x));
      mma_bf16(acc[1], a, pack_bf16(f[0].y, f[1].y), pack_bf16(f[2].y, f[3].y));
      mma_bf16(acc[2], a, pack_bf16(f[0].z, f[1].z), pack_bf16(f[2].z, f[3].z));
      mma_bf16(acc[3], a, pack_bf16(f[0].w, f[1].w), pack_bf16(f[2].w, f[3].w));
    }
    // D[0][col 2tg (+1)] of n-tile i is position p0 + 8tg (+4) + i
    if (g == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + 8 * tg + i;
        if (p < n) sS[p] = acc[i][0];
        if (p + 4 < n) sS[p + 4] = acc[i][1];
      }
  }
  __syncthreads();
  // V into K's rows, now read
  if (tid < DH) issue(DH + tid);

  // ---- softmax over the whole T: the slice's max and sum, then the cluster's
  float m = -INFINITY, l = 0.f;
  for (int t = tid; t < n; t += NT) m = fmaxf(m, sS[t]);
  m = block_reduce<true>(m, red);
  for (int t = tid; t < n; t += NT) l += expf(sS[t] - m);
  l = block_reduce<false>(l, red);
  if (C > 1) {
    if (tid == 0) {
      stat[0] = m;
      stat[1] = l;
    }
    cluster.sync();  // every slice's statistics are written
    float M = -INFINITY, L = 0.f;
    for (int c = 0; c < C; ++c) M = fmaxf(M, cluster.map_shared_rank(&stat[0], c)[0]);
    for (int c = 0; c < C; ++c)  // rank order: every CTA gets the same bits
      L += cluster.map_shared_rank(&stat[1], c)[0] *
           expf(cluster.map_shared_rank(&stat[0], c)[0] - M);
    m = M;
    l = L;
  }
  // the weights, normalised by the whole T's max and sum, then rounded to bf16
  for (int t = tid; t < n; t += NT)
    sS[t] = __bfloat162float(__float2bfloat16(expf(sS[t] - m) / l));
  __syncthreads();

  // ---- V: warp u dots the 16 rows of group u / P with the weights, lanes
  // along T (part u % P of the P warps sharing the group takes every P-th word)
  const int nq = n / 4;  // words of a row; T % 4 == 0 and S % 32 == 0
  {
    const int j = warp / P, p = warp % P;
    mbar_wait(&bar[GROUPS + j]);
    uint32_t off[GROUP_ROWS];
    float acc[GROUP_ROWS];
#pragma unroll
    for (int rr = 0; rr < GROUP_ROWS; ++rr) {
      const int r = j * GROUP_ROWS + rr;
      off[rr] = (uint32_t)r * RS + lead(row0 + r, T, t0);
      acc[rr] = 0.f;
    }
    const float4* w4 = reinterpret_cast<const float4*>(sS);
    for (int k = p * 32 + lane; k < nq; k += 32 * P) {
      const float4 wk = w4[k];
#pragma unroll
      for (int rr = 0; rr < GROUP_ROWS; ++rr)
        acc[rr] = dot4(wk, *reinterpret_cast<const uint32_t*>(sK + off[rr] + 4 * k), acc[rr]);
    }
#pragma unroll
    for (int rr = 0; rr < GROUP_ROWS; ++rr) {
      const float a = warp_sum(acc[rr]);
      if (lane == 0) part[p][j * GROUP_ROWS + rr] = a;
    }
  }
  __syncthreads();
  if (tid < DH) {
    float o = part[0][tid];
#pragma unroll
    for (int p = 1; p < P; ++p) o += part[p][tid];
    sO[tid] = o;
  }
  if (C == 1) {
    if (tid < DH) store(out + row0 + tid, sO[tid] * vs[row0 + tid]);
    return;
  }
  // the slices' partial outputs, summed in rank order; CTA `rank` stores
  // the rows i with i % C == rank
  cluster.sync();
  for (int i = rank + C * tid; i < DH; i += C * NT) {
    float o = cluster.map_shared_rank(sO, 0)[i];
    for (int c = 1; c < C; ++c) o += cluster.map_shared_rank(sO, c)[i];
    store(out + row0 + i, o * vs[row0 + i]);
  }
  cluster.sync();  // no peer still reads this CTA's shared memory
}

// positions per CTA for a cluster of C, and the padded row stride (bytes):
// at least the slice plus 30 bytes of widening, 16 mod 64
inline int slice(int T, int C) { return ((T + C - 1) / C + 31) / 32 * 32; }
inline int row_stride(int S) { return (S + 30 + 63) / 64 * 64 + 16; }
inline size_t smem_bytes(int S) { return (size_t)DH * row_stride(S) + (size_t)S * 4; }

template <typename Tq>
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           void* out, int B, int H, int T, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H < 1 || T < 4 || T % 4 ||
      (reinterpret_cast<uintptr_t>(kq) | reinterpret_cast<uintptr_t>(vq)) % 16)
    return (int)cudaErrorInvalidValue;
  // the fewest slices of T that leave two CTAs an SM (T = 1500: one, 105 KB)
  int C = 1;
  while (C < MAX_CLUSTER && smem_bytes(slice(T, C)) > TWO_PER_SM) C *= 2;
  const int S = slice(T, C);
  const size_t smem = smem_bytes(S);
  if (smem > SMEM_LIMIT - STATIC_RESERVE) return (int)cudaErrorInvalidValue;
  auto kernel = dense_kernel<Tq>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * H * C));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const Tq*)q, (const int8_t*)kq, (const float*)ks,
                           (const int8_t*)vq, (const float*)vs, (Tq*)out, T, S, row_stride(S),
                           scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B, H, dh) in the query's dtype; kq, vq: (B, H*dh, T) int8,
// 16-byte aligned, T % 4 == 0; ks, vs: (B, H, dh) fp32. One launch on
// ``stream``. Returns a cudaError_t.
extern "C" int cross_attention_decode_dense_bf16(const void* q, const void* kq,
                                                 const void* ks, const void* vq,
                                                 const void* vs, void* out, int B, int H,
                                                 int T, float scale, int device, void* stream) {
  return launch<bf16>(q, kq, ks, vq, vs, out, B, H, T, scale, device, stream);
}

extern "C" int cross_attention_decode_dense_f32(const void* q, const void* kq,
                                                const void* ks, const void* vq,
                                                const void* vs, void* out, int B, int H,
                                                int T, float scale, int device, void* stream) {
  return launch<float>(q, kq, ks, vq, vs, out, B, H, T, scale, device, stream);
}
