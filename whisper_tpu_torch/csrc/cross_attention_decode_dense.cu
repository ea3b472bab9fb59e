// Decode-step cross-attention against the int8 cross-KV as two dense
// tensor-core products over a block-diagonal query, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// whisper_tpu/ops/decode_attention.py:cross_attention_decode_dense
// (_dense_kernel): for one batch row, the H per-head matvecs q_h . K_h become
// ONE (H, H*dh) @ (H*dh, T) product against a block-diagonal query
// (qd[h, h*dh + d] = q[h, d] * k_s[h, d] * dh^-0.5, zero elsewhere), an fp32
// softmax over T per row, then the (H*dh, T) @ (T, H) product of V with the
// weights, of which each head keeps its own column (the diagonal). The
// operands are ALWAYS bf16, whatever the query's dtype (the scaled query,
// the int8 K and V, the normalised weights), with fp32 accumulation; the V
// scales fold into the output, which takes the query's dtype.
//
// What bounds it on the card: bytes. The function needs 2*B*H*dh*T = 246 MB
// of int8 K/V at turbo batch 64 (0.073 ms at 3.35 TB/s); its dense form does
// H-fold redundant multiply-adds, 9.8e9 operations (0.0099 ms at the bf16
// tensor-core peak), still below the bytes.
//
// What the design does about it. The question the TPU kernel asked, whether
// products with H-fold redundant work on the matrix unit beat per-head
// matvecs, is asked here of the tensor cores: both products are
// mma.sync.m16n8k16 bf16 with fp32 accumulation, with the zeros of the
// block-diagonal query really multiplied. The TPU ran one program per batch
// row; here that is 64 blocks at B64, too few to keep enough loads in flight
// on 132 SMs, so the row is split where each product splits, into two
// launches of 8 warps a block:
//   1. scores: one block per (32 positions, batch row), 3,008 at turbo B64.
//      The query rows (H, padded to a multiple of 16) are the A operand,
//      built per k-step from the scaled query in shared memory (row h is
//      nonzero only in its own 64 columns). The block's K tile (all H*dh
//      channels x 32 positions) is converted from int8 to bf16 into shared
//      memory, position-major, so one tile is the B operand of every head
//      at once. Warp w computes the (m-tile w/4, 8-position n-tile w%4)
//      block of S over all H*dh channels, in two accumulators (even and odd
//      k-steps). S (B, H, T) fp32 goes to a scratch buffer (7.7 MB at turbo
//      B64, read back from L2).
//   2. output: one block per (128 channels, batch row), 640 at turbo B64.
//      The block takes the max and the sum of exponentials of each row of
//      S, then streams its channels of V in tiles of 128 positions (int8 ->
//      bf16, the A operand) beside the same positions of the weights,
//      w = exp(s - max) / sum rounded to bf16 (the B operand, H columns
//      padded to a multiple of 8). Warp w owns 16 channels: they belong to
//      one head, and that head's column of the product is written out.
// K and V are each read once; every thread keeps 16 (K and V) 4-byte loads
// in flight before it converts and stores them.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C interface, loaded with ctypes (whisper_tpu_torch/ops/decode_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TT1 = 32;              // positions per scores block
constexpr int TT2 = 128;             // positions per V tile of an output block
constexpr int CH = 16 * WARPS;       // channels per output block
constexpr int LDV = TT2 + 8;         // bf16 stride of V and weight tile rows: 272 B
constexpr int MAX_H = 32;            // two m-tiles of query rows, four n-tiles of heads
constexpr int K_BATCH = 8;           // K channel pairs a thread loads before it stores
constexpr int V_ITEMS = CH * (TT2 / 4) / THREADS;  // char4 of a V tile per thread

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (16x8 fp32) += A (16x16 bf16, row) * B (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// A fragment of k-step ks for query rows r0, r1 of the block-diagonal query:
// columns ks*16..ks*16+15 belong to head ks/4, so only that row is nonzero
__device__ __forceinline__ void query_frag(uint32_t a[4], const uint32_t* sQw, int ks, int r0,
                                           int r1, int tg) {
  const int hk = ks >> 2;
  const uint32_t* qw = sQw + hk * (DH / 2) + (ks & 3) * 8 + tg;
  const uint32_t lo = qw[0], hi = qw[4];
  a[0] = r0 == hk ? lo : 0u;
  a[1] = r1 == hk ? lo : 0u;
  a[2] = r0 == hk ? hi : 0u;
  a[3] = r1 == hk ? hi : 0u;
}

__host__ __device__ constexpr int k_stride(int H) { return H * DH + 8; }  // bf16, K tile row

// dynamic shared memory of a scores block: scaled query bf16 (H, 64) | K tile
__host__ __device__ inline size_t scores_smem(int H) {
  return (size_t)H * DH * 2 + (size_t)2 * TT1 * k_stride(H);
}

// ---- 1. S[b, :, t0:t0+TT1] = Qd K for one tile of positions of one batch row
template <typename Tq>
__global__ void __launch_bounds__(THREADS)
dense_scores_kernel(const Tq* __restrict__ q, const int8_t* __restrict__ kq,
                    const float* __restrict__ ks, float* __restrict__ S, int H, int T,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  uint32_t* sK = reinterpret_cast<uint32_t*>(smem + (size_t)H * DH * 2);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;  // mma groupID / thread-in-group
  const int HD = H * DH, ldk = k_stride(H);
  const int t0 = blockIdx.x * TT1;
  const size_t b = blockIdx.y;
  const int8_t* K = kq + b * HD * (size_t)T;
  const size_t row0 = b * HD;  // first (head, channel) of this batch row

  // the scaled query, rounded to bf16 as the TPU kernel's operand
  for (int i = tid; i < HD; i += THREADS)
    sQ[i] = __float2bfloat16(to_f32(q[row0 + i]) * ks[row0 + i] * scale);

  // int8 rows c, c+1 at positions t..t+3 -> bf16 pairs (c, c+1) at [t][c];
  // K_BATCH pairs' loads are in flight before the first store
  const int items = (HD / 2) * (TT1 / 4);
  for (int base = tid; base < items; base += K_BATCH * THREADS) {
    char4 x0[K_BATCH], x1[K_BATCH];
#pragma unroll
    for (int j = 0; j < K_BATCH; ++j) {
      const int idx = base + j * THREADS;
      const int quad = idx & (TT1 / 4 - 1), p = idx / (TT1 / 4), t = t0 + 4 * quad;
      x0[j] = x1[j] = make_char4(0, 0, 0, 0);
      if (idx < items && t < T) {  // T % 4 == 0: a char4 is all in or all out
        x0[j] = *reinterpret_cast<const char4*>(K + (size_t)(2 * p) * T + t);
        x1[j] = *reinterpret_cast<const char4*>(K + (size_t)(2 * p + 1) * T + t);
      }
    }
#pragma unroll
    for (int j = 0; j < K_BATCH; ++j) {
      const int idx = base + j * THREADS;
      if (idx < items) {
        const int quad = idx & (TT1 / 4 - 1), p = idx / (TT1 / 4);
        uint32_t* d = sK + (4 * quad) * (ldk / 2) + p;
        d[0] = pack_bf16((float)x0[j].x, (float)x1[j].x);
        d[ldk / 2] = pack_bf16((float)x0[j].y, (float)x1[j].y);
        d[ldk] = pack_bf16((float)x0[j].z, (float)x1[j].z);
        d[3 * (ldk / 2)] = pack_bf16((float)x0[j].w, (float)x1[j].w);
      }
    }
  }
  __syncthreads();

  const int mt = warp >> 2, nt = warp & 3;  // this warp's block of S
  const int r0 = mt * 16 + g, r1 = r0 + 8;   // its two query rows (heads)
  if (mt * 16 >= H) return;                  // a padding m-tile: nothing to compute
  // two accumulators (even and odd k-steps) halve the chain of dependent mma
  float c[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
  const uint32_t* sQw = reinterpret_cast<const uint32_t*>(sQ);
  const uint32_t* kb = sK + (nt * 8 + g) * (ldk / 2) + tg;
  for (int kstep = 0; kstep < HD / 16; kstep += 2) {  // HD / 16 = 4H is even
    uint32_t a[4], a1[4];
    query_frag(a, sQw, kstep, r0, r1, tg);
    query_frag(a1, sQw, kstep + 1, r0, r1, tg);
    // B: channels kstep*16 + tg*2 (+1) and (+8, +9) at position nt*8 + g
    mma_bf16(c, a, kb[kstep * 8], kb[kstep * 8 + 4]);
    mma_bf16(c1, a1, kb[kstep * 8 + 8], kb[kstep * 8 + 12]);
  }
  const int t = t0 + nt * 8 + tg * 2;  // even; T % 4 == 0, so t + 1 < T too
  if (t < T) {
    float* Sb = S + b * H * (size_t)T;
    if (r0 < H)
      *reinterpret_cast<float2*>(Sb + (size_t)r0 * T + t) = make_float2(c[0] + c1[0],
                                                                       c[1] + c1[1]);
    if (r1 < H)
      *reinterpret_cast<float2*>(Sb + (size_t)r1 * T + t) = make_float2(c[2] + c1[2],
                                                                       c[3] + c1[3]);
  }
}

// ---- 2. out[b, head of channels c0..c0+CH) = diag(V W^T) * v_s
template <typename Tq>
__global__ void __launch_bounds__(THREADS)
dense_output_kernel(const float* __restrict__ S, const int8_t* __restrict__ vq,
                    const float* __restrict__ vs, Tq* __restrict__ out, int H, int T) {
  __shared__ __align__(16) bf16 sV[CH * LDV];          // V tile [channel][position]
  __shared__ __align__(16) bf16 sW[MAX_H * LDV];       // weights [head][position]
  __shared__ float s_max[MAX_H], s_sum[MAX_H];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int HD = H * DH, n_tiles = (H + 7) / 8, w_rows = 8 * n_tiles;
  const int c0 = blockIdx.x * CH, cw = c0 + warp * 16;  // this warp's 16 channels
  const size_t b = blockIdx.y;
  const int8_t* V = vq + b * HD * (size_t)T;
  const float* Sb = S + b * H * (size_t)T;

  // the softmax statistics of each row of S (fp32), four loads in flight
  for (int h = warp; h < H; h += WARPS) {
    const float* row = Sb + (size_t)h * T;
    float m = -INFINITY;
#pragma unroll 4
    for (int t = 4 * lane; t < T; t += 128) {
      const float4 s = *reinterpret_cast<const float4*>(row + t);
      m = fmaxf(m, fmaxf(fmaxf(s.x, s.y), fmaxf(s.z, s.w)));
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll 4
    for (int t = 4 * lane; t < T; t += 128) {
      const float4 s = *reinterpret_cast<const float4*>(row + t);
      sum += (expf(s.x - m) + expf(s.y - m)) + (expf(s.z - m) + expf(s.w - m));
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      s_max[h] = m;
      s_sum[h] = sum;
    }
  }

  float acc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int t0 = 0; t0 < T; t0 += TT2) {
    __syncthreads();  // the statistics are written / the previous tiles are consumed
    char4 x[V_ITEMS];  // the whole V tile's loads in flight before the first store
#pragma unroll
    for (int j = 0; j < V_ITEMS; ++j) {
      const int idx = tid + j * THREADS;
      const int quad = idx & (TT2 / 4 - 1), r = idx / (TT2 / 4);
      const int c = c0 + r, t = t0 + 4 * quad;
      x[j] = make_char4(0, 0, 0, 0);
      if (c < HD && t < T) x[j] = *reinterpret_cast<const char4*>(V + (size_t)c * T + t);
    }
    // the normalised weights of these positions, rounded to bf16; zero for
    // padding heads and positions past T
    for (int idx = tid; idx < w_rows * (TT2 / 4); idx += THREADS) {
      const int quad = idx & (TT2 / 4 - 1), h = idx / (TT2 / 4), t = t0 + 4 * quad;
      uint2 w = make_uint2(0u, 0u);
      if (h < H && t < T) {
        const float4 s = *reinterpret_cast<const float4*>(Sb + (size_t)h * T + t);
        const float m = s_max[h], l = s_sum[h];
        w = make_uint2(pack_bf16(expf(s.x - m) / l, expf(s.y - m) / l),
                       pack_bf16(expf(s.z - m) / l, expf(s.w - m) / l));
      }
      *reinterpret_cast<uint2*>(sW + h * LDV + 4 * quad) = w;
    }
#pragma unroll
    for (int j = 0; j < V_ITEMS; ++j) {
      const int idx = tid + j * THREADS;
      const int quad = idx & (TT2 / 4 - 1), r = idx / (TT2 / 4);
      *reinterpret_cast<uint2*>(sV + r * LDV + 4 * quad) = make_uint2(
          pack_bf16((float)x[j].x, (float)x[j].y), pack_bf16((float)x[j].z, (float)x[j].w));
    }
    __syncthreads();
    if (cw < HD) {
#pragma unroll
      for (int kstep = 0; kstep < TT2 / 16; ++kstep) {
        // A: V rows cw+g, cw+g+8 at tile positions kstep*16 + tg*2 (+1), (+8, +9)
        const uint32_t* vw = reinterpret_cast<const uint32_t*>(
            sV + (warp * 16 + g) * LDV + kstep * 16 + tg * 2);
        const uint32_t a[4] = {vw[0], vw[8 * LDV / 2], vw[4], vw[8 * LDV / 2 + 4]};
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          if (n >= n_tiles) break;
          // B = W^T: head n*8 + g's weights at those positions
          const uint32_t* ww = reinterpret_cast<const uint32_t*>(
              sW + (n * 8 + g) * LDV + kstep * 16 + tg * 2);
          mma_bf16(acc[n], a, ww[0], ww[4]);
        }
      }
    }
  }
  // the diagonal: rows cw..cw+15 are channels d0..d0+15 of head hm, whose
  // column hm sits in n-tile hm/8, lane group tg = (hm%8)/2, element hm%2
  if (cw < HD) {
    const int hm = cw / DH, d0 = cw % DH, j = hm % 8;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      if (n == hm / 8 && tg == j / 2) {
        const float o0 = (j & 1) ? acc[n][1] : acc[n][0];
        const float o1 = (j & 1) ? acc[n][3] : acc[n][2];
        const size_t i0 = b * HD + (size_t)hm * DH + d0 + g;
        store(out + i0, o0 * vs[i0]);
        store(out + i0 + 8, o1 * vs[i0 + 8]);
      }
    }
  }
}

template <typename Tq>
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           void* scores, void* out, int B, int H, int T, float scale, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H < 1 || H > MAX_H || T < 4 || T % 4) return (int)cudaErrorInvalidValue;
  // 135 KB at most (H = 32): opt in to the largest, once per device
  constexpr int kMaxDevices = 64;
  static bool opted_in[kMaxDevices] = {};
  const size_t smem = scores_smem(H);
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[device]) {
    err = cudaFuncSetAttribute(dense_scores_kernel<Tq>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)scores_smem(MAX_H));
    if (err != cudaSuccess) return (int)err;
    opted_in[device] = true;
  }
  dense_scores_kernel<Tq><<<dim3((T + TT1 - 1) / TT1, B), THREADS, smem,
                            (cudaStream_t)stream>>>(
      (const Tq*)q, (const int8_t*)kq, (const float*)ks, (float*)scores, H, T, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dense_output_kernel<Tq><<<dim3((H * DH + CH - 1) / CH, B), THREADS, 0,
                            (cudaStream_t)stream>>>(
      (const float*)scores, (const int8_t*)vq, (const float*)vs, (Tq*)out, H, T);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B, H, dh) in the query's dtype; kq, vq: (B, H*dh, T) int8;
// ks, vs: (B, H, dh) fp32; scores: (B, H, T) fp32 scratch; 1 <= H <= 32,
// T % 4 == 0. Two launches on ``stream``. Returns a cudaError_t.
extern "C" int cross_attention_decode_dense_bf16(const void* q, const void* kq,
                                                 const void* ks, const void* vq,
                                                 const void* vs, void* scores, void* out,
                                                 int B, int H, int T, float scale, int device,
                                                 void* stream) {
  return launch<bf16>(q, kq, ks, vq, vs, scores, out, B, H, T, scale, device, stream);
}

extern "C" int cross_attention_decode_dense_f32(const void* q, const void* kq,
                                                const void* ks, const void* vq,
                                                const void* vs, void* scores, void* out,
                                                int B, int H, int T, float scale, int device,
                                                void* stream) {
  return launch<float>(q, kq, ks, vq, vs, scores, out, B, H, T, scale, device, stream);
}
