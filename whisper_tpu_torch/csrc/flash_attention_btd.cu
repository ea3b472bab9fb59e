// Encoder self-attention on the native (B, T, D) layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel whisper_tpu/ops/flash_attention.py:flash_attention_btd
// (_btd_kernel): bidirectional full-softmax attention where head h is columns
// h*64 .. h*64+63 of q, k and v, fp32 softmax, output in the input dtype.
//
// What bounds it on the card: operations. At turbo batch 64 one launch does
// 4*B*H*T^2*dh = 7.4e11 FLOP against 983 MB of q/k/v/o, far above the H100's
// ~295 bf16 FLOP per byte of device memory.
//
// What the design does about it. The TPU kernel keeps one q tile, the WHOLE
// K and V of a head and the full score tile in VMEM, with no online softmax.
// One head's K+V at T=1500 is 384 KB in bf16, more than the 227 KB of shared
// memory a block may use, so here:
//   - one block per (q tile of 64 rows, head, batch row): 24*20*64 = 30,720
//     blocks at turbo B64, 4 warps, 16 query rows per warp;
//   - K and V stream through shared memory in tiles of 64 positions with an
//     online softmax (running max and denominator, fp32 accumulator);
//   - q/k/v are read straight from (B, T, D) with row stride D and column
//     offset h*64 (128 contiguous bytes per head row) and the output is
//     written in place in the same layout: no split-heads copies;
//   - keys >= T are masked, rows >= T are not written.
// bf16: q.k^T and p.v run on the tensor cores (mma.sync m16n8k16, fp32
// accumulate); p is rounded to bf16 before p.v as the TPU kernel rounds its
// weights to v's dtype. fp32: a plain FMA kernel (one thread per query row)
// for the fp32 checks. No TMA/wgmma pipeline yet: that is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C interface, loaded with ctypes (whisper_tpu_torch/ops/flash_attention.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DH = 64;        // head dim of every Whisper size
constexpr int BQ = 64;        // query rows per block (bf16 kernel)
constexpr int BK = 64;        // key positions per shared-memory tile
constexpr int LDS = DH + 8;   // shared row stride in bf16: 144 B, bank-conflict free
constexpr int THREADS = 128;  // 4 warps x 16 query rows

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16_raw(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
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

// Copy rows t0..t0+63 of one head (64 bf16 = 8 x 16 B each) into shared
// memory; rows at or past T are zero-filled.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* head_base,
                                          int t0, int T, int D, int tid) {
#pragma unroll
  for (int i = 0; i < (BK * DH / 8) / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx >> 3, c = (idx & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < T)
      val = *reinterpret_cast<const uint4*>(head_base + (size_t)(t0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
fa_btd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o,
                   int T, int D, float scale_log2) {
  __shared__ __align__(16) bf16 sQ[BQ * LDS];
  __shared__ __align__(16) bf16 sK[BK * LDS];
  __shared__ __align__(16) bf16 sV[BK * LDS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;  // mma groupID / thread-in-group
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t head = (size_t)b * T * D + (size_t)h * DH;

  load_tile(sQ, q + head, q0, T, D, tid);
  __syncthreads();

  // this warp's 16 query rows as mma A fragments, 4 k-steps over dh
  uint32_t qa[4][4];
  const bf16* qw = sQ + warp * 16 * LDS;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c = ks * 16 + tg * 2;
    qa[ks][0] = *reinterpret_cast<const uint32_t*>(qw + g * LDS + c);
    qa[ks][1] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * LDS + c);
    qa[ks][2] = *reinterpret_cast<const uint32_t*>(qw + g * LDS + c + 8);
    qa[ks][3] = *reinterpret_cast<const uint32_t*>(qw + (g + 8) * LDS + c + 8);
  }

  float acc[8][4];  // output rows g, g+8 x 8 column tiles of dh
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 domain), rows g, g+8
  float l0 = 0.f, l1 = 0.f;              // this thread's part of the denominators

  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sK, k + head, k0, T, D, tid);
    load_tile(sV, v + head, k0, T, D, tid);
    __syncthreads();

    // scores S = Q K^T for 64 keys: 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kr = sK + (nt * 8 + g) * LDS + tg * 2;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + ks * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + ks * 16 + 8);
        mma_bf16(s[nt], qa[ks], b0, b1);
      }
    }

    // scale into the log2 domain, mask keys >= T, new row maxima
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + tg * 2 + (e & 1);
        s[nt][e] = col < T ? s[nt][e] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // the first tile always holds a valid key, so mx is finite from here on
    const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mx0);
      s[nt][1] = exp2f(s[nt][1] - mx0);
      s[nt][2] = exp2f(s[nt][2] - mx1);
      s[nt][3] = exp2f(s[nt][3] - mx1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
      acc[nt][0] *= c0;
      acc[nt][1] *= c0;
      acc[nt][2] *= c1;
      acc[nt][3] *= c1;
    }
    l0 = l0 * c0 + rs0;
    l1 = l1 * c1 + rs1;

    // O += P V: the S accumulators of key tiles 2ks, 2ks+1 are exactly the
    // A fragment of k-step ks; B = V (k = key, n = head column)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
      const bf16* vr = sV + (ks * 16 + tg * 2) * LDS + g;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* vp = vr + nt * 8;
        const uint32_t b0 = pack_bf16_raw(vp[0], vp[LDS]);
        const uint32_t b1 = pack_bf16_raw(vp[8 * LDS], vp[9 * LDS]);
        mma_bf16(acc[nt], pa, b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = h * DH + nt * 8 + tg * 2;
    if (r0 < T)
      *reinterpret_cast<uint32_t*>(o + ((size_t)b * T + r0) * D + col) =
          pack_bf16(acc[nt][0] * inv0, acc[nt][1] * inv0);
    if (r1 < T)
      *reinterpret_cast<uint32_t*>(o + ((size_t)b * T + r1) * D + col) =
          pack_bf16(acc[nt][2] * inv1, acc[nt][3] * inv1);
  }
}

// fp32: one thread per query row, K/V tiles of 32 positions in shared memory
constexpr int F32_ROWS = 64;
constexpr int F32_BK = 32;

__global__ void __launch_bounds__(F32_ROWS)
fa_btd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  int T, int D, float scale_log2) {
  __shared__ __align__(16) float sK[F32_BK][DH];
  __shared__ __align__(16) float sV[F32_BK][DH];
  const int tid = threadIdx.x;
  const int row = blockIdx.x * F32_ROWS + tid, h = blockIdx.y, b = blockIdx.z;
  const size_t head = (size_t)b * T * D + (size_t)h * DH;

  float qr[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = row < T ? q[head + (size_t)row * D + d] * scale_log2 : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < T; k0 += F32_BK) {
    __syncthreads();
    for (int idx = tid; idx < F32_BK * DH / 4; idx += F32_ROWS) {
      const int r = idx / (DH / 4), c = (idx % (DH / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < T) {
        kv = *reinterpret_cast<const float4*>(k + head + (size_t)(k0 + r) * D + c);
        vv = *reinterpret_cast<const float4*>(v + head + (size_t)(k0 + r) * D + c);
      }
      *reinterpret_cast<float4*>(&sK[r][c]) = kv;
      *reinterpret_cast<float4*>(&sV[r][c]) = vv;
    }
    __syncthreads();

    float s[F32_BK];
    float mx = m;
#pragma unroll
    for (int j = 0; j < F32_BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) dot = fmaf(qr[d], sK[j][d], dot);
      s[j] = k0 + j < T ? dot : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float corr = exp2f(m - mx);
    m = mx;
    l *= corr;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < F32_BK; ++j) {
      const float p = exp2f(s[j] - mx);
      l += p;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, sV[j][d], acc[d]);
    }
  }
  if (row < T) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[head + (size_t)row * D + d] = acc[d] * inv;
  }
}

}  // namespace

// q, k, v, o: (B, T, D) contiguous, D = H * 64. Returns a cudaError_t.
extern "C" int flash_attention_btd_bf16(const void* q, const void* k, const void* v,
                                        void* o, int B, int T, int D, int H,
                                        float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  fa_btd_bf16_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, T, D,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_btd_f32(const void* q, const void* k, const void* v,
                                       void* o, int B, int T, int D, int H,
                                       float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + F32_ROWS - 1) / F32_ROWS, H, B);
  fa_btd_f32_kernel<<<grid, F32_ROWS, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, T, D,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
