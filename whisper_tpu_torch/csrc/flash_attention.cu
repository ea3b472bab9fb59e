// Split-head bidirectional attention, for Hopper (sm_90a).
//
// Replaces the TPU kernel whisper_tpu/ops/flash_attention.py:flash_attention
// (_attn_kernel): q (B, H, Tq, 64), k and v (B, H, Tk, 64), Tq and Tk
// independent; products in the input dtype with fp32 accumulation, fp32
// softmax, weights cast to v's dtype before the product with V, output in
// v's dtype. It is the encoder attention the JAX package runs under
// WHISPER_TPU_FLASH=bhtd (encoder_attention="bhtd" in the port), after the
// split-heads copies.
//
// What bounds it on the card: operations. At turbo batch 64 one launch does
// 4*B*H*Tq*Tk*dh = 7.4e11 FLOP against 983 MB of q/k/v/o, far above the
// H100's ~295 bf16 FLOP per byte of device memory.
//
// What the design does about it. The TPU kernel keeps one q tile, a head's
// WHOLE K and V padded to 128 positions (1536 x 64) and the full score tile
// in VMEM, with no online softmax. One head's K+V at Tk=1500 is 384 KB in
// bf16, more than the 227 KB of shared memory a block may use, so here, as
// in the (B, T, D) kernel flash_attention_btd.cu:
//   - one block per (q tile of 64 rows, batch*head), 4 warps, 16 query rows
//     per warp: 24 x 1,280 = 30,720 blocks at turbo B64. The q tile is the
//     fastest grid index, so the 24 blocks that read one head's K/V run
//     together and find it in L2 (were the head the fastest index, every
//     q tile would fetch the head's 384 KB from device memory again);
//   - K and V stream through shared memory in tiles of 64 positions with an
//     online softmax (running max and denominator, fp32 accumulator);
//   - a head's rows are 128 contiguous bytes (row stride 64), so every
//     tile is one contiguous 8 KB block of device memory;
//   - keys >= Tk are masked in the last tile only; query rows >= Tq are
//     zero-filled on load and never written. Nothing is padded in memory.
// bf16: q.k^T and p.v run on the tensor cores (mma.sync m16n8k16, fp32
// accumulate); p is rounded to bf16 before p.v, as the TPU kernel rounds its
// weights to v's dtype (here unnormalised: the division comes at the end).
// fp32: a plain FMA kernel (one thread per query row) for the fp32 checks.
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

// Copy rows t0..t0+63 of one head (row stride 64: 8 x 16 B each) into shared
// memory; rows at or past n are zero-filled.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* head, int t0, int n,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < (BK * DH / 8) / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx >> 3, c = (idx & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t0 + r < n) val = *reinterpret_cast<const uint4*>(head + (size_t)(t0 + r) * DH + c);
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
fa_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ o, int Tq, int Tk,
               float scale_log2) {
  __shared__ __align__(16) bf16 sQ[BQ * LDS];
  __shared__ __align__(16) bf16 sK[BK * LDS];
  __shared__ __align__(16) bf16 sV[BK * LDS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;  // mma groupID / thread-in-group
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const bf16* qh = q + bh * Tq * DH;
  const bf16* kh = k + bh * Tk * DH;
  const bf16* vh = v + bh * Tk * DH;

  load_tile(sQ, qh, q0, Tq, tid);
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

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sK, kh, k0, Tk, tid);
    load_tile(sV, vh, k0, Tk, tid);
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

    // scale into the log2 domain, mask keys >= Tk (last tile only), new maxima
    const bool ragged = k0 + BK > Tk;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + tg * 2 + (e & 1);
        s[nt][e] = (!ragged || col < Tk) ? s[nt][e] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // the first tile always holds a valid key (Tk >= 1), so mx is finite
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
  bf16* oh = o + bh * Tq * DH;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + tg * 2;
    if (r0 < Tq)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r0 * DH + col) =
          pack_bf16(acc[nt][0] * inv0, acc[nt][1] * inv0);
    if (r1 < Tq)
      *reinterpret_cast<uint32_t*>(oh + (size_t)r1 * DH + col) =
          pack_bf16(acc[nt][2] * inv1, acc[nt][3] * inv1);
  }
}

// fp32: one thread per query row, K/V tiles of 32 positions in shared memory
constexpr int F32_ROWS = 64;
constexpr int F32_BK = 32;

__global__ void __launch_bounds__(F32_ROWS)
fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int Tq, int Tk,
              float scale_log2) {
  __shared__ __align__(16) float sK[F32_BK][DH];
  __shared__ __align__(16) float sV[F32_BK][DH];
  const int tid = threadIdx.x;
  const int row = blockIdx.x * F32_ROWS + tid;
  const size_t bh = blockIdx.y;
  const float* kh = k + bh * Tk * DH;
  const float* vh = v + bh * Tk * DH;

  float qr[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    qr[d] = row < Tq ? q[(bh * Tq + row) * DH + d] * scale_log2 : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < Tk; k0 += F32_BK) {
    __syncthreads();
    for (int idx = tid; idx < F32_BK * DH / 4; idx += F32_ROWS) {
      const int r = idx / (DH / 4), c = (idx % (DH / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < Tk) {
        kv = *reinterpret_cast<const float4*>(kh + (size_t)(k0 + r) * DH + c);
        vv = *reinterpret_cast<const float4*>(vh + (size_t)(k0 + r) * DH + c);
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
      s[j] = k0 + j < Tk ? dot : -INFINITY;
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
  if (row < Tq) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[(bh * Tq + row) * DH + d] = acc[d] * inv;
  }
}

}  // namespace

// q, o: (BH, Tq, 64); k, v: (BH, Tk, 64); contiguous, BH = B * H.
// Returns a cudaError_t.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    int BH, int Tq, int Tk, float scale, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BQ - 1) / BQ, BH);
  fa_bf16_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, Tq, Tk,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                   int BH, int Tq, int Tk, float scale, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + F32_ROWS - 1) / F32_ROWS, BH);
  fa_f32_kernel<<<grid, F32_ROWS, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Tq, Tk,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
