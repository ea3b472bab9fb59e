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
// bf16, more than the 227 KB of shared memory a block may use, so K and V
// stream through shared memory with an online softmax. bf16 runs the TMA +
// wgmma kernel of flash_attention_sm90.cuh, shared with the (B, T, D) kernel
// flash_attention_btd.cu: here its tensor maps are 3-D over (64, T, B*H),
// one for q (Tq rows) and one each for k and v (Tk rows), so every tile is
// one contiguous block of a head and rows past a head's T are zero-filled;
// keys >= Tk are masked in the last tile, query rows >= Tq never written.
// Nothing is padded in memory. fp32: a plain FMA kernel (one thread per
// query row) for the fp32 checks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C interface, loaded with ctypes (whisper_tpu_torch/ops/flash_attention.py).

#include "flash_attention_sm90.cuh"

namespace {

constexpr int DH = 64;  // head dim of every Whisper size

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

// q, o: (BH, Tq, 64); k, v: (BH, Tk, 64); contiguous and 16-byte aligned,
// BH = B * H. Returns 0, a cudaError_t (> 0), or minus the CUresult of a
// failed tensor-map encode.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                    int BH, int Tq, int Tk, float scale, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cuuint64_t dims_q[3] = {DH, (cuuint64_t)Tq, (cuuint64_t)BH};
  const cuuint64_t dims_kv[3] = {DH, (cuuint64_t)Tk, (cuuint64_t)BH};
  const cuuint64_t strides_q[2] = {2ull * DH, 2ull * DH * Tq};
  const cuuint64_t strides_kv[2] = {2ull * DH, 2ull * DH * Tk};
  CUtensorMap mq, mk, mv;
  int rc = fa_sm90::make_map(&mq, q, dims_q, strides_q, fa_sm90::WG_ROWS);
  if (rc == 0) rc = fa_sm90::make_map(&mk, k, dims_kv, strides_kv, fa_sm90::BK);
  if (rc == 0) rc = fa_sm90::make_map(&mv, v, dims_kv, strides_kv, fa_sm90::BK);
  if (rc != 0) return rc;
  fa_sm90::Params p{Tq, Tk, 0, 1, (long long)Tq * DH, DH, scale * 1.4426950408889634f};
  return fa_sm90::launch(mq, mk, mv, o, p, dim3((Tq + fa_sm90::BQ - 1) / fa_sm90::BQ, BH),
                         (cudaStream_t)stream);
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
