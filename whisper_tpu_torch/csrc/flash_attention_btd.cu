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
// memory a block may use, so K and V stream through shared memory with an
// online softmax. bf16 runs the TMA + wgmma kernel of flash_attention_sm90.cuh
// (shared with the split-head kernel flash_attention.cu; its note gives the
// design): here its tensor maps are 3-D over (D, T, B), so a head's rows are read in
// place at column h*64 and rows >= T of a batch row are zero-filled, never
// taken from the next batch row; the output is written in place in the same
// layout, rows >= T not at all. No split-heads copies. fp32: a plain FMA
// kernel (one thread per query row) for the fp32 checks.
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

// q, k, v, o: (B, T, D) contiguous and 16-byte aligned, D = H * 64. Returns 0,
// a cudaError_t (> 0), or minus the CUresult of a failed tensor-map encode.
extern "C" int flash_attention_btd_bf16(const void* q, const void* k, const void* v,
                                        void* o, int B, int T, int D, int H,
                                        float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[2] = {2ull * D, 2ull * T * D};
  CUtensorMap mq, mk, mv;
  int rc = fa_sm90::make_map(&mq, q, dims, strides, fa_sm90::WG_ROWS);
  if (rc == 0) rc = fa_sm90::make_map(&mk, k, dims, strides, fa_sm90::BK);
  if (rc == 0) rc = fa_sm90::make_map(&mv, v, dims, strides, fa_sm90::BK);
  if (rc != 0) return rc;
  fa_sm90::Params p{T, T, fa_sm90::DH, 0, (long long)T * D, D, scale * 1.4426950408889634f};
  return fa_sm90::launch(mq, mk, mv, o, p, dim3((T + fa_sm90::BQ - 1) / fa_sm90::BQ, H, B),
                         (cudaStream_t)stream);
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
