// Helpers shared by the decode-step attention kernels K2
// (cross_attention_decode.cu) and K3 (self_attention_decode.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode {

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

// int8 -> fp32 without I2F (a quarter-rate conversion on sm_90). The biased
// byte x ^ 0x80 = x + 128 goes into the low mantissa byte of 2^23
// (0x4B000000), which reads as 2^23 + 128 + x exactly; subtracting
// 2^23 + 128 leaves x. One PRMT (byte select) and one FADD per value, both
// full-rate pipes. Exact for all 256 values (tests/test_torch_attention.py
// checks this bit pattern in numpy).
constexpr uint32_t kMagic = 0x4B000000u;  // 2^23 as fp32
constexpr float kBias = 8388736.0f;       // 2^23 + 128
constexpr uint32_t kFlip = 0x80808080u;   // x ^ 0x80 in every byte
constexpr uint32_t kSelect = 0x7440u;     // byte i of w, then 0x00, 0x00, 0x4B

// The four int8 values packed in w (byte 0 first) as fp32.
__device__ __forceinline__ float4 s8x4_to_f32(uint32_t w) {
  const uint32_t b = w ^ kFlip;
  return make_float4(__uint_as_float(__byte_perm(b, kMagic, kSelect + 0)) - kBias,
                     __uint_as_float(__byte_perm(b, kMagic, kSelect + 1)) - kBias,
                     __uint_as_float(__byte_perm(b, kMagic, kSelect + 2)) - kBias,
                     __uint_as_float(__byte_perm(b, kMagic, kSelect + 3)) - kBias);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

}  // namespace decode
