// Decode-step self-attention over the KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// whisper_tpu/ops/decode_attention.py:self_attention_decode (_self_kernel):
// one query per (batch, head) against the self-attention cache, key position
// t visible iff pads[b] <= t <= offsets[b], fp32 softmax. The TPU kernel
// reads a (B, H, T, dh) cache; this one reads the port's own position-minor
// caches (whisper_tpu_torch/models/model.py) as they lie:
//   - float (a KVCache layer view): K and V (B, H, dh, T) in the query's
//     dtype;
//   - int8 (a QKVCache layer view): (B, H, 2, dh, T) int8, K at index 0 and
//     V at 1, with fp32 per-position scales (B, H, 2, T). Score columns scale
//     by s_k after q.k and weights by s_v before w.v, the math of
//     attention_int8kv_perpos.
// The offset is a per-row int64 array (the serving engine's slots) or one
// scalar argument (the pipeline's step), so the scalar case copies nothing
// from the host per step; pads is an optional per-row int64 array.
//
// What bounds it on the card: at the paths' shapes, neither bytes nor
// operations but latency. A launch moves 0.6-3 MB (the visible windows:
// ~36 keys a row offline, ~116 serving), under a microsecond at 3.35 TB/s;
// what it cannot avoid is one DRAM round trip after the launch.
//
// What the design does about it. Each (batch, head) is one block of warps,
// and each warp reads ONLY its share of the row's visible window, in chunks
// of 128 bytes of every row (128 int8 positions, 64 bf16, 32 fp32) on a
// grid aligned to the cache's alignment. A block has a warp a chunk of the
// widest window the call can have (T, or up to the offset when it is one
// scalar), up to four, but no more than lets every block of the launch be
// on the card at once (the offline batch's 1,280 rows: one warp). A launch
// of fewer rows than four an SM (the serving slots: 160) is latency-bound:
// it takes 64-byte chunks and up to eight warps a row instead.
//   - a chunk's K rows and scales go into the warp's shared memory by
//     cp.async, 16 bytes a copy where the rows allow it (every cache the
//     paths use), and lane d loads V rows d and d + 32 of the chunk straight
//     into registers beside them: one round of independent loads, then the
//     warp waits once. A window the block's warps cover at once is one
//     DRAM round trip. Rows that are not 16-byte aligned (T = 1, odd T, a view
//     one element in) take narrower copies, down to byte loads, and stage V
//     in shared memory too;
//   - the chunk's scores: each quad of positions has 32 / quads lanes, each
//     summing its share of the 64 rows, added up by shuffles, so a short
//     window keeps the warp busy; the chunk's max and sum are warp
//     shuffles, and lane d forms outputs d and d + 32: no block barrier on
//     the way, an online softmax across a warp's chunks, and one barrier to
//     merge the warps' (max, sum, outputs) at the end;
//   - int8 -> fp32 by a byte permute into 2^23's mantissa and one subtract
//     (decode_common.cuh), not I2F.
// A window that is empty (pads[b] > offsets[b], or a negative offset) gets
// what the masked reference gives: every score is the same -1e30, so the
// weights are uniform over all T.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C interface, loaded with ctypes (whisper_tpu_torch/ops/decode_attention.py).

#include <math.h>

#include <initializer_list>

#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int DH = 64;
constexpr int BLOCK_BYTES = 512;  // of every K and V row, a block's chunks at once

// The geometry of a chunk of CB bytes of every K and V row (64 or 128).
template <int CB>
struct Chunk {
  static constexpr int ROW = CB + 16;          // shared row stride: spreads the banks
  static constexpr int SPAN = CB + 16;         // fp32 slots for its scales and weights
  static constexpr int V_UNITS = CB / 16;      // 16-byte pieces of its V row
  static constexpr int MAX_WARPS = BLOCK_BYTES / CB;
  // a warp's shared memory: K rows, V rows (only where they are staged), K
  // and V scales (int8 cache), weights, the query
  __host__ __device__ static constexpr int bytes(bool stage_v, bool quant) {
    return DH * ROW * (stage_v ? 2 : 1) + (quant ? 2 * SPAN * 4 : 0) + SPAN * 4 + DH * 4;
  }
};

template <typename Tc>
__device__ __forceinline__ float4 load4(const unsigned char* row, int j);

template <>
__device__ __forceinline__ float4 load4<float>(const unsigned char* row, int j) {
  return reinterpret_cast<const float4*>(row)[j];
}

__device__ __forceinline__ float4 bf16x4_to_f32(uint32_t lo, uint32_t hi) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&lo));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hi));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(const unsigned char* row, int j) {
  const uint2 u = reinterpret_cast<const uint2*>(row)[j];
  return bf16x4_to_f32(u.x, u.y);
}

template <>
__device__ __forceinline__ float4 load4<int8_t>(const unsigned char* row, int j) {
  return s8x4_to_f32(reinterpret_cast<const uint32_t*>(row)[j]);
}

// Quad qq (compile-time) of the 16 bytes u, as fp32.
template <typename Tc>
__device__ __forceinline__ float4 quad_of(const uint4& u, int qq);

template <>
__device__ __forceinline__ float4 quad_of<float>(const uint4& u, int) {
  return make_float4(__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                     __uint_as_float(u.w));
}

template <>
__device__ __forceinline__ float4 quad_of<__nv_bfloat16>(const uint4& u, int qq) {
  return qq == 0 ? bf16x4_to_f32(u.x, u.y) : bf16x4_to_f32(u.z, u.w);
}

template <>
__device__ __forceinline__ float4 quad_of<int8_t>(const uint4& u, int qq) {
  return s8x4_to_f32(qq == 0 ? u.x : qq == 1 ? u.y : qq == 2 ? u.z : u.w);
}

__device__ __forceinline__ float dot(float4 p, float4 v, float acc) {
  return fmaf(p.w, v.w, fmaf(p.z, v.z, fmaf(p.y, v.y, fmaf(p.x, v.x, acc))));
}

// One unit of `unit` bytes (1, 2, 4, 8 or 16; src and dst aligned to it)
// from global to shared memory: cp.async from 4 bytes up, else a load.
__device__ __forceinline__ void copy_unit(void* dst, const void* src, int unit) {
  const uint32_t d = smem_u32(dst);
  switch (unit) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
      break;
    case 2:
      *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
      break;
    default:
      *static_cast<uint8_t*>(dst) = *static_cast<const uint8_t*>(src);
  }
}

// Elements [e0, e1) of `rows` rows (`stride` elements apart from `src`) into
// shared rows `dst_stride` bytes apart, in units of `unit` bytes; e0 and e1
// are multiples of the unit's elements. Lanes take consecutive units.
template <typename E>
__device__ __forceinline__ void copy_rows(unsigned char* dst, int dst_stride, const E* src,
                                          long long stride, int rows, int e0, int e1, int unit,
                                          int lane) {
  const int units = (int)((e1 - e0) * sizeof(E) / unit);
  for (int i = lane; i < rows * units; i += 32) {
    const int r = i / units, c = i - r * units;
    copy_unit(dst + r * dst_stride + c * unit,
              reinterpret_cast<const unsigned char*>(src + r * stride + e0) + c * unit, unit);
  }
}

// k, v: row d of (batch, head) bh at k + bh * kv_stride + d * T; ks, vs: the
// per-position scales (QUANT only), s_stride floats apart. unit, s_unit: the
// widest copy (bytes, <= 16) that the cache rows and scale rows allow.
// DIRECT_V (unit == 16): lane d loads V rows d and d + 32 of a chunk straight
// into registers, beside the cp.async of K; otherwise V is staged in shared
// memory like K.
template <typename Tq, typename Tc, bool QUANT, bool DIRECT_V, int CB>
__global__ void __launch_bounds__(32 * Chunk<CB>::MAX_WARPS, 1)
self_decode_kernel(const Tq* __restrict__ q, const Tc* __restrict__ k,
                   const Tc* __restrict__ v, long long kv_stride,
                   const float* __restrict__ ks, const float* __restrict__ vs,
                   long long s_stride, Tq* __restrict__ out,
                   const long long* __restrict__ offsets,
                   const long long* __restrict__ pads, long long offset, int H,
                   int T, float scale, int unit, int s_unit) {
  extern __shared__ __align__(16) unsigned char smem[];
  using C = Chunk<CB>;
  constexpr int ROW = C::ROW, SPAN = C::SPAN;
  constexpr int CH = CB / (int)sizeof(Tc);         // positions a chunk
  constexpr int QPU = 16 / (4 * (int)sizeof(Tc));  // quads a 16-byte unit
  constexpr int WB = C::bytes(!DIRECT_V, QUANT);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  unsigned char* mine = smem + warp * WB;
  unsigned char(*sk)[ROW] = reinterpret_cast<unsigned char(*)[ROW]>(mine);
  unsigned char(*sv)[ROW] = sk + DH;  // staged V rows (!DIRECT_V)
  float* ss = reinterpret_cast<float*>(mine + DH * ROW * (DIRECT_V ? 1 : 2));  // [2][SPAN]
  float* sw = ss + (QUANT ? 2 * SPAN : 0);
  float* sq = sw + SPAN;

  const size_t bh = blockIdx.x;
  const int b = (int)(blockIdx.x / (unsigned)H);
  const long long top = offsets ? offsets[b] : offset, pad = pads ? pads[b] : 0;
  int hi = (int)(top > T - 1 ? T - 1 : top < -1 ? -1 : top);
  int lo = (int)(pad < 0 ? 0 : pad > T ? T : pad);
  const bool empty = hi < lo;
  if (empty) {
    lo = 0;
    hi = T - 1;
  }
  const Tc* K = k + bh * kv_stride;
  const Tc* V = v + bh * kv_stride;
  const float* SK = QUANT ? ks + bh * s_stride : nullptr;
  const float* SV = QUANT ? vs + bh * s_stride : nullptr;
  const int ue = unit / (int)sizeof(Tc);  // elements a unit (unit >= the element)
  const int se = s_unit / 4;

  sq[lane] = to_f32(q[bh * DH + lane]);
  sq[lane + 32] = to_f32(q[bh * DH + lane + 32]);

  float m = -INFINITY, l = 0.f, acc0 = 0.f, acc1 = 0.f;
  // chunks on a grid aligned to the unit; warp w takes chunks w, w + warps, ...
  const int base = (int)(lo / ue) * ue;
  for (int c0 = base + warp * CH; c0 <= hi; c0 += warps * CH) {
    const int c1 = min(c0 + CH, hi + 1);            // last position + 1
    const int e1 = min((c1 + ue - 1) / ue * ue, T);  // the copied span [c0, e1)
    const int lo_c = max(c0, lo);                    // the chunk's visible [lo_c, c1)
    if (!empty) copy_rows(&sk[0][0], ROW, K, T, DH, c0, e1, unit, lane);
    if (!DIRECT_V) copy_rows(&sv[0][0], ROW, V, T, DH, c0, e1, unit, lane);
    const int s0 = c0 / se * se;  // the scales' span [s0, s1)
    if (QUANT) {
      const int s1 = min((e1 + se - 1) / se * se, T);
      copy_rows(reinterpret_cast<unsigned char*>(ss), SPAN * 4, SK, T, 1, s0, s1, s_unit, lane);
      copy_rows(reinterpret_cast<unsigned char*>(ss + SPAN), SPAN * 4, SV, T, 1, s0, s1, s_unit,
                lane);
    }
    const int span_bytes = (e1 - c0) * (int)sizeof(Tc);
    uint4 vr[2][C::V_UNITS];
    if (DIRECT_V) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint4* src = reinterpret_cast<const uint4*>(V + (size_t)(lane + 32 * r) * T + c0);
#pragma unroll
        for (int u = 0; u < C::V_UNITS; ++u)
          vr[r][u] = 16 * u < span_bytes ? __ldg(src + u) : make_uint4(0, 0, 0, 0);
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    const int quads = (e1 - c0 + 3) / 4;
    if (!DIRECT_V) {
      // past the span, up to the last quad: zero bytes (V is read by whole quads)
      const int tail = 4 * quads * (int)sizeof(Tc) - span_bytes;
      for (int i = lane; i < DH * tail; i += 32) sv[i % DH][span_bytes + i / DH] = 0;
    }
    __syncwarp();

    // scores of positions c0 + 4j .. c0 + 4j + 3: each quad has `parts` lanes
    // (j, j + qp, ...), each summing `prows` of the 64 rows, added by shuffles
    const int qp = quads > 1 ? 1 << (32 - __clz(quads - 1)) : 1;
    const int parts = 32 / qp, prows = DH / parts;
    const int j = lane & (qp - 1), part = lane / qp;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < quads && !empty) {
#pragma unroll 4
      for (int d = part * prows; d < (part + 1) * prows; ++d) {
        const float4 kd = load4<Tc>(sk[d], j);
        const float qd = sq[d];
        s.x = fmaf(qd, kd.x, s.x);
        s.y = fmaf(qd, kd.y, s.y);
        s.z = fmaf(qd, kd.z, s.z);
        s.w = fmaf(qd, kd.w, s.w);
      }
    }
    for (int off = qp; off < 32; off <<= 1) {
      s.x += __shfl_xor_sync(0xffffffffu, s.x, off);
      s.y += __shfl_xor_sync(0xffffffffu, s.y, off);
      s.z += __shfl_xor_sync(0xffffffffu, s.z, off);
      s.w += __shfl_xor_sync(0xffffffffu, s.w, off);
    }
    float cmax = -INFINITY;
    if (lane < quads) {  // part 0
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = c0 + 4 * lane + e;
        const float dot_e = e == 0 ? s.x : e == 1 ? s.y : e == 2 ? s.z : s.w;
        float x = QUANT ? dot_e * ss[t - s0] * scale : dot_e * scale;
        if (empty) x = 0.f;
        x = (t >= lo_c && t < c1) ? x : -INFINITY;
        sw[4 * lane + e] = x;
        cmax = fmaxf(cmax, x);
      }
    }
    cmax = warp_max(cmax);  // finite: c0 <= hi, so the chunk holds a visible key
    const float m_new = fmaxf(m, cmax);
    const float corr = expf(m - m_new);
    float csum = 0.f;
    if (lane < quads) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = c0 + 4 * lane + e;
        const bool vis = t >= lo_c && t < c1;
        const float p = vis ? expf(sw[4 * lane + e] - m_new) : 0.f;
        csum += p;
        sw[4 * lane + e] = QUANT ? (vis ? p * ss[SPAN + t - s0] : 0.f) : p;
      }
    }
    l = l * corr + warp_sum(csum);
    m = m_new;
    __syncwarp();

    // weighted V rows: lane d owns outputs d and d + 32
    acc0 *= corr;
    acc1 *= corr;
    const float4* w4 = reinterpret_cast<const float4*>(sw);
    if (DIRECT_V) {
#pragma unroll
      for (int u = 0; u < C::V_UNITS; ++u) {
#pragma unroll
        for (int qq = 0; qq < QPU; ++qq) {
          if (u * QPU + qq < quads) {
            const float4 p = w4[u * QPU + qq];
            acc0 = dot(p, quad_of<Tc>(vr[0][u], qq), acc0);
            acc1 = dot(p, quad_of<Tc>(vr[1][u], qq), acc1);
          }
        }
      }
    } else {
      for (int jj = 0; jj < quads; ++jj) {
        const float4 p = w4[jj];
        acc0 = dot(p, load4<Tc>(sv[lane], jj), acc0);
        acc1 = dot(p, load4<Tc>(sv[lane + 32], jj), acc1);
      }
    }
    __syncwarp();  // the next chunk overwrites the warp's shared memory
  }

  if (warps == 1) {
    store(out + bh * DH + lane, acc0 / l);
    store(out + bh * DH + lane + 32, acc1 / l);
    return;
  }
  // merge the warps through their weight slots: m, l, then the 64 outputs;
  // a warp without a chunk has m = -inf, l = 0, acc = 0
  if (lane == 0) {
    sw[0] = m;
    sw[1] = l;
  }
  sw[2 + lane] = acc0;
  sw[2 + lane + 32] = acc1;
  __syncthreads();
  if (warp == 0) {
    auto slot = [&](int w) {
      return reinterpret_cast<const float*>(smem + w * WB + DH * ROW * (DIRECT_V ? 1 : 2)) +
             (QUANT ? 2 * SPAN : 0);
    };
    float M = -INFINITY;
    for (int w = 0; w < warps; ++w) M = fmaxf(M, slot(w)[0]);
    float L = 0.f, o0 = 0.f, o1 = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float* mw = slot(w);
      const float f = expf(mw[0] - M);
      L += mw[1] * f;
      o0 += mw[2 + lane] * f;
      o1 += mw[2 + lane + 32] * f;
    }
    store(out + bh * DH + lane, o0 / L);
    store(out + bh * DH + lane + 32, o1 / L);
  }
}

// The widest copy unit (bytes, at most 16) that divides every address and
// row stride given.
int unit_of(std::initializer_list<unsigned long long> xs) {
  int u = 16;
  for (unsigned long long x : xs)
    while (x % u) u >>= 1;
  return u;
}

template <typename Tq, typename Tc, bool QUANT, bool DIRECT_V, int CB>
int launch_as(const void* q, const void* k, const void* v, long long kv_stride,
              const void* ks, const void* vs, long long s_stride, void* out,
              const void* offsets, const void* pads, long long offset, int BH, int H, int T,
              float scale, int unit, int s_unit, int sms, void* stream) {
  using C = Chunk<CB>;
  constexpr int WB = C::bytes(!DIRECT_V, QUANT);
  auto kernel = self_decode_kernel<Tq, Tc, QUANT, DIRECT_V, CB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         C::MAX_WARPS * WB);
  if (err != cudaSuccess) return (int)err;
  // a warp a chunk of the widest window the call can have: T, or at a scalar
  // offset the positions up to it (rows with empty windows span T, and
  // their warps take several chunks each); fewer where the blocks would not
  // all fit on the card at once, down to one warp a row
  static int fit[C::MAX_WARPS + 1];  // blocks an SM holds at w warps a block
  constexpr int CH = CB / (int)sizeof(Tc);
  const long long span = (offsets || offset < 0) ? T : (offset < T ? offset + 1 : T);
  const long long chunks = (span + CH - 1) / CH;
  int warps = chunks < C::MAX_WARPS ? (int)chunks : C::MAX_WARPS;
  for (; warps > 1; --warps) {
    if (!fit[warps]) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit[warps], kernel, 32 * warps,
                                                          (size_t)warps * WB);
      if (err != cudaSuccess) return (int)err;
    }
    if ((long long)fit[warps] * sms >= BH) break;
  }
  self_decode_kernel<Tq, Tc, QUANT, DIRECT_V, CB>
      <<<BH, 32 * warps, (size_t)warps * WB, (cudaStream_t)stream>>>(
          (const Tq*)q, (const Tc*)k, (const Tc*)v, kv_stride, (const float*)ks,
          (const float*)vs, s_stride, (Tq*)out, (const long long*)offsets,
          (const long long*)pads, offset, H, T, scale, unit, s_unit);
  return (int)cudaGetLastError();
}

template <typename Tq, typename Tc, bool QUANT>
int launch(const void* q, const void* k, const void* v, long long kv_stride,
           const void* ks, const void* vs, long long s_stride, void* out,
           const void* offsets, const void* pads, long long offset, int BH, int H,
           int T, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int unit = unit_of({(unsigned long long)k, (unsigned long long)v,
                            (unsigned long long)T * sizeof(Tc)});
  const int s_unit = QUANT ? unit_of({(unsigned long long)ks, (unsigned long long)vs,
                                      (unsigned long long)T * 4})
                           : 4;
  if (unit < (int)sizeof(Tc) || s_unit < 4) return (int)cudaErrorMisalignedAddress;
  // fewer (batch, head) rows than four an SM: the launch is latency-bound, so
  // 64-byte chunks give a row twice the warps; else 128-byte chunks keep the
  // blocks small enough for one wave
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const bool fine = BH < 4 * sms;
#define SELF_DECODE_LAUNCH(DIRECT, CB)                                                      \
  launch_as<Tq, Tc, QUANT, DIRECT, CB>(q, k, v, kv_stride, ks, vs, s_stride, out, offsets, \
                                       pads, offset, BH, H, T, scale, unit, s_unit, sms, stream)
  if (unit == 16) return fine ? SELF_DECODE_LAUNCH(true, 64) : SELF_DECODE_LAUNCH(true, 128);
  return fine ? SELF_DECODE_LAUNCH(false, 64) : SELF_DECODE_LAUNCH(false, 128);
#undef SELF_DECODE_LAUNCH
}

}  // namespace

// Float cache. q, out: (B*H, dh); k, v: (B*H, dh, T), all in the same dtype.
// offsets, pads: (B,) int64 or null (then every row attends to
// [0, offset]). Returns a cudaError_t.
extern "C" int self_attention_decode_bf16(const void* q, const void* k, const void* v,
                                          void* out, const void* offsets,
                                          const void* pads, long long offset, int BH,
                                          int H, int T, float scale, int device,
                                          void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16, false>(
      q, k, v, (long long)DH * T, nullptr, nullptr, 0, out, offsets, pads, offset, BH,
      H, T, scale, device, stream);
}

extern "C" int self_attention_decode_f32(const void* q, const void* k, const void* v,
                                         void* out, const void* offsets,
                                         const void* pads, long long offset, int BH,
                                         int H, int T, float scale, int device,
                                         void* stream) {
  return launch<float, float, false>(q, k, v, (long long)DH * T, nullptr, nullptr, 0,
                                     out, offsets, pads, offset, BH, H, T, scale,
                                     device, stream);
}

// Int8 cache. kvq: (B*H, 2, dh, T) int8; kvs: (B*H, 2, T) fp32; q, out:
// (B*H, dh) bf16 or fp32. offsets, pads as above.
extern "C" int self_attention_decode_int8_bf16(const void* q, const void* kvq,
                                               const void* kvs, void* out,
                                               const void* offsets, const void* pads,
                                               long long offset, int BH, int H, int T,
                                               float scale, int device, void* stream) {
  const int8_t* k = (const int8_t*)kvq;
  const float* s = (const float*)kvs;
  return launch<__nv_bfloat16, int8_t, true>(
      q, k, k + (size_t)DH * T, 2LL * DH * T, s, s + T, 2LL * T, out, offsets, pads,
      offset, BH, H, T, scale, device, stream);
}

extern "C" int self_attention_decode_int8_f32(const void* q, const void* kvq,
                                              const void* kvs, void* out,
                                              const void* offsets, const void* pads,
                                              long long offset, int BH, int H, int T,
                                              float scale, int device, void* stream) {
  const int8_t* k = (const int8_t*)kvq;
  const float* s = (const float*)kvs;
  return launch<float, int8_t, true>(q, k, k + (size_t)DH * T, 2LL * DH * T, s, s + T,
                                     2LL * T, out, offsets, pads, offset, BH, H, T,
                                     scale, device, stream);
}
