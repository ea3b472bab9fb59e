// Int8 x int8 GEMM for Hopper (sm_90a): TMA loads into an mbarrier ring,
// wgmma on int8, two schedules of the same product, and two epilogues.
//
// Replaces the TPU kernel benchmarks/int8_gemm_probe.py:make_pallas_gemm:
// C (M, N) int32 = A (M, K) int8 @ B (K, N) int8, the product under every
// W8A8 linear (_linear_a8 in whisper_tpu_torch/models/model.py): the
// Whisper encoder's projections and MLP, and every linear of the omni
// language model (models/omni.py). The W8A8 linear's scale epilogue, which
// XLA fuses around the dot (whisper_tpu/models/model.py _linear_a8), is
// fused in as the second epilogue:
//   int32 out:  C = acc;
//   scaled out: C = cast(cast((float(acc) * sx[m]) * ws[n]) + bias[n]),
//               fp32 or bf16, bit-equal to the PyTorch epilogue
//               (ops/int8_gemm.py scale_epilogue): both products are
//               __fmul_rn (no FMA contraction), bf16 is rounded before the
//               bias add and again after it, as `.to(bf16) + b.to(bf16)`.
// B is read K-MAJOR, as B_t (N, K) row-major: 8-bit wgmma takes only
// K-major operands, and QTensor.k_major (ops/quant.py) lays each weight out
// so once. The wrapper picks the schedule from the shape alone
// (ops/int8_gemm.py split_plan): the persistent one for M > 128, and for
// the products of at most 128 rows whose persistent tiles already keep
// every SM streaming (the omni head's 594); the split-K one for the other
// products of at most 128 rows. Integer sums are exact in any order, so
// both give the same bits.
//
// What bounds it on the card:
//   - at the turbo encoder's batch 64 (M = 96,000): the 1280 -> 1280
//     products by operations with a bf16 output (0.159 ms at 1,979 TOP/s
//     against 0.110 ms of bytes at 3.35 TB/s), by bytes with an int32 one
//     (491.5 MB of output: 0.184 ms); the 1280 <-> 5120 MLP products by
//     operations (0.636 ms);
//   - at M <= 128 (the omni decode's 64 rows): bytes. The weight is read
//     once and each of its bytes takes part in 2M operations, 128 at
//     M = 64, where the card balances at 591; the decode's seven products
//     read 12.8 to 545 MB of weight, 4.2 to 175 us at 3.35 TB/s. Their
//     persistent tiles of 128 x 256 are half padding, and so few of them
//     (14 at N = 3,584) stream the weight through as few SMs.
//
// The persistent schedule (int8_gemm_sm90):
//   - tiles of 128 x 256 outputs; two consumer warpgroups own 64 rows each
//     and issue wgmma.m64n256k32.s32.s8.s8 with A and B from shared memory
//     (a 256-wide B tile halves the shared-memory reads per product against
//     128: 10 KB a k-step for 524,288 multiply-adds);
//   - a producer warpgroup whose one thread keeps TMA loads of A (128 rows x
//     128 bytes of K) and B_t (256 rows x 128 bytes) in flight through a
//     ring of STAGES stages, each with a full barrier (the TMA's byte count)
//     and an empty barrier (one arrival per consumer warp); setmaxnreg
//     gives the producer's registers to the consumers' 128 accumulators;
//   - 2-D tensor maps with 128-byte swizzle: a 128-byte K row is one
//     swizzle row, the layout wgmma's descriptors read; rows past M or N and
//     bytes past K are zero-filled by the TMA, so any M >= 1, K % 16 == 0
//     and N % 8 == 0 run the same code, and rows and columns past the edge
//     are never stored;
//   - persistent: one block per SM walks the output tiles, the N tile
//     fastest, so the tiles in flight share their A rows in L2 (the weight,
//     at most 6.6 MB, stays in L2); the producer runs ahead into the next
//     tile's stages while the consumers run this tile's epilogue;
//   - bf16 out (the path's): the consumers write the scaled tile into
//     shared memory (four 128 x 64 boxes, 128-byte swizzled so a warp's
//     stores hit 32 banks) and one thread hands it to four TMA stores, which
//     drain while the next tile's products run; the scales and the bias are
//     read 8 column pairs at a time ahead of their use. The tile takes the
//     fourth stage's shared memory, so the ring has three. int32 and fp32
//     out (the tensor-parallel partial products, the fp32 checks) store
//     straight from the registers;
//   - one wgmma group in flight behind the one being issued (wait_group 1),
//     and the accumulators touched only between tiles, so ptxas keeps every
//     wgmma asynchronous.
//
// The split-K schedule (int8_gemm_sm90_splitk<BN>), for M <= 128:
//   - tiles of 64 rows x BN columns (BN 128 to 256), one consumer
//     warpgroup issuing wgmma.m64nBNk32.s32.s8.s8, one producer thread
//     keeping 3 to 8 stages of TMA loads in flight (A, at most 64 x 18,944
//     bytes, stays in L2; B streams from device memory);
//   - K split across the `split` CTAs of a thread-block cluster (up to 8,
//     the portable cluster size), so that a product of few tiles still puts
//     every SM on streaming its weight: CTA `rank` reads the k tiles
//     [rank * k_tiles / split, (rank + 1) * k_tiles / split), each a
//     multiple of the 128-byte stage;
//   - the slices meet exactly inside the one launch: each CTA writes its
//     int32 partial tile to its own shared memory, and CTA `rank` sums the
//     `split` partials of its 1 / split of the tile's columns through
//     distributed shared memory and runs the epilogue on them, so every
//     output is stored once, by one CTA, with the persistent schedule's
//     arithmetic. Two cluster-scope mbarriers a CTA (`ready`, `freed`)
//     order the partials; no workspace, no memset, no atomics, so a launch
//     is safe inside CUDA graph capture;
//   - the clusters walk the tiles in rounds, the producer running on into
//     the next tile's stages during this one's reduction; the wrapper's rule
//     chooses BN, the split and the clusters from the shape and the card's
//     cluster slots (GPCs hold fewer clusters of 3 to 8 than 132 / size);
// |sum| <= K * 127^2 = 3.1e8 at K = 18,944: int32 does not overflow.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C interface, loaded with ctypes (whisper_tpu_torch/ops/int8_gemm.py).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 128;  // rows of a tile: two consumer warpgroups of 64
constexpr int BN = 256;  // columns of a tile
constexpr int BK = 128;  // bytes of K per stage: one 128-byte swizzle row
constexpr int STAGES = 3;
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);  // the last warpgroup produces
constexpr int A_BYTES = BM * BK;                // 16 KB
constexpr int B_BYTES = BN * BK;                // 32 KB
constexpr int C_COLS = 64;                      // bf16 columns of a 128-byte swizzle row
constexpr int C_BYTES = BM * C_COLS * 2;        // 16 KB: one of a tile's four bf16 boxes
// registers per thread after setmaxnreg: 40 x 128 + 232 x 256 <= 65,536
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;

enum Mode { OUT_INT32 = 0, OUT_F32 = 1, OUT_BF16 = 2 };

struct Shared {
  int8_t a[STAGES][A_BYTES];
  int8_t b[STAGES][B_BYTES];
  uint8_t c[BN / C_COLS][C_BYTES];  // the bf16 output tile on its way to the TMA stores
  uint64_t full[STAGES], empty[STAGES];
};
// + 1 KB to align the tiles to the 1,024-byte period of the 128-byte swizzle
constexpr int SMEM_BYTES = sizeof(Shared) + 1024;

struct Params {
  void* out;         // (M, N) int32, fp32 or bf16
  const float* sx;   // (M,) row scales (scaled modes)
  const float* ws;   // (N,) channel scales (scaled modes)
  const void* bias;  // (N,) in the output dtype, or null
  int M, N, mode;
  int n_tiles, k_tiles, items;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
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

// One box of a 2-D tensor map (c0 = byte of K, c1 = row) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// One box of shared memory to a 2-D tensor map (c0 = column, c1 = row);
// the parts past the tensor's edges are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0,
                                          int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// wait until the committed TMA stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// wait until the committed TMA stores are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// the 256 consumer threads meet (named barrier 1; the producer is not in it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// 128-byte rows, 8-row groups 1 KB apart.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  constexpr uint64_t group = 1024 >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (group << 16) | (group << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accesses of the accumulators across the
// issue/wait pair of an asynchronous wgmma.
__device__ __forceinline__ void fence_regs(int (&r)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 256 int32) (+)= A (64 x 32 int8, smem) * B (32 x 256 int8, smem),
// both K-major; d is overwritten when `accumulate` is 0
__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]), "+r"(d[121]),
        "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// (float(acc) * sx) * ws, each product rounded on its own
__device__ __forceinline__ float scaled(int acc, float sx, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), ws);
}

// a bf16 value plus a bf16 bias (given as fp32), summed in fp32 and
// rounded once more
__device__ __forceinline__ __nv_bfloat16 add_bf16(__nv_bfloat16 y, float b) {
  return __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), b));
}

// The channel scales ws and the bias (as fp32: exact for a bf16 one) of the
// column pairs n0 + 8j + 2t, j = j0 .. j0 + 7, loaded before any of their
// stores, so the loads' latency is paid 4 times a tile, not behind every
// store; zeros past N.
__device__ __forceinline__ void load_columns(const Params& p, int j0, int n0, int t,
                                             float2 (&ws)[8], float2 (&bias)[8]) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int n = n0 + 8 * (j0 + jj) + 2 * t;
    ws[jj] = bias[jj] = make_float2(0.f, 0.f);
    if (n >= p.N) continue;
    ws[jj] = __ldg(reinterpret_cast<const float2*>(p.ws + n));
    if (p.bias == nullptr) continue;
    if (p.mode == OUT_F32) {
      bias[jj] = __ldg(reinterpret_cast<const float2*>(static_cast<const float*>(p.bias) + n));
    } else {
      const unsigned int raw = __ldg(reinterpret_cast<const unsigned int*>(
          static_cast<const __nv_bfloat16*>(p.bias) + n));
      bias[jj] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
    }
  }
}

// int32 and fp32 out: write the accumulators of one thread, rows r0 and
// r0 + 8, columns n0 + 8j + 2t and + 1 (j < 32), straight to memory.
__device__ __forceinline__ void epilogue_direct(const Params& p, const int (&acc)[128], int r0,
                                                int n0, int t) {
  const int M = p.M, N = p.N;
  const bool live[2] = {r0 < M, r0 + 8 < M};
  if (p.mode == OUT_INT32) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!live[h]) continue;
      int* out = static_cast<int*>(p.out) + (size_t)(r0 + 8 * h) * N;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        if (n < N)  // N % 8 == 0: an 8-column group is all in or all out
          *reinterpret_cast<int2*>(out + n) = make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    return;
  }
  const float sx[2] = {live[0] ? __ldg(p.sx + r0) : 0.f, live[1] ? __ldg(p.sx + r0 + 8) : 0.f};
#pragma unroll
  for (int j0 = 0; j0 < 32; j0 += 8) {
    float2 ws[8], bias[8];
    load_columns(p, j0, n0, t, ws, bias);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = j0 + jj, n = n0 + 8 * j + 2 * t;
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!live[h]) continue;
        float2 y = make_float2(scaled(acc[4 * j + 2 * h], sx[h], ws[jj].x),
                               scaled(acc[4 * j + 2 * h + 1], sx[h], ws[jj].y));
        if (p.bias != nullptr)
          y = make_float2(__fadd_rn(y.x, bias[jj].x), __fadd_rn(y.y, bias[jj].y));
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + (size_t)(r0 + 8 * h) * N + n) = y;
      }
    }
  }
}

// bf16 out (the path's): write one thread's scaled values, rows rl and
// rl + 8 of the tile (global row r0, r0 + 8), into the shared tile: box
// j0 / 8 holds columns j0 * 8 .. + 63, 128-byte rows whose 16-byte chunks
// are swizzled by the row (chunk ^ row % 8, the TMA's 128-byte swizzle), so
// the 8 rows of a warp's store hit 32 distinct banks. Rows past M and
// columns past N hold zeros or garbage; the TMA store does not write them.
__device__ __forceinline__ void epilogue_shared(const Params& p, const int (&acc)[128], int r0,
                                                int rl, int n0, int t, Shared& sh) {
  const bool live[2] = {r0 < p.M, r0 + 8 < p.M};
  const float sx[2] = {live[0] ? __ldg(p.sx + r0) : 0.f, live[1] ? __ldg(p.sx + r0 + 8) : 0.f};
#pragma unroll
  for (int j0 = 0; j0 < 32; j0 += 8) {
    float2 ws[8], bias[8];
    load_columns(p, j0, n0, t, ws, bias);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = j0 + jj;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162 y;
        y.x = __float2bfloat16_rn(scaled(acc[4 * j + 2 * h], sx[h], ws[jj].x));
        y.y = __float2bfloat16_rn(scaled(acc[4 * j + 2 * h + 1], sx[h], ws[jj].y));
        if (p.bias != nullptr) {
          y.x = add_bf16(y.x, bias[jj].x);
          y.y = add_bf16(y.y, bias[jj].y);
        }
        const int row = rl + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(&sh.c[j0 / 8][row * 128 + ((jj ^ (row & 7)) << 4) +
                                                         4 * t]) = y;
      }
    }
  }
}

// Persistent: each block walks the output tiles blockIdx.x, + gridDim.x, ...
// (tile t: rows (t / n_tiles) * BM, columns (t % n_tiles) * BN).
__global__ void __launch_bounds__(THREADS, 1)
int8_gemm_sm90(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
               const __grid_constant__ CUtensorMap map_c, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  Shared& sh = *reinterpret_cast<Shared*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sh.full[s], 1);
      mbar_init(&sh.empty[s], 4 * CONSUMERS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {
    // ---- producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 128 * CONSUMERS) {
      int it = 0;  // k tiles loaded so far
      for (int t = blockIdx.x; t < p.items; t += gridDim.x) {
        const int m0 = (t / p.n_tiles) * BM, n0 = (t % p.n_tiles) * BN;
        for (int kt = 0; kt < p.k_tiles; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&sh.empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&sh.full[s], A_BYTES + B_BYTES);
          tma_load(sh.a[s], &map_a, &sh.full[s], kt * BK, m0);
          tma_load(sh.b[s], &map_b, &sh.full[s], kt * BK, n0);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows of the tile each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = warp >> 2;
    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    int it = 0;  // k tiles consumed so far
    for (int t = blockIdx.x; t < p.items; t += gridDim.x) {
      const int m0 = (t / p.n_tiles) * BM, n0 = (t % p.n_tiles) * BN;
      for (int kt = 0; kt < p.k_tiles; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&sh.full[s], (it / STAGES) & 1);
        const uint32_t a = smem_u32(sh.a[s]) + wg * 64 * BK, b = smem_u32(sh.b[s]);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BK / 32; ++ks)
          wgmma_s8(acc, desc_sw128(a + ks * 32), desc_sw128(b + ks * 32), kt > 0 || ks > 0);
        wgmma_commit();
        fence_regs(acc);
        // the previous k tile's products are done: its stage is free
        wgmma_wait<1>();
        fence_regs(acc);
        if (kt > 0 && lane == 0) mbar_arrive(&sh.empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&sh.empty[(it - 1) % STAGES]);
      const int rl = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // this thread's row in the tile
      if (p.mode != OUT_BF16) {
        epilogue_direct(p, acc, m0 + rl, n0, lane & 3);
        continue;
      }
      // bf16: through the shared tile, then four TMA stores that drain
      // while the next tile's products run
      if (tid == 0) bulk_wait_read();  // the last tile's stores have read it
      consumers_sync();
      epilogue_shared(p, acc, m0 + rl, rl, n0, lane & 3, sh);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the TMA
      consumers_sync();
      if (tid == 0) {
#pragma unroll
        for (int i = 0; i < BN / C_COLS; ++i)
          if (n0 + i * C_COLS < p.N) tma_store(&map_c, sh.c[i], n0 + i * C_COLS, m0);
        bulk_commit();
      }
    }
    if (tid == 0) bulk_wait();
  }
}

// ---- the split-K schedule, for products of at most 128 rows
//
// A grid of clusters of `split` CTAs walks the 64 x BN output tiles (tile
// u: rows (u / n_tiles) * 64, columns (u % n_tiles) * BN), cluster c the
// tiles c, c + clusters, ...; CTA `rank` of a cluster takes the k tiles
// [rank * k_tiles / split, (rank + 1) * k_tiles / split) of each. One
// consumer warpgroup issues wgmma.m64nBNk32, one producer thread keeps the
// ring's TMA loads in flight, running on into the next tile's while the
// consumers finish this one. A finished tile's int32 partial goes into
// the CTA's partial buffer; CTA `rank` then sums the `split` partials of
// its share of the tile's columns, read through distributed shared memory,
// and runs the epilogue on them. Two cluster-scope mbarriers in each CTA
// order it: `ready` (every CTA's partial of the tile is written) and
// `freed` (every CTA has read this one's), each taking one arrival from
// each CTA of the cluster a tile. No CTA leaves before its last partial
// has been read.
namespace splitk {

constexpr int BM = 64;        // rows of a tile: one consumer warpgroup
constexpr int THREADS = 256;  // warpgroup 0 consumes, warpgroup 1 produces
constexpr int A_BYTES = BM * BK;
constexpr int MAX_SPLIT = 8;  // CTAs of a cluster: the portable most
constexpr int MAX_STAGES = 8;
// shared memory a block may opt into, less the 1,024-byte alignment pad
// and the barriers
constexpr int SMEM_ROOM = 232448 - 1024 - 256;

template <int BN>
struct Tile {
  static constexpr int B_BYTES = BN * BK;
  // int32 row stride of the partial tile: 8 more than BN, so that the 8
  // rows of a warp's fragment store start 32 bytes apart in the banks
  static constexpr int LD = BN + 8;
  static constexpr int FIT = (SMEM_ROOM - BM * LD * 4) / (A_BYTES + B_BYTES);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
};

template <int BN>
struct Shared {
  int8_t a[Tile<BN>::STAGES][A_BYTES];
  int8_t b[Tile<BN>::STAGES][Tile<BN>::B_BYTES];
  int part[BM][Tile<BN>::LD];  // this CTA's partial tile
  uint64_t full[Tile<BN>::STAGES], empty[Tile<BN>::STAGES];
  uint64_t ready, freed;
};

struct Params {
  void* out;         // (M, N) int32, fp32 or bf16
  const float* sx;   // (M,) row scales (scaled modes)
  const float* ws;   // (N,) channel scales (scaled modes)
  const void* bias;  // (N,) in the output dtype, or null
  int M, N, mode, k_tiles, split, n_tiles, units;  // units: m tiles x n tiles
};

// the whole cluster meets (every thread)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the consumer warpgroup's 128 threads meet (named barrier 1)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// the shared::cluster address of `p`'s counterpart in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t peer(uint32_t p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(p), "r"(rank));
  return out;
}

// one arrival on a barrier anywhere in the cluster, releasing to the
// cluster what this thread wrote or saw written
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait for the phase of parity `parity` of a barrier of this CTA, acquiring
// what the arrivals released to the cluster
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// d (64 x 128 int32) (+)= A (64 x 32 int8, smem) * B (32 x 128 int8, smem), both
// K-major; d is overwritten when `accumulate` is 0
__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 160 int32) (+)= A (64 x 32 int8, smem) * B (32 x 160 int8, smem), both
// K-major; d is overwritten when `accumulate` is 0
__device__ __forceinline__ void wgmma_s8_n160(int (&d)[80], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 192 int32) (+)= A (64 x 32 int8, smem) * B (32 x 192 int8, smem), both
// K-major; d is overwritten when `accumulate` is 0
__device__ __forceinline__ void wgmma_s8_n192(int (&d)[96], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 224 int32) (+)= A (64 x 32 int8, smem) * B (32 x 224 int8, smem), both
// K-major; d is overwritten when `accumulate` is 0
__device__ __forceinline__ void wgmma_s8_n224(int (&d)[112], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, "
      "%103, %104, %105, %106, %107, %108, %109, %110, %111"
      "}, %112, %113, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
        "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]),
        "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]),
        "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
        "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]), "+r"(d[97]),
        "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x BN) (+)= A (64 x 32) * B (32 x BN): one wgmma of the tile's width
template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint32_t a, uint32_t b,
                                           int accumulate) {
  if constexpr (BN == 256) {
    wgmma_s8(d, desc_sw128(a), desc_sw128(b), accumulate);
  } else if constexpr (BN == 224) {
    wgmma_s8_n224(d, desc_sw128(a), desc_sw128(b), accumulate);
  } else if constexpr (BN == 192) {
    wgmma_s8_n192(d, desc_sw128(a), desc_sw128(b), accumulate);
  } else if constexpr (BN == 160) {
    wgmma_s8_n160(d, desc_sw128(a), desc_sw128(b), accumulate);
  } else {
    static_assert(BN == 128, "tile widths: 128, 160, 192, 224, 256");
    wgmma_s8_n128(d, desc_sw128(a), desc_sw128(b), accumulate);
  }
}

template <int R>
__device__ __forceinline__ void fence_acc(int (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The channel scales and the bias (as fp32: exact for a bf16 one) of
// columns n .. n + 3 (n % 4 == 0, all inside N), loaded once a tile.
struct Quad {
  float ws[4], bias[4];
};

__device__ __forceinline__ Quad load_quad(const Params& p, int n) {
  Quad c = {};
  if (p.mode == OUT_INT32) return c;
  const float2 w0 = __ldg(reinterpret_cast<const float2*>(p.ws + n));
  const float2 w1 = __ldg(reinterpret_cast<const float2*>(p.ws + n + 2));
  c.ws[0] = w0.x, c.ws[1] = w0.y, c.ws[2] = w1.x, c.ws[3] = w1.y;
  if (p.bias == nullptr) return c;
  if (p.mode == OUT_F32) {
    const float* b = static_cast<const float*>(p.bias) + n;
    const float2 b0 = __ldg(reinterpret_cast<const float2*>(b));
    const float2 b1 = __ldg(reinterpret_cast<const float2*>(b + 2));
    c.bias[0] = b0.x, c.bias[1] = b0.y, c.bias[2] = b1.x, c.bias[3] = b1.y;
  } else {
    const uint2 raw =
        __ldg(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p.bias) + n));
    const float2 b0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    c.bias[0] = b0.x, c.bias[1] = b0.y, c.bias[2] = b1.x, c.bias[3] = b1.y;
  }
  return c;
}

// The epilogue of four summed columns n .. n + 3 of row m (`c`: theirs):
// int32 as they are, or scaled as the persistent schedule's epilogues
// scale them, bit for bit.
__device__ __forceinline__ void store_quad(const Params& p, int m, int n, const int4& s,
                                           const Quad& c) {
  const size_t at = (size_t)m * p.N + n;
  if (p.mode == OUT_INT32) {
    *reinterpret_cast<int4*>(static_cast<int*>(p.out) + at) = s;
    return;
  }
  const float sx = __ldg(p.sx + m);
  float y[4] = {scaled(s.x, sx, c.ws[0]), scaled(s.y, sx, c.ws[1]), scaled(s.z, sx, c.ws[2]),
                scaled(s.w, sx, c.ws[3])};
  if (p.mode == OUT_F32) {
    if (p.bias != nullptr)
#pragma unroll
      for (int i = 0; i < 4; ++i) y[i] = __fadd_rn(y[i], c.bias[i]);
    *reinterpret_cast<float4*>(static_cast<float*>(p.out) + at) =
        make_float4(y[0], y[1], y[2], y[3]);
    return;
  }
  __nv_bfloat162 h[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    h[i].x = __float2bfloat16_rn(y[2 * i]);
    h[i].y = __float2bfloat16_rn(y[2 * i + 1]);
    if (p.bias != nullptr) {
      h[i].x = add_bf16(h[i].x, c.bias[2 * i]);
      h[i].y = add_bf16(h[i].y, c.bias[2 * i + 1]);
    }
  }
  *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out) + at) =
      make_uint2(*reinterpret_cast<const unsigned int*>(&h[0]),
                 *reinterpret_cast<const unsigned int*>(&h[1]));
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
int8_gemm_sm90_splitk(const __grid_constant__ CUtensorMap map_a,
                      const __grid_constant__ CUtensorMap map_b, const Params p) {
  constexpr int STAGES = Tile<BN>::STAGES;
  extern __shared__ uint8_t smem_raw[];
  Shared<BN>& sh = *reinterpret_cast<Shared<BN>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int split = p.split, cluster = blockIdx.x / split, clusters = gridDim.x / split;
  int rank;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int kt0 = rank * p.k_tiles / split, kt1 = (rank + 1) * p.k_tiles / split;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sh.full[s], 1);
      mbar_init(&sh.empty[s], 4);  // one arrival per consumer warp
    }
    mbar_init(&sh.ready, split);  // one arrival per CTA of the cluster
    mbar_init(&sh.freed, split);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // no CTA arrives on a peer's barrier before the peer made it

  if (warp >= 4) {
    // ---- producer warpgroup: one thread issues the slices' loads
    if (tid == 128) {
      int it = 0;  // k tiles loaded so far
      for (int u = cluster; u < p.units; u += clusters) {
        const int m0 = (u / p.n_tiles) * BM, n0 = (u % p.n_tiles) * BN;
        for (int kt = kt0; kt < kt1; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&sh.empty[s], ((it / STAGES) & 1) ^ 1);
          mbar_expect_tx(&sh.full[s], A_BYTES + Tile<BN>::B_BYTES);
          tma_load(sh.a[s], &map_a, &sh.full[s], kt * BK, m0);
          tma_load(sh.b[s], &map_b, &sh.full[s], kt * BK, n0);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup: the 64 rows x BN columns of the slice
  const int r = (warp & 3) * 16 + (lane >> 2), t = lane & 3;  // rows r, r + 8
  // this CTA sums and stores the column groups of 8 [g0, g1) of each tile,
  // in pieces of 4 columns: thread `tid` the piece `tid % quads` of rows
  // tid / quads, + rstep, ... (the threads past quads x rstep idle)
  constexpr int GROUPS = BN / 8;
  const int g0 = rank * GROUPS / split, g1 = (rank + 1) * GROUPS / split;
  const int quads = 2 * (g1 - g0), rstep = 128 / quads, r0 = tid / quads;
  const int col = 8 * g0 + 4 * (tid % quads);
  cg::cluster_group cl = cg::this_cluster();
  const uint32_t ready = smem_u32(&sh.ready), freed = smem_u32(&sh.freed);
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  int it = 0, j = 0;  // k tiles consumed, output tiles finished
  for (int u = cluster; u < p.units; u += clusters, ++j) {
    const int m0 = (u / p.n_tiles) * BM, n0 = (u % p.n_tiles) * BN;
    for (int kt = kt0; kt < kt1; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(&sh.full[s], (it / STAGES) & 1);
      const uint32_t a = smem_u32(sh.a[s]), b = smem_u32(sh.b[s]);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 32; ++ks)
        wgmma_tile<BN>(acc, a + ks * 32, b + ks * 32, kt > kt0 || ks > 0);
      wgmma_commit();
      fence_acc(acc);
      // the previous k tile's products are done: its stage is free
      wgmma_wait<1>();
      fence_acc(acc);
      if (kt > kt0 && lane == 0) mbar_arrive(&sh.empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&sh.empty[(it - 1) % STAGES]);

    // every CTA has read this CTA's partial of the last tile
    if (j > 0) mbar_wait_cluster(&sh.freed, (j - 1) & 1);
#pragma unroll
    for (int c = 0; c < BN / 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<int2*>(&sh.part[r + 8 * h][8 * c + 2 * t]) =
            make_int2(acc[4 * c + 2 * h], acc[4 * c + 2 * h + 1]);
    consumer_sync();
    if (tid < split) mbar_arrive_remote(peer(ready, tid));
    const int n = n0 + col;
    const bool mine = r0 < rstep && n < p.N;  // N % 8 == 0: all 4 columns in or all out
    const Quad cq = mine ? load_quad(p, n) : Quad{};
    mbar_wait_cluster(&sh.ready, j & 1);  // every CTA's partial of this tile is written

    // ROWS rows at a time, every partial of each loaded before any sum is stored
    constexpr int ROWS = 4;
    for (int row = r0; mine && row < BM; row += ROWS * rstep) {
      int4 sum[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        sum[k] = make_int4(0, 0, 0, 0);
        const int rr = row + k * rstep;
        if (rr >= BM || m0 + rr >= p.M) continue;
#pragma unroll
        for (int q = 0; q < MAX_SPLIT; ++q) {
          if (q >= split) break;
          const int4 v = *cl.map_shared_rank(reinterpret_cast<int4*>(&sh.part[rr][col]), q);
          sum[k].x += v.x;
          sum[k].y += v.y;
          sum[k].z += v.z;
          sum[k].w += v.w;
        }
      }
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const int rr = row + k * rstep;
        if (rr < BM && m0 + rr < p.M) store_quad(p, m0 + rr, n, sum[k], cq);
      }
    }
    consumer_sync();  // this CTA has read every partial of the tile
    if (tid < split) mbar_arrive_remote(peer(freed, tid));
  }
  if (j > 0) mbar_wait_cluster(&sh.freed, (j - 1) & 1);  // no peer reads this CTA any more
}

}  // namespace splitk

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A 2-D tensor map over (cols, rows) of `dtype` elements of `elem` bytes,
// rows `cols * elem` bytes apart, with (box_cols, box_rows) boxes, 128-byte
// swizzle (box_cols * elem = 128) and zero fill outside. Returns 0, a
// cudaError_t (> 0), or -CUresult of the encode.
int make_map(CUtensorMap* map, CUtensorMapDataType dtype, int elem, const void* base, int cols,
             int rows, cuuint32_t box_cols, cuuint32_t box_rows) {
  // cuTensorMapEncodeTiled through the runtime's entry-point lookup: no -lcuda
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {box_cols, box_rows}, unit[2] = {1, 1};
  const CUresult res = encode(map, dtype, 2, const_cast<void*>(base), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -(int)res;
}

}  // namespace

// A (M, K) int8 row-major, Bt (N, K) int8 row-major (B K-major), both
// 16-byte aligned; K % 16 == 0, N % 8 == 0, M >= 1. mode 0: out (M, N)
// int32 (sx, ws, bias unused); mode 1 / 2: out (M, N) fp32 / bf16 from the
// fp32 row scales sx (M,) and channel scales ws (N,) and the bias (N,) in
// the output dtype, or null. Returns 0, a cudaError_t (> 0), or minus the
// CUresult of a failed tensor-map encode.
extern "C" int int8_gemm_sm90a(const void* A, const void* Bt, void* out, const void* sx,
                               const void* ws, const void* bias, int M, int N, int K, int mode,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap ma, mb, mc;
  int rc = make_map(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, A, K, M, BK, BM);
  if (rc == 0) rc = make_map(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, Bt, K, N, BK, BN);
  if (rc == 0)  // the bf16 output's map (only the bf16 mode stores through it)
    rc = mode == OUT_BF16
             ? make_map(&mc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, out, N, M, C_COLS, BM)
             : make_map(&mc, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, A, K, M, BK, BM);
  if (rc != 0) return rc;
  Params p{out, static_cast<const float*>(sx), static_cast<const float*>(ws), bias, M, N, mode};
  p.n_tiles = (N + BN - 1) / BN;
  p.k_tiles = (K + BK - 1) / BK;
  p.items = ((M + BM - 1) / BM) * p.n_tiles;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(int8_gemm_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int8_gemm_sm90<<<p.items < sms ? p.items : sms, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      ma, mb, mc, p);
  return (int)cudaGetLastError();
}


namespace {

template <int BN>
cudaError_t splitk_config(int split, cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1]) {
  auto kernel = splitk::int8_gemm_sm90_splitk<BN>;
  constexpr int smem = (int)sizeof(splitk::Shared<BN>) + 1024;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cfg.blockDim = dim3(splitk::THREADS);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return err;
}

template <int BN>
int splitk_launch(const CUtensorMap& ma, const CUtensorMap& mb, const splitk::Params& p,
                  int ctas, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = splitk_config<BN>(p.split, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, splitk::int8_gemm_sm90_splitk<BN>, ma, mb, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int BN>
int splitk_slots(int split, int* clusters) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = splitk_config<BN>(split, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = dim3((unsigned)split);
  return (int)cudaOccupancyMaxActiveClusters(clusters, splitk::int8_gemm_sm90_splitk<BN>, &cfg);
}

}  // namespace

// The split-K schedule of the same product (the wrapper's rule chooses it
// for M <= 128): A, Bt, out, sx, ws, bias, M, N, K and mode as in
// int8_gemm_sm90a; tiles of 64 rows x `bn` columns (bn 128, 160, 192, 224
// or 256), each summed over `split` K slices by a cluster of `split` CTAs
// (1 <= split <= 8 and <= the k tiles), `ctas` CTAs in all (a multiple of
// `split`; the clusters walk the tiles). Returns 0, a cudaError_t (> 0),
// or minus the CUresult of a failed tensor-map encode.
extern "C" int int8_gemm_sm90a_splitk(const void* A, const void* Bt, void* out, const void* sx,
                                      const void* ws, const void* bias, int M, int N, int K,
                                      int mode, int bn, int split, int ctas, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int k_tiles = (K + BK - 1) / BK;
  if (split < 1 || split > splitk::MAX_SPLIT || split > k_tiles || ctas < split ||
      ctas % split)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  int rc = make_map(&ma, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, A, K, M, BK, splitk::BM);
  if (rc == 0) rc = make_map(&mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, Bt, K, N, BK, bn);
  if (rc != 0) return rc;
  const int n_tiles = (N + bn - 1) / bn;
  const splitk::Params p{out, static_cast<const float*>(sx), static_cast<const float*>(ws),
                         bias, M, N, mode, k_tiles, split, n_tiles,
                         n_tiles * ((M + splitk::BM - 1) / splitk::BM)};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (bn) {
    case 128: return splitk_launch<128>(ma, mb, p, ctas, s);
    case 160: return splitk_launch<160>(ma, mb, p, ctas, s);
    case 192: return splitk_launch<192>(ma, mb, p, ctas, s);
    case 224: return splitk_launch<224>(ma, mb, p, ctas, s);
    case 256: return splitk_launch<256>(ma, mb, p, ctas, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// How many clusters of `split` CTAs of the split-K kernel at tile width
// `bn` the card holds at once (cudaOccupancyMaxActiveClusters), into
// *clusters. Returns 0 or a cudaError_t.
extern "C" int int8_gemm_splitk_slots(int bn, int split, int device, int* clusters) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (bn) {
    case 128: return splitk_slots<128>(split, clusters);
    case 160: return splitk_slots<160>(split, clusters);
    case 192: return splitk_slots<192>(split, clusters);
    case 224: return splitk_slots<224>(split, clusters);
    case 256: return splitk_slots<256>(split, clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}
