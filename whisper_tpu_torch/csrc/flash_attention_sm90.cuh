// Bidirectional bf16 attention with head dim 64 for Hopper (sm_90a): TMA
// loads into a ring of shared-memory stages, mbarriers, and wgmma on 64-row
// warpgroup tiles. One kernel body serves both encoder attention kernels:
//   - flash_attention_btd.cu (K1): q, k, v, o (B, T, D), head h = columns
//     h*64 .. h*64+63;
//   - flash_attention.cu (K6): q, o (B*H, Tq, 64) and k, v (B*H, Tk, 64).
// Each of those files builds its own tensor maps (make_map) and launches
// the kernel here (launch); only the addressing differs.
//
// What bounds it on the card: operations (turbo B64: 7.4e11 FLOP against
// 983 MB). At head dim 64 the softmax's exponentials cost the SM about as
// many cycles as the two products (per 64 x 128 tile of one warpgroup:
// 8,192 MUFU.EX2 at 16 a clock against 2.1 MFLOP at ~4,096 a clock), so
// the tensor cores idle unless one warpgroup's softmax overlaps another's
// products; and every block reads its head's whole K and V from L2.
//
// Design (the Findings of PERF.md hold the measurements behind each choice):
//   - a block holds 192 query rows: consumer warpgroups 0-2 own 64 rows
//     each (fewer blocks per head than 128 rows: a third less L2 traffic);
//     warpgroup 3 is the producer, whose one thread issues every TMA load
//     (setmaxnreg gives its registers to the consumers);
//   - persistent: one block per SM walks the work tiles in the grid's
//     order (q tile fastest, so a head's q tiles run together and share
//     its K/V in L2); Q is double-buffered, so the producer loads the next
//     tile's Q and K/V during this tile's last products and epilogue;
//   - K and V stream in tiles of 128 keys through a ring of STAGES stages,
//     each with a full barrier per operand (the TMA's transaction count)
//     and one empty barrier (one arrival per consumer warp);
//   - the tensor maps are 3-D (columns, rows, batch row or head) with
//     128-byte swizzle, so a 64-column bf16 row is one swizzle row, the
//     layout wgmma's descriptors read, and rows past T inside one batch row
//     are zero-filled by the TMA instead of read from the next batch row;
//   - S = Q K^T: wgmma m64n128k16, A = Q and B = K from shared memory, both
//     K-major (dh contiguous), four k-steps over dh;
//   - O += P V: wgmma m64n64k16, A = P from registers (the fp32 accumulator
//     layout of S packed to bf16 pairs is the A-fragment layout), B = V from
//     shared memory MN-major (the transpose bit), eight k-steps of 16 keys;
//   - a warpgroup issues S of tile i+1 and P V of tile i together, then
//     turns S into weights while P V runs; the warpgroups take those issue
//     turns round robin (named barriers), so their softmaxes interleave
//     with each other's products instead of falling into step;
//   - numerics as before: log2-domain online softmax with fp32 running max
//     and denominator per row, keys >= Tk masked to -inf (last tile only:
//     zero-filled keys would score 0), P rounded to bf16 unnormalised before
//     P V, one division at the end, rows >= Tq never written.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fa_sm90 {

typedef __nv_bfloat16 bf16;

constexpr int DH = 64;         // head dim of every Whisper size
constexpr int CONSUMERS = 3;   // consumer warpgroups
constexpr int WG_ROWS = 64;    // query rows per consumer warpgroup, and per Q box
constexpr int BQ = WG_ROWS * CONSUMERS;  // query rows per block
constexpr int BK = 128;        // keys per K/V stage
constexpr int STAGES = 3;      // K/V ring depth
constexpr int THREADS = 128 * (CONSUMERS + 1);  // the last warpgroup produces
constexpr int ROW_BYTES = DH * 2;            // 128 B: one swizzle row
constexpr int TILE_BYTES = BK * ROW_BYTES;   // 16 KB: one K or V stage
// registers per thread after setmaxnreg: the producer gives its share to the
// consumers (3 consumers: 24 x 128 + 160 x 384 <= 65,536)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 160;

struct Shared {
  bf16 q[2][BQ * DH];  // this work tile's Q and the next one's
  bf16 k[STAGES][BK * DH];
  bf16 v[STAGES][BK * DH];
  uint64_t full_k[STAGES], full_v[STAGES], empty[STAGES], q_full[2], q_empty[2];
};
// + 1 KB to align the tiles to the 1,024-byte period of the 128-byte swizzle
constexpr int SMEM_BYTES = sizeof(Shared) + 1024;

// A work tile is (q tile x, head or batch*head y, batch row z), x fastest, so
// the q tiles of one head run together and share its K/V in L2.
struct Params {
  int Tq, Tk;          // query and key rows
  int col_step;        // column offset per y (K1: 64, head h; K6: 0)
  int z_from_y;        // third map coordinate: 1 = y (K6), 0 = z (K1)
  long long o_zstride; // output elements between batch rows (K1) or heads (K6)
  long long o_rstride; // output elements between rows
  float scale_log2;    // dh^-0.5 * log2(e)
  int q_tiles, ny, items;  // work tiles: x extent, y extent, x * y * z (set by launch)
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

// One box of a 3-D tensor map into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major tiles (Q, K)
// use only the 8-row group stride (1 KB); for the MN-major V tile the N
// extent is one swizzle atom (64 columns), so the leading offset is unused
// and both offsets are set to the 8-row group stride.
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

// Named barriers 1 .. CONSUMERS order the consumer warpgroups' turns at the
// tensor cores, round robin: warpgroup w waits on barrier 1 + w, and the
// warpgroup before it arrives there when its own products are issued.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (wg + 1) % CONSUMERS) : "memory");
}

// Keep the compiler from moving accesses of registers that an asynchronous
// wgmma reads or writes across the issue/wait pair.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" : "+r"(r[i][0]), "+r"(r[i][1]), "+r"(r[i][2]), "+r"(r[i][3])::"memory");
}

// d (64 x 128 fp32) (+)= A (64 x 16, smem) * B (16 x 128, smem), both K-major
__device__ __forceinline__ void wgmma_s(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 fp32) += A (64 x 16 bf16, registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_o(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the MUFU, subnormal results flushed to 0 (exp2f adds a range
// check and two multiplies around the same instruction)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x 128) = Q (this warpgroup's 64 rows) K^T (128 keys): four k-steps
// of 16 over dh, committed as one group. The register fences on both sides
// keep the compiler from touching S while the wgmmas own it.
__device__ __forceinline__ void issue_scores(float (&sc)[64], uint32_t q_addr, uint32_t k_addr) {
  fence_regs(sc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
    wgmma_s(sc, desc_sw128(q_addr + ks * 32), desc_sw128(k_addr + ks * 32), ks > 0);
  wgmma_commit();
  fence_regs(sc);
}

// O (64 x 64) += P (64 x 128, bf16 A fragments in registers) V (128 keys):
// eight k-steps of 16 keys, committed as one group
__device__ __forceinline__ void issue_output(float (&acc)[32], uint32_t (&pa)[8][4],
                                             uint32_t v_addr) {
  fence_regs(pa);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks)
    wgmma_o(acc, pa[ks], desc_sw128(v_addr + ks * 16 * ROW_BYTES));
  wgmma_commit();
  fence_regs(acc);
  fence_regs(pa);
}

// Online softmax state of a thread's two rows (g and g+8 of its warp).
struct Softmax {
  float m0, m1;  // running max of raw scores
  float l0, l1;  // this thread's part of the denominators
  float scale_log2;
  int Tk, tg;

  // Turn the raw scores of the tile starting at key k0 into unnormalised
  // weights in place: keys >= Tk (last tile only) masked to -inf, new
  // maxima, exp2 in the log2 domain, denominators updated. Returns the
  // factors (rows g, g+8) by which O of the earlier tiles must be scaled.
  __device__ __forceinline__ float2 tile(float (&sc)[64], int k0) {
    if (k0 + BK > Tk) {
#pragma unroll
      for (int e = 0; e < 64; ++e)
        if (k0 + (e >> 2) * 8 + tg * 2 + (e & 1) >= Tk) sc[e] = -INFINITY;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // the first tile always holds a valid key, so mx is finite from here on
    const float2 c = make_float2(ex2((m0 - mx0) * scale_log2), ex2((m1 - mx1) * scale_log2));
    m0 = mx0;
    m1 = mx1;
    const float ms0 = mx0 * scale_log2, ms1 = mx1 * scale_log2;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -ms0));
      sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -ms0));
      sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -ms1));
      sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -ms1));
      rs0 += sc[4 * j] + sc[4 * j + 1];
      rs1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * c.x + rs0;
    l1 = l1 * c.y + rs1;
    return c;
  }
};

// P as bf16 A fragments: n8 tiles 2ks and 2ks+1 of S form k-step ks (the
// fp32 accumulator layout of S packed to bf16 pairs is the register
// A-fragment layout)
__device__ __forceinline__ void pack_weights(const float (&sc)[64], uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    pa[ks][0] = pack_bf16(sc[8 * ks], sc[8 * ks + 1]);
    pa[ks][1] = pack_bf16(sc[8 * ks + 2], sc[8 * ks + 3]);
    pa[ks][2] = pack_bf16(sc[8 * ks + 4], sc[8 * ks + 5]);
    pa[ks][3] = pack_bf16(sc[8 * ks + 6], sc[8 * ks + 7]);
  }
}

__device__ __forceinline__ void work_tile(const Params& p, int t, int& q0, int& col, int& z) {
  const int yz = t / p.q_tiles, y = yz % p.ny;
  q0 = (t % p.q_tiles) * BQ;
  col = y * p.col_step;
  z = p.z_from_y ? y : yz / p.ny;
}

// Persistent: each block walks the work tiles blockIdx.x, + gridDim.x, ...
// The producer runs ahead into the next tile (Q double-buffered, the K/V
// ring continuing), so one tile's loads overlap the last one's epilogue.
__global__ void __launch_bounds__(THREADS, 1)
attn_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
            const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o, const Params p) {
  extern __shared__ uint8_t smem_raw[];
  Shared& sh = *reinterpret_cast<Shared*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (p.Tk + BK - 1) / BK;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sh.full_k[s], 1);
      mbar_init(&sh.full_v[s], 1);
      mbar_init(&sh.empty[s], 4 * CONSUMERS);  // one arrival per consumer warp
    }
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      mbar_init(&sh.q_full[b], 1);
      mbar_init(&sh.q_empty[b], 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * CONSUMERS) {
    // ---- producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == 128 * CONSUMERS) {
      int kv = 0, it = 0;  // K/V tiles and work tiles loaded so far
      for (int t = blockIdx.x; t < p.items; t += gridDim.x, ++it) {
        int q0, col, z;
        work_tile(p, t, q0, col, z);
        const int qb = it & 1;
        mbar_wait(&sh.q_empty[qb], ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(&sh.q_full[qb], BQ * ROW_BYTES);
#pragma unroll
        for (int w = 0; w < CONSUMERS; ++w)
          tma_load(sh.q[qb] + w * WG_ROWS * DH, &map_q, &sh.q_full[qb], col,
                   q0 + w * WG_ROWS, z);
        for (int i = 0; i < n_tiles; ++i, ++kv) {
          const int s = kv % STAGES;
          mbar_wait(&sh.empty[s], ((kv / STAGES) & 1) ^ 1);
          mbar_expect_tx(&sh.full_k[s], TILE_BYTES);
          tma_load(sh.k[s], &map_k, &sh.full_k[s], col, i * BK, z);
          mbar_expect_tx(&sh.full_v[s], TILE_BYTES);
          tma_load(sh.v[s], &map_v, &sh.full_v[s], col, i * BK, z);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each. Tile i's O += P V runs
    // on the tensor cores while this warpgroup turns tile i+1's scores,
    // issued just before it, into weights.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = warp >> 2, g = lane >> 2, tg = lane & 3;
    float acc[32];      // O: rows g, g+8 of this warp x 8 column tiles of 8
    float sc[64];       // S, then the unnormalised weights, of one tile
    uint32_t pa[8][4];  // P as bf16 A fragments

    int kv = 0, it = 0;  // K/V tiles and work tiles consumed so far
    for (int t = blockIdx.x; t < p.items; t += gridDim.x, ++it, kv += n_tiles) {
      int q0, col, z;
      work_tile(p, t, q0, col, z);
      const int qb = it & 1;
      const uint32_t q_addr = smem_u32(sh.q[qb]) + wg * WG_ROWS * ROW_BYTES;
      Softmax sm{-INFINITY, -INFINITY, 0.f, 0.f, p.scale_log2, p.Tk, tg};
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = 0.f;

      mbar_wait(&sh.q_full[qb], (it >> 1) & 1);
      mbar_wait(&sh.full_k[kv % STAGES], (kv / STAGES) & 1);
      issue_scores(sc, q_addr, smem_u32(sh.k[kv % STAGES]));
      wgmma_wait<0>();
      fence_regs(sc);
      sm.tile(sc, 0);  // corrections of an empty O do not matter
      pack_weights(sc, pa);

      // every K/V tile but the last: issue S of tile i+1 and O += P V of
      // tile i, then the softmax of tile i+1 while P V runs. The warpgroups
      // take turns to issue (warpgroup 0 first), so one's softmax (exp2 on
      // the MUFU, as many cycles as the products at dh = 64) overlaps the
      // others' products instead of all waiting on the same tile at once.
      if (wg == CONSUMERS - 1) turn_pass(wg);
      for (int i = 0; i + 1 < n_tiles; ++i) {
        const int s = (kv + i) % STAGES, sn = (kv + i + 1) % STAGES;
        mbar_wait(&sh.full_k[sn], ((kv + i + 1) / STAGES) & 1);
        mbar_wait(&sh.full_v[s], ((kv + i) / STAGES) & 1);
        turn_wait(wg);
        issue_scores(sc, q_addr, smem_u32(sh.k[sn]));
        issue_output(acc, pa, smem_u32(sh.v[s]));
        turn_pass(wg);
        wgmma_wait<1>();  // the scores of tile i+1 (committed first)
        fence_regs(sc);
        const float2 c = sm.tile(sc, (i + 1) * BK);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(&sh.empty[s]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[4 * j] *= c.x;
          acc[4 * j + 1] *= c.x;
          acc[4 * j + 2] *= c.y;
          acc[4 * j + 3] *= c.y;
        }
        pack_weights(sc, pa);
      }
      {  // the last tile's O += P V; the last warpgroup's last pass would find no wait
        const int s = (kv + n_tiles - 1) % STAGES;
        mbar_wait(&sh.full_v[s], ((kv + n_tiles - 1) / STAGES) & 1);
        turn_wait(wg);
        issue_output(acc, pa, smem_u32(sh.v[s]));
        if (wg != CONSUMERS - 1) turn_pass(wg);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&sh.empty[s]);
          mbar_arrive(&sh.q_empty[qb]);
        }
      }

      float l0 = sm.l0, l1 = sm.l1;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      const int r0 = q0 + wg * WG_ROWS + (warp & 3) * 16 + g, r1 = r0 + 8;
      bf16* ob = o + z * p.o_zstride + col + tg * 2;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (r0 < p.Tq)
          *reinterpret_cast<uint32_t*>(ob + r0 * p.o_rstride + j * 8) =
              pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
        if (r1 < p.Tq)
          *reinterpret_cast<uint32_t*>(ob + r1 * p.o_rstride + j * 8) =
              pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A 3-D bf16 tensor map over (64-column head slices, rows, batch rows or
// heads) with (64, box_rows, 1) boxes, 128-byte swizzle and zero fill outside.
// dims = {columns, rows, depth}, strides = bytes between rows and between
// depth slices. Returns 0, a cudaError_t (> 0), or -CUresult of the encode.
inline int make_map(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[3],
                    const cuuint64_t (&strides)[2], cuuint32_t box_rows) {
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
  const cuuint32_t box[3] = {DH, box_rows, 1}, elem[3] = {1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -(int)res;
}

// work: (q tiles of BQ rows, heads or B*H, batch rows or 1), launched as at
// most one block per SM. Returns a cudaError_t.
inline int launch(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v, void* o,
                  Params p, dim3 work, cudaStream_t stream) {
  p.q_tiles = work.x;
  p.ny = work.y;
  p.items = work.x * work.y * work.z;
  if (p.items == 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  attn_kernel<<<p.items < sms ? p.items : sms, THREADS, SMEM_BYTES, stream>>>(
      q, k, v, static_cast<bf16*>(o), p);
  return (int)cudaGetLastError();
}

}  // namespace fa_sm90
