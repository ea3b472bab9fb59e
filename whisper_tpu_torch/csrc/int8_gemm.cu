// Int8 x int8 -> int32 GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel benchmarks/int8_gemm_probe.py:make_pallas_gemm:
// C (M, N) int32 = A (M, K) int8 @ B (K, N) int8, the product under the
// W8A8 encoder's every projection and MLP matmul (_linear_a8 in
// whisper_tpu_torch/models/model.py). This kernel takes B K-MAJOR, as
// B_t (N, K) row-major: the int8 tensor-core fragments (and Hopper's wgmma
// for 8-bit types) want B's contraction dim contiguous, and ldmatrix has no
// transposing form for 8-bit data. Each weight is laid out K-major once,
// in place of its (K, N) row-major payload (QTensor.k_major in
// whisper_tpu_torch/ops/quant.py).
//
// What bounds it on the card. At the turbo encoder's batch 64 (M = 96,000):
// the 1280 -> 1280 products by bytes (123 MB of A in, 491.5 MB of int32
// out: 0.184 ms at 3.35 TB/s against 0.159 ms of operations at 1,979
// TOP/s), the 1280 <-> 5120 MLP products by operations (0.636 ms).
//
// What the design does about it: the smallest kernel that is right and not
// naive, built on mma.sync (wgmma and TMA are later work).
//   - A 128 x 128 block tile, a K step of 64, 8 warps as 2 (M) x 4 (N), each
//     warp a 64 x 32 tile: 4 x 4 mma.sync.m16n8k32 s8 tiles, 64 int32
//     accumulators a thread.
//   - 16-byte cp.async loads into two shared-memory stages (double
//     buffering), so the next K step's tiles load while this one computes.
//   - ldmatrix.x4 for every fragment: an 8 x 16-byte matrix of int8 has the
//     byte layout of an 8 x 8 matrix of b16, which is what the s8 m16n8k32
//     fragments want, for A (row-major) and for B_t (K-major).
//   - Shared rows are 64 bytes; the four 16-byte chunks of row r are stored
//     XOR-swizzled by (r >> 1) & 3, so each ldmatrix phase (8 rows of one
//     chunk) hits 32 distinct banks.
//   - Ragged edges: rows of A past M and of B_t past N load as zeros
//     (cp.async with a source size of 0) and are never stored; K % 16 == 0,
//     so a 16-byte chunk past K is all past K and loads as zeros.
// |sum| <= K * 127^2 = 8.3e7 at K = 5120: int32 does not overflow.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// C interface, loaded with ctypes (whisper_tpu_torch/ops/int8_gemm.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;  // bytes of K per stage row
constexpr int THREADS = 256;
constexpr int WARP_M = 64;  // rows of a warp's tile
constexpr int WARP_N = 32;
constexpr int MT = WARP_M / 16;  // m16 tiles of a warp
constexpr int NT = WARP_N / 8;   // n8 tiles of a warp
constexpr int STAGE_BYTES = BM * BK;  // A and B_t tiles are each 128 x 64 bytes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// byte offset of 16-byte chunk c of tile row r, swizzled
__device__ __forceinline__ int swz(int r, int c) { return r * BK + ((c ^ ((r >> 1) & 3)) << 4); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage: the block's 128 x 64-byte tiles of A (rows m0..) and B_t (rows
// n0..) at K offset k0; each thread starts 2 + 2 16-byte copies.
__device__ __forceinline__ void load_stage(int8_t* sA, int8_t* sB, const int8_t* A,
                                           const int8_t* Bt, int M, int N, int K, int m0,
                                           int n0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * THREADS;  // 0..511: 128 rows x 4 chunks
    const int r = idx >> 2, c = idx & 3;
    const int k = k0 + c * 16;
    const bool kin = k < K;
    const int am = m0 + r, bn = n0 + r;
    const bool av = kin && am < M, bv = kin && bn < N;
    cp_async16(smem_addr(sA + swz(r, c)), A + (av ? (size_t)am * K + k : 0), av);
    cp_async16(smem_addr(sB + swz(r, c)), Bt + (bv ? (size_t)bn * K + k : 0), bv);
  }
}

__global__ void __launch_bounds__(THREADS)
int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Bt,
                 int32_t* __restrict__ C, int M, int N, int K) {
  __shared__ __align__(128) int8_t smem[2][2][STAGE_BYTES];  // [stage][A, B_t]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nk = (K + BK - 1) / BK;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load_stage(smem[0][0], smem[0][1], A, Bt, M, N, K, m0, n0, 0, tid);
  asm volatile("cp.async.commit_group;\n" ::);

  // ldmatrix row/chunk of this lane: matrix q = lane >> 3, row lane & 7
  const int q = lane >> 3, r8 = lane & 7;
  const int a_row = wm * WARP_M + r8 + (q & 1) * 8, a_chunk = q >> 1;
  const int b_row = wn * WARP_N + r8 + (q >> 1) * 8, b_chunk = q & 1;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt & 1;
    if (kt + 1 < nk)
      load_stage(smem[s ^ 1][0], smem[s ^ 1][1], A, Bt, M, N, K, m0, n0, (kt + 1) * BK, tid);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);  // this stage's copies have landed
    __syncthreads();

    const int8_t* sA = smem[s][0];
    const int8_t* sB = smem[s][1];
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {  // two k32 steps per stage
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(smem_addr(sA + swz(a_row + i * 16, kk * 2 + a_chunk)), af[i][0], af[i][1],
                    af[i][2], af[i][3]);
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)  // one x4 covers two n8 tiles
        ldmatrix_x4(smem_addr(sB + swz(b_row + j * 16, kk * 2 + b_chunk)), bf[2 * j][0],
                    bf[2 * j][1], bf[2 * j + 1][0], bf[2 * j + 1][1]);
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
    __syncthreads();  // the stage is free for the load two steps on
  }

  // epilogue: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g + 8
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + wn * WARP_N + j * 8 + 2 * t;
      if (n >= N) continue;  // N % 8 == 0: an n8 tile is all in or all out
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * WARP_M + i * 16 + g + h * 8;
        if (m < M)
          *reinterpret_cast<int2*>(C + (size_t)m * N + n) =
              make_int2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
  }
}

}  // namespace

// A (M, K) int8 row-major, Bt (N, K) int8 row-major (B K-major), C (M, N)
// int32 row-major; K % 16 == 0, N % 8 == 0, 16-byte aligned pointers.
// Returns a cudaError_t.
extern "C" int int8_gemm_kmajor(const void* A, const void* Bt, void* C, int M, int N, int K,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)A, (const int8_t*)Bt, (int32_t*)C, M, N, K);
  return (int)cudaGetLastError();
}
