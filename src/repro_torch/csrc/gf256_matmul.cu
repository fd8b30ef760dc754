// GF(256) matrix product C[m, L] = A[m, k] (x) B[k, L], polynomial 0x11D,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gf256_matmul/kernel.py
// (gf2_bitsliced_matmul, body _gf2_matmul_kernel), which turns the product
// into a 0/1 f32 matmul on the MXU over the 8m x 8k bit matrix of A. This
// kernel computes the field product itself, with log/antilog tables.
//
// What bounds it on the card: the (k + m) * L bytes it must move, at
// 3.35 TB/s, are the floor; the table lookups (k * L logs plus m * k * L
// antilogs, each a byte from shared memory) are the work. With the shapes
// of the storage path (k = 6, m <= 6) the lookups, not device memory, set
// the pace of this first, simple version.
//
// Design:
//  * The 1024-byte antilog table (EXP, zero past index 508), the 256-entry
//    log table and the logs of A's m * k entries live in shared memory. A
//    zero operand has the sentinel log 511, so every sum that involves a
//    zero lands in the zero half of EXP: the inner loop has no branch on
//    the data. A zero entry of A (common in decode matrices, whose rows of
//    the identity are mostly zeros) skips its row with a warp-uniform test.
//  * Each thread owns a strip of 16 consecutive columns. It reads each of
//    the k input rows once (one 16-byte load where the row is aligned and
//    the strip full; byte loads with a mask otherwise), takes the 16 logs,
//    and XOR-accumulates up to 8 output rows in registers; more output rows
//    take further passes over the strip (which then hits L1/L2).
//  * Any L works, with no padding; the ragged last strip is masked.
// The caller (ops.py) handles m == 0, k == 0 and L == 0 without a launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = 16;      // columns per thread
constexpr int kRowBlock = 8;    // output rows accumulated in registers
constexpr int kExpSize = 1024;  // EXP[0..508] real, the rest zero
constexpr uint16_t kZeroLog = 511;

__device__ __forceinline__ void load_strip(const uint8_t* src, int ncols, uint32_t w[4]) {
  if (ncols == kStrip && (reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
  w[0] = w[1] = w[2] = w[3] = 0u;
  for (int j = 0; j < ncols; ++j) {
    w[j >> 2] |= static_cast<uint32_t>(src[j]) << (8 * (j & 3));
  }
}

__device__ __forceinline__ void store_strip(uint8_t* dst, int ncols, const uint32_t w[4]) {
  if (ncols == kStrip && (reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
  for (int j = 0; j < ncols; ++j) {
    dst[j] = static_cast<uint8_t>(w[j >> 2] >> (8 * (j & 3)));
  }
}

__global__ void __launch_bounds__(kThreads)
gf256_matmul_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
                    uint8_t* __restrict__ C, int64_t m, int64_t k, int64_t L,
                    const uint8_t* __restrict__ exp_table,
                    const uint16_t* __restrict__ log_table) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* s_exp = smem;
  uint16_t* s_log = reinterpret_cast<uint16_t*>(smem + kExpSize);
  uint16_t* s_loga = s_log + 256;

  for (int i = threadIdx.x; i < kExpSize; i += kThreads) s_exp[i] = exp_table[i];
  for (int i = threadIdx.x; i < 256; i += kThreads) s_log[i] = log_table[i];
  __syncthreads();
  for (int64_t i = threadIdx.x; i < m * k; i += kThreads) s_loga[i] = s_log[A[i]];
  __syncthreads();

  const int64_t c0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * kStrip;
  if (c0 >= L) return;
  const int ncols = static_cast<int>(L - c0 < kStrip ? L - c0 : kStrip);

  for (int64_t i0 = 0; i0 < m; i0 += kRowBlock) {
    const int rows = static_cast<int>(m - i0 < kRowBlock ? m - i0 : kRowBlock);
    uint32_t acc[kRowBlock][4];
#pragma unroll
    for (int i = 0; i < kRowBlock; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0u;

    for (int64_t r = 0; r < k; ++r) {
      uint32_t w[4];
      load_strip(B + r * L + c0, ncols, w);
      uint16_t lb[kStrip];
#pragma unroll
      for (int j = 0; j < kStrip; ++j) lb[j] = s_log[(w[j >> 2] >> (8 * (j & 3))) & 0xFFu];
#pragma unroll
      for (int i = 0; i < kRowBlock; ++i) {
        if (i >= rows) break;
        const uint16_t la = s_loga[(i0 + i) * k + r];
        if (la == kZeroLog) continue;  // A[i0 + i, r] == 0: same for the whole block
#pragma unroll
        for (int j = 0; j < kStrip; ++j) {
          acc[i][j >> 2] ^= static_cast<uint32_t>(s_exp[la + lb[j]]) << (8 * (j & 3));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowBlock; ++i) {
      if (i >= rows) break;
      store_strip(C + (i0 + i) * L + c0, ncols, acc[i]);
    }
  }
}

}  // namespace

// A: (m, k), B: (k, L), C: (m, L), all uint8, contiguous, on the device.
// exp_table: 1024 bytes; log_table: 256 uint16 with log_table[0] == 511.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int gf256_matmul_launch(const void* A, const void* B, void* C, int64_t m,
                                   int64_t k, int64_t L, const void* exp_table,
                                   const void* log_table, void* stream) {
  const size_t smem = kExpSize + 256 * sizeof(uint16_t) + static_cast<size_t>(m * k) * sizeof(uint16_t);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gf256_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t per_block = static_cast<int64_t>(kThreads) * kStrip;
  const unsigned blocks = static_cast<unsigned>((L + per_block - 1) / per_block);
  gf256_matmul_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(A), static_cast<const uint8_t*>(B), static_cast<uint8_t*>(C), m, k, L,
      static_cast<const uint8_t*>(exp_table), static_cast<const uint16_t*>(log_table));
  return static_cast<int>(cudaGetLastError());
}
