// Gear hash of a byte stream and its content-defined-chunking boundary
// bitmap, for NVIDIA Hopper (sm_90a).
//
//   h[i] = sum_{j < 32} gear(x[i - j]) << j   (mod 2^32),  x[p < 0] = 0 byte
//   bitmap[i] = (h[i] & mask) == 0
//
// Replaces the TPU kernel src/repro/kernels/cdc_gearhash/kernel.py
// (gearhash_pallas, body _gearhash_kernel, mixer gear_mix), which stitches
// each block's 31-byte halo from the previous block passed in a second time.
//
// What bounds it on the card: memory. Each position reads 1 byte and writes
// 5 (a uint32 hash and a uint8 flag): 6 bytes a position at 3.35 TB/s. The
// mixer and the 32 shifted adds are integer work on data already on chip.
//
// Design: a block of 256 threads owns a tile of 2048 positions. It stages
// the tile's bytes and the 31-byte halo before it (2079 bytes) in shared
// memory, each already mixed by gear() to a uint32, so gear() runs once per
// staged byte. Positions before 0 stage gear(0), not 0: the reference pads
// with zero *bytes* before mixing, and gear(0) != 0. Each thread then sums
// the 32 shifted terms for 8 positions, strided by 256 so that neighbouring
// threads read neighbouring words and write neighbouring outputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 32;
constexpr int kThreads = 256;
constexpr int kTile = 2048;

__device__ __forceinline__ uint32_t gear_mix(uint32_t v) {
  v = (v + 0x9E3779B9u) * 0x85EBCA6Bu;
  v ^= v >> 15;
  v *= 0xC2B2AE35u;
  v ^= v >> 13;
  return v;
}

__global__ void __launch_bounds__(kThreads)
gearhash_kernel(const uint8_t* __restrict__ data, uint32_t* __restrict__ hash,
                uint8_t* __restrict__ bitmap, int64_t L, uint32_t mask) {
  __shared__ uint32_t g[kTile + kWindow - 1];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int s = threadIdx.x; s < kTile + kWindow - 1; s += kThreads) {
    const int64_t p = base - (kWindow - 1) + s;
    const uint32_t x = (p >= 0 && p < L) ? static_cast<uint32_t>(data[p]) : 0u;
    g[s] = gear_mix(x);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kTile; t += kThreads) {
    const int64_t i = base + t;
    if (i >= L) break;
    uint32_t h = 0u;
#pragma unroll
    for (int j = 0; j < kWindow; ++j) h += g[t + kWindow - 1 - j] << j;
    hash[i] = h;
    bitmap[i] = static_cast<uint8_t>((h & mask) == 0u);
  }
}

}  // namespace

// data: (L,) uint8; hash: (L,) uint32; bitmap: (L,) uint8; contiguous, on
// the device, L > 0. Launches on `stream` and returns cudaGetLastError().
extern "C" int gearhash_launch(const void* data, void* hash, void* bitmap, int64_t L,
                               uint32_t mask, void* stream) {
  const unsigned blocks = static_cast<unsigned>((L + kTile - 1) / kTile);
  gearhash_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<uint32_t*>(hash), static_cast<uint8_t*>(bitmap), L,
      mask);
  return static_cast<int>(cudaGetLastError());
}
