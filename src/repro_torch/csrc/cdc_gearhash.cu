// Gear hash of a byte stream and its content-defined-chunking boundary
// bitmap, for NVIDIA Hopper (sm_90a).
//
//   h[i] = sum_{j < 32} gear(x[i - j]) << j   (mod 2^32),  x[p < 0] = 0 byte
//   bitmap[i] = (h[i] & mask) == 0
//
// Replaces the TPU kernel src/repro/kernels/cdc_gearhash/kernel.py
// (gearhash_pallas, body _gearhash_kernel, mixer gear_mix), which sums the
// 32-term window at every position and stitches each block's 31-byte halo
// from the previous block passed in a second time.
//
// What bounds it on the card: memory, for the full form. Each position
// reads 1 byte and writes 5 (a uint32 hash and a uint8 flag): 6 bytes a
// position at 3.35 TB/s, 0.9616 ms at the 512 MiB path; on an H100 (700 W)
// it takes 1.17 ms (82 % of that). The bitmap-only form, which the chunker
// launches (nothing reads the hash there), moves 2 bytes a position
// (0.3205 ms) and takes 0.41 ms (78 %): there its ~12 integer operations a
// position (the mixer, the roll, the carry, the flag) cost about as much as
// its bytes. The window form this replaced re-summed all 32 terms of every
// position from shared memory, 17 G lane loads at the 512 MiB path, and
// took 2.44 ms.
//
// Design: the hash rolls. h[i] = 2 h[i-1] + gear(x[i]) (mod 2^32), because
// the term gear(x[i-32]) << 32 vanishes mod 2^32. Each warp walks one span
// of kSpan consecutive positions in steps of 512, 16 a lane (one 16-byte
// load, the next step's issued before this step's work). A lane mixes its
// 16 bytes with gear() in registers and rolls them from 0: its local sums
// l[j]. Two shuffles then carry the true hash in: the hash at a lane's last
// position is l[15] + (the previous lane's l[15] << 16) (whatever lies
// further back is shifted by >= 32 and vanishes), and position j adds (the
// previous lane's true last hash) << (j + 1), a shift of 1..16. Lane 0
// takes the carry from lane 31 of the previous step, so the window's
// warm-up happens once a span: the 32 lanes mix the 32 bytes before the
// span and add gear(x) << lane with one warp reduction. Bytes before
// position 0 are zero bytes, whose gear(0) != 0, as the reference pads.
// A lane's 16 flags are one 16-byte store. Its 16 hashes go through shared
// memory first, so that each of the warp's four hash stores writes 512
// bytes in a row: stored straight from registers (four 16-byte words 64
// bytes apart a lane) the full form took 1.87 ms (storage_ablate.py).
// Only the last lane of the stream, when L is not a multiple of 16, loads
// and stores byte by byte. The wrapper (ops.py) passes a 16-byte-aligned
// stream and a null hash pointer for the bitmap-only form.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;
constexpr int kPerLane = 16;                // positions a lane rolls per step
constexpr int kStep = kLanes * kPerLane;    // 512 positions a warp per step
constexpr int kSteps = 16;                  // steps per span
constexpr int64_t kSpan = int64_t{kStep} * kSteps;
constexpr int kWarps = kThreads / kLanes;
constexpr int kRowWords = kPerLane + 4;     // a lane's hashes in shared memory, padded
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t gear_mix(uint32_t v) {
  v = (v + 0x9E3779B9u) * 0x85EBCA6Bu;
  v ^= v >> 15;
  v *= 0xC2B2AE35u;
  v ^= v >> 13;
  return v;
}

// The 16 bytes at data[p, p + 16), zero past L.
__device__ __forceinline__ uint4 load16(const uint8_t* data, int64_t L, int64_t p) {
  if (p + kPerLane <= L) return *reinterpret_cast<const uint4*>(data + p);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int j = 0; j < kPerLane && p + j < L; ++j) {
    w[j >> 2] |= static_cast<uint32_t>(data[p + j]) << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool kHash>
__global__ void __launch_bounds__(kThreads)
gearhash_kernel(const uint8_t* __restrict__ data, uint32_t* __restrict__ hash,
                uint8_t* __restrict__ bitmap, int64_t L, uint32_t mask) {
  // a warp's hashes of one step, to store them as whole 512-byte runs
  __shared__ __align__(16) uint32_t s_hash[kHash ? kWarps : 1][kLanes * kRowWords];
  uint32_t* staged = s_hash[kHash ? threadIdx.x / kLanes : 0];
  const int lane = threadIdx.x & (kLanes - 1);
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kLanes;
  const int64_t start = warp * kSpan;
  if (start >= L) return;  // the whole warp
  const int64_t end = start + kSpan < L ? start + kSpan : L;

  // warm-up: the true hash at start - 1
  const int64_t before = start - 1 - lane;
  const uint32_t xb = before >= 0 ? static_cast<uint32_t>(data[before]) : 0u;
  uint32_t carry = __reduce_add_sync(kFull, gear_mix(xb) << lane);

  uint4 next = load16(data, L, start + kPerLane * lane);
  for (int64_t base = start; base < end; base += kStep) {
    const int64_t p = base + kPerLane * lane;
    const uint4 cur = next;
    if (base + kStep < end) next = load16(data, L, p + kStep);
    const uint32_t words[4] = {cur.x, cur.y, cur.z, cur.w};
    uint32_t h[kPerLane];
    uint32_t run = 0u;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      run = (run << 1) + gear_mix((words[j >> 2] >> (8 * (j & 3))) & 0xFFu);
      h[j] = run;
    }
    uint32_t up = __shfl_up_sync(kFull, h[kPerLane - 1], 1);
    if (lane == 0) up = carry;
    const uint32_t last = h[kPerLane - 1] + (up << 16);  // the true hash at p + 15
    uint32_t prev = __shfl_up_sync(kFull, last, 1);
    if (lane == 0) prev = carry;
    carry = __shfl_sync(kFull, last, kLanes - 1);
    uint32_t flags[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      h[j] += prev << (j + 1);  // j + 1 <= 16: no shift reaches 32
      flags[j >> 2] |= static_cast<uint32_t>((h[j] & mask) == 0u) << (8 * (j & 3));
    }
    if (kHash) {
      // through shared memory: lane t then stores positions 128 q + 4 t .. + 3
      // of the step, so that each store instruction writes 512 bytes in a row
      uint4* mine = reinterpret_cast<uint4*>(staged + lane * kRowWords);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        mine[q] = make_uint4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = 128 * q + 4 * lane;  // position in the step
        const uint4 v = *reinterpret_cast<const uint4*>(staged + (i >> 4) * kRowWords + (i & 15));
        if (base + i + 4 <= L) {
          *reinterpret_cast<uint4*>(hash + base + i) = v;
        } else {
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
          for (int j = 0; j < 4 && base + i + j < L; ++j) hash[base + i + j] = w[j];
        }
      }
      __syncwarp();  // read before the next step writes
    }
    if (p + kPerLane <= L) {
      *reinterpret_cast<uint4*>(bitmap + p) = make_uint4(flags[0], flags[1], flags[2], flags[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) {
        if (p + j < L) bitmap[p + j] = static_cast<uint8_t>(flags[j >> 2] >> (8 * (j & 3)));
      }
    }
  }
}

}  // namespace

// data: (L,) uint8, 16-byte aligned; hash: (L,) uint32 or null for the
// bitmap-only form; bitmap: (L,) uint8; contiguous, on the device, L > 0.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int gearhash_launch(const void* data, void* hash, void* bitmap, int64_t L,
                               uint32_t mask, void* stream) {
  const int64_t warps = (L + kSpan - 1) / kSpan;
  const int64_t per_block = kThreads / kLanes;
  const unsigned blocks = static_cast<unsigned>((warps + per_block - 1) / per_block);
  const auto* in = static_cast<const uint8_t*>(data);
  auto* flags = static_cast<uint8_t*>(bitmap);
  auto* s = static_cast<cudaStream_t>(stream);
  if (hash != nullptr) {
    auto* out = static_cast<uint32_t*>(hash);
    gearhash_kernel<true><<<blocks, kThreads, 0, s>>>(in, out, flags, L, mask);
  } else {
    gearhash_kernel<false><<<blocks, kThreads, 0, s>>>(in, nullptr, flags, L, mask);
  }
  return static_cast<int>(cudaGetLastError());
}
