// GF(256) matrix product C[m, L] = A[m, k] (x) B[k, L], polynomial 0x11D,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gf256_matmul/kernel.py
// (gf2_bitsliced_matmul, body _gf2_matmul_kernel), which turns the product
// into a 0/1 f32 matmul on the MXU over the 8m x 8k bit matrix of A. This
// kernel uses the same linearity on the CUDA cores, on packed bytes.
//
// What bounds it on the card: the (k + m) * L bytes it must move, at
// 3.35 TB/s, are the floor: 0.2938 ms for the storage path's (5, 6) encode
// of 89478724 columns, 0.3205 ms for its (6, 6) decode. The encode is bound
// by integer issue instead: its 29 full coefficients cost 29 x 32 LOP3 per
// lane and 16 columns, plus 6 x 64 shifts and PRMTs for the planes. On an
// H100 (700 W) it takes 0.63 ms (47 % of the floor); built to take every
// nonzero coefficient as 1 (no planes, no products) it takes 0.35 ms
// (storage_ablate.py). The decode (6 full coefficients, 5 units) takes
// 0.49 ms (66 %). The table form this replaced took 1.67 ms: an antilog
// lookup in shared memory per product and a log per input byte, with bank
// conflicts, and byte-by-byte access to the rows not 16-byte aligned.
//
// Design:
//  * Multiplication by a constant a is linear over GF(2):
//    a * x = XOR_b bit_b(x) * (a * 2^b). For each input row a lane turns its
//    16 packed bytes into 8 bit planes, byte masks of 0x00 or 0xFF (a shift
//    puts bit b at bit 7 of each byte, PRMT replicates it over the byte),
//    and accumulates acc ^= plane_b & splat(a * 2^b), one LOP3 a word and a
//    plane. The planes of one input row serve every output row.
//  * A launch takes a tile of A of up to 8 output by 8 input rows; a larger
//    A is a loop of launches, each after the first XORing into C. The
//    tile's splats a * 2^b are the kernel's parameters: they sit in the
//    constant bank, every lane reads the same word, and LOP3 takes them
//    from uniform registers. Per coefficient, the same for the whole grid:
//    a = 0 skips it, a = 1 is a plain acc ^= x (the decode matrices are
//    mostly unit rows), and an input row's planes are made only if one of
//    its coefficients needs them.
//  * No table lookup per product and no byte-by-byte row. A lane owns 16
//    consecutive columns. Every input row of the tile is copied at once, as
//    aligned 16-byte words, from device memory to shared memory by cp.async
//    (all of a warp's loads in flight together), then shifted into the
//    column frame with __funnelshift_r by the row's address mod 16 (the
//    same for the whole grid). Output rows are realigned across lanes with
//    a shuffle, so that every lane stores one aligned 16-byte word; only the
//    ragged head and tail of a row (< 16 bytes each) are stored byte by
//    byte. Lane 31 has no neighbour to shuffle from, so a warp advances by
//    31 strips and its lane 31 recomputes the next warp's first strip (3 %
//    more work). An input word can reach past the row's ends; such bytes
//    only feed columns that are never stored.
//  * 80 registers and 33 KB of shared memory: 3 blocks of 256 threads an
//    SM. With 2 an SM the encode takes 0.67 ms and the decode
//    0.58 ms (storage_ablate.py): the warps' loads need the third block to
//    overlap the other warps' products.
//  * Any L works, with no padding. The caller (ops.py) handles m == 0,
//    k == 0 and L == 0 without a launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;
constexpr int kStrip = 16;                   // columns per lane: one 16-byte word
constexpr int kStripsPerWarp = kLanes - 1;   // lane 31 recomputes the next warp's lane 0
constexpr int kWarps = kThreads / kLanes;
constexpr int kTile = 8;                     // output rows and input rows of one launch
constexpr uint32_t kUnit = 0x01010101u;      // splat(1)
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

__device__ __forceinline__ uint4 shfl_down4(uint4 v) {
  return make_uint4(__shfl_down_sync(kFull, v.x, 1), __shfl_down_sync(kFull, v.y, 1),
                    __shfl_down_sync(kFull, v.z, 1), __shfl_down_sync(kFull, v.w, 1));
}

// Bytes [s, s + 16) of the 32 bytes lo ++ hi, for 0 <= s < 16 (the same in
// the whole warp): word selects, then byte shifts across word pairs.
__device__ __forceinline__ uint4 window16(uint4 lo, uint4 hi, int s) {
  uint32_t w0 = lo.x, w1 = lo.y, w2 = lo.z, w3 = lo.w, w4 = hi.x, w5 = hi.y, w6 = hi.z;
  const uint32_t w7 = hi.w;
  if (s & 4) { w0 = w1; w1 = w2; w2 = w3; w3 = w4; w4 = w5; w5 = w6; w6 = w7; }
  if (s & 8) { w0 = w2; w1 = w3; w2 = w4; w3 = w5; w4 = w6; }
  const uint32_t sh = 8u * static_cast<uint32_t>(s & 3);
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

__device__ __forceinline__ uint32_t byte_of(uint4 v, int j) {
  const uint32_t w = j < 4 ? v.x : j < 8 ? v.y : j < 12 ? v.z : v.w;
  return (w >> (8 * (j & 3))) & 0xFFu;
}

// 0xFF in each byte whose bit 7 is set, 0x00 elsewhere (PRMT's sign mode).
__device__ __forceinline__ uint32_t sign_bytes(uint32_t y) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(y), "r"(0u), "r"(0xBA98u));
  return r;
}

template <int b>
__device__ __forceinline__ uint4 plane(uint4 x) {
  return make_uint4(sign_bytes(x.x << (7 - b)), sign_bytes(x.y << (7 - b)),
                    sign_bytes(x.z << (7 - b)), sign_bytes(x.w << (7 - b)));
}

// acc ^= p & c, word by word: one LOP3 each
__device__ __forceinline__ void fma_plane(uint4& acc, uint4 p, uint32_t c) {
  acc.x ^= p.x & c; acc.y ^= p.y & c; acc.z ^= p.z & c; acc.w ^= p.w & c;
}

// Whether the aligned 16-byte word at `at` holds a byte of row[0, L).
__device__ __forceinline__ bool holds(uintptr_t row, int64_t L, uintptr_t at) {
  return at < row + static_cast<uintptr_t>(L) && at + kStrip > row;
}

// 16 bytes from global to shared memory without registers; with bytes == 0
// nothing is read and the word is zero-filled.
__device__ __forceinline__ void cp_async16(uint4* dst, uintptr_t src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

// Stage the aligned words under a warp's 32 strips of one input row into
// dst[0..32]: lane t copies the word under its first column, lane 31 also
// the word after (the 33rd), where the row is not 16-byte aligned. A word
// that holds no byte of the row is zero-filled.
__device__ __forceinline__ void stage_row(uint4* dst, const uint8_t* row, int64_t L, int64_t c0,
                                          int lane) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(row);
  const int off = static_cast<int>(lo & 15u);
  const uintptr_t at = lo + c0 - off;
  cp_async16(dst + lane, at, holds(lo, L, at) ? kStrip : 0);
  if (off != 0 && lane == kLanes - 1) {
    cp_async16(dst + kLanes, at + kStrip, holds(lo, L, at + kStrip) ? kStrip : 0);
  }
}

// Store columns [c0, c0 + 16) of an output row held in v (XOR them into
// the row's bytes for a tile after the first). Lane t stores the aligned
// word that starts h = (16 - row mod 16) mod 16 columns into its strip,
// whose end comes from lane t + 1; the strip holding column 0 also stores
// the h head columns, and a word that crosses L is cut to L.
__device__ __forceinline__ void store_row(uint8_t* row, int64_t L, int64_t c0, int lane, uint4 v,
                                          bool accumulate) {
  const int h = (kStrip - static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15u)) & 15;
  const uint4 d = h ? window16(v, shfl_down4(v), h) : v;
  if (lane == kLanes - 1) return;  // its strip is stored by the next warp's lane 0
  const int64_t s = c0 + h;
  if (s + kStrip <= L) {
    uint4* at = reinterpret_cast<uint4*>(row + s);
    *at = accumulate ? xor4(*at, d) : d;
  } else {
    for (int j = 0; s + j < L; ++j) {
      const uint8_t b = static_cast<uint8_t>(byte_of(d, j));
      row[s + j] = accumulate ? row[s + j] ^ b : b;
    }
  }
  if (c0 == 0) {
    for (int j = 0; j < h && j < L; ++j) {
      const uint8_t b = static_cast<uint8_t>(byte_of(v, j));
      row[j] = accumulate ? row[j] ^ b : b;
    }
  }
}

// One launch's share of A: up to 8 output rows by 8 input rows, as the
// splats of a * 2^b, read by every lane from the kernel's parameters.
struct Tile {
  uint32_t splat[kTile][kTile][8];  // [i][r][b] = splat(a * 2^b), a = A[i0 + i, r0 + r]
  int planes[kTile];                // input row r has a coefficient other than 0 and 1
  int rows, inputs;                 // output and input rows of the tile
  int accumulate;                   // XOR into C (a tile of input rows after the first)
};

__global__ void __launch_bounds__(kThreads, 3)
gf256_matmul_kernel(const uint8_t* __restrict__ B, uint8_t* __restrict__ C, int64_t L,
                    const __grid_constant__ Tile t) {
  __shared__ uint4 s_in[kWarps][kTile][kLanes + 1];  // each warp's staged input words
  const int lane = threadIdx.x & (kLanes - 1);
  uint4(&in)[kTile][kLanes + 1] = s_in[threadIdx.x / kLanes];
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kLanes;
  const int64_t c0 = (warp * kStripsPerWarp + lane) * kStrip;

#pragma unroll
  for (int r = 0; r < kTile; ++r) {  // every input row's words in flight at once
    if (r >= t.inputs) break;
    stage_row(in[r], B + r * L, L, c0, lane);
  }
  cp_async_wait_all();
  __syncwarp();

  uint4 acc[kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i) acc[i] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
    if (r >= t.inputs) break;
    // the lane's 16 columns: its word and the next, shifted by the row's offset
    const int off = static_cast<int>(reinterpret_cast<uintptr_t>(B + r * L) & 15u);
    const uint4 x = off ? window16(in[r][lane], in[r][lane + 1], off) : in[r][lane];
    if (!t.planes[r]) {  // only coefficients 0 and 1 in this input row
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        if (i >= t.rows) break;
        if (t.splat[i][r][0] == kUnit) acc[i] = xor4(acc[i], x);
      }
      continue;
    }
    const uint4 p0 = plane<0>(x), p1 = plane<1>(x), p2 = plane<2>(x), p3 = plane<3>(x);
    const uint4 p4 = plane<4>(x), p5 = plane<5>(x), p6 = plane<6>(x), p7 = plane<7>(x);
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      if (i >= t.rows) break;
      const uint32_t* c = t.splat[i][r];
      if (c[0] == 0u) continue;
      if (c[0] == kUnit) {
        acc[i] = xor4(acc[i], x);
        continue;
      }
      fma_plane(acc[i], p0, c[0]); fma_plane(acc[i], p1, c[1]);
      fma_plane(acc[i], p2, c[2]); fma_plane(acc[i], p3, c[3]);
      fma_plane(acc[i], p4, c[4]); fma_plane(acc[i], p5, c[5]);
      fma_plane(acc[i], p6, c[6]); fma_plane(acc[i], p7, c[7]);
    }
  }
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    if (i >= t.rows) break;
    store_row(C + i * L, L, c0, lane, acc[i], t.accumulate != 0);
  }
}

}  // namespace

// A: (m, k) uint8 in host memory; B: (k, L), C: (m, L) uint8, contiguous,
// on the device; 0 < m, k <= 256 and L > 0. One launch per tile of 8 output
// by 8 input rows, on `stream`; returns the first cudaGetLastError() that
// is not 0, else 0.
extern "C" int gf256_matmul_launch(const uint8_t* A, const void* B, void* C, int64_t m,
                                   int64_t k, int64_t L, void* stream) {
  const int64_t strips = (L + kStrip - 1) / kStrip;
  const int64_t warps = (strips + kStripsPerWarp - 1) / kStripsPerWarp;
  const unsigned blocks = static_cast<unsigned>((warps + kWarps - 1) / kWarps);
  for (int64_t i0 = 0; i0 < m; i0 += kTile) {
    for (int64_t r0 = 0; r0 < k; r0 += kTile) {
      Tile t{};
      t.rows = static_cast<int>(m - i0 < kTile ? m - i0 : kTile);
      t.inputs = static_cast<int>(k - r0 < kTile ? k - r0 : kTile);
      t.accumulate = r0 > 0;
      for (int i = 0; i < t.rows; ++i) {
        for (int r = 0; r < t.inputs; ++r) {
          uint32_t a = A[(i0 + i) * k + r0 + r];
          t.planes[r] |= a > 1;
          for (int b = 0; b < 8; ++b) {
            t.splat[i][r][b] = a * kUnit;
            a = ((a << 1) ^ ((a & 0x80u) ? 0x1Du : 0u)) & 0xFFu;  // a * x mod 0x11D
          }
        }
      }
      gf256_matmul_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(B) + r0 * L, static_cast<uint8_t*>(C) + i0 * L, L, t);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}
