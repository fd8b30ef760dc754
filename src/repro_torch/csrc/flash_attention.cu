// Fused flash attention (online softmax, f32 scores and accumulator) for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:67
// (flash_attention_pallas, body _flash_kernel). It computes the same
// function: scores are f32 and scaled by 1/sqrt(hd) in f32, masked scores
// are a huge finite value (the reference's -1e30, not -inf), and the
// online-softmax recurrence
//     m' = max(m, rowmax S);  l' = l e^(m - m') + sum e^(S - m')
//     acc' = acc e^(m - m') + e^(S - m') V
// runs over key tiles with an f32 accumulator; the output is acc / l in q's
// dtype. Key positions start at 0, query positions at q_off (0: top-left
// causal when Sq < Sk; a rank's block of a longer sequence's queries
// against all of its keys otherwise), for the causal mask, the window and
// the skip of masked key tiles alike. Key/value heads may be fewer than query heads: query head h
// reads KV head h / (H / Hkv), which equals repeating the KV heads.
//
// What bounds it on this card: the work is 4 hd flops per unmasked (q, k)
// pair, far above the bytes of q, k, v and o, so it is bound by operations.
// At the prefill's shape, q (4,14,2048,64) and k/v (4,2,2048,64) bf16
// causal, that is 30.08 GFLOP: 0.0304 ms at 989 TFLOP/s (bf16 tensor
// cores), against 0.0100 ms for its 33.6 MB at 3.35 TB/s.
//
// bf16: the tensor-core form (flash_fwd_wgmma). Both products run as wgmma
// on the tensor cores, the only road to that bound. A CTA holds BQ query
// rows in consumer warpgroups of 64 rows each: three (BQ = 192) at hd <= 64,
// two at hd 112 and 128, one at hd 256, where registers are short. One producer
// warpgroup hands most of its registers to the consumers (setmaxnreg); one
// of its threads loads Q once and then K/V tiles of BK keys by TMA (128-byte
// swizzle, zero fill past Sk) into a ring of 3 stages, each tracked by a
// "full" mbarrier (TMA bytes) and an "empty" one (consumer arrivals): a
// warpgroup reads two tiles at a time while the next one loads. Per tile a
// warpgroup computes
//   S = Q K^T: wgmma m64nBKk16, Q and K from shared memory (row-major K is
//              the K-major operand K^T needs), f32 accumulator;
//   the online softmax on S in registers, in the wgmma accumulator layout:
//              a thread holds two rows, reduced over the 4 lanes that share
//              them with shuffles; in the log2 domain, the scale (times
//              log2 e) is applied by one FMA to the f32 score, never to a
//              bf16 q;
//   O += P V:  wgmma m64n64k16 per 64 head-dim columns, P rounded to bf16
//              in registers (the accumulator layout of S is the A-register
//              layout of P, so P never goes to shared memory), V from
//              shared memory as the MN-major operand.
// At hd 64 the softmax, not the products, sets the pace (PERF.md), so the
// design hides it behind them: a warpgroup issues S of tile j and P V of
// tile j - 1 together and takes the softmax of S while P V runs, and the
// other warpgroups of the CTA keep the tensor cores busy meanwhile.
// Head dims below 64 are padded to one 64-column chunk by the TMA's zero
// fill; 128 and 256 are 2 and 4 chunks, and 112 (zamba2-7b) is padded to 2
// the same way: S = Q K^T runs its 7 k-steps of 16 over the real columns
// only (the last three in the second chunk), P V fills 16 zero columns that
// are not stored, and the scale stays 1/sqrt(112). Q tiles are issued last-first over
// all heads, so the longest causal rows start first; key tiles wholly past
// the causal edge or outside the window are skipped per CTA, and per
// warpgroup, unless a row has no key at all (then, as in the reference, it
// takes the mean of all values and every tile is visited). Masks are
// applied only in tiles that cross an edge. A key past Sk gets weight
// exactly 0 (-inf); rows past Sq are not stored. GQA reads the KV head in
// place.
//
// f32: the CUDA-core form (flash_fwd_f32), exact in f32. TF32 tensor cores
// would round the inputs to 10 mantissa bits and miss the 1e-4 tolerance
// of the f32 checks, and no model path attends in f32 (the model is bf16).
// One CTA of 128 threads per 64-row q tile; 64-key tiles of K (transposed)
// and V staged in shared memory in f32 with padded strides; a thread owns
// rows ty + 16 i and key columns tx + 8 c; products are f32 FMAs, summed
// in d order and then scaled, as the plain version does: with q scaled
// first, scores near 1e3 (the x30 check) came out up to 4e-4 off it.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float NEG = -1e30f;  // the reference's masked score

// The key tiles [j_begin, j_end) of width bk that the queries at positions
// q0 .. q_last need: those not wholly past the causal edge nor wholly
// outside the window. A row with no key at all (window > 0, q_pos >= Sk - 1
// + window) takes the mean of every value in the reference, so then all
// tiles. Positions are long long: q_off + Sq may pass INT_MAX.
__device__ __forceinline__ void key_tiles(long long q0, long long q_last, int Sk, int bk,
                                          int causal, int window, int& j_begin, int& j_end) {
  j_begin = 0;
  j_end = (Sk + bk - 1) / bk;
  if (window > 0 && q_last >= (long long)Sk - 1 + window) return;
  if (causal) j_end = (int)min((long long)j_end, q_last / bk + 1);
  if (window > 0 && q0 - window + 1 > 0) j_begin = (int)((q0 - window + 1) / bk);
}

// ---------------------------------------------------------------- f32, CUDA cores
namespace f32 {

constexpr int BQ = 64;       // query rows per CTA
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 128;
constexpr int RT = BQ / 16;  // rows per thread
constexpr int CT = BK / 8;   // score columns per thread
constexpr int QS = BQ + 1;   // row stride of the transposed q tile
constexpr int KS = BK + 1;   // row stride of the transposed k tile
constexpr int PS = BQ + 4;   // row stride of the transposed p tile

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(HD * QS + HD * KS + BK * HD + BK * PS);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int H, int Hkv, int Sq, int Sk,
              int q_off, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* qT = smem;          // [HD][QS]
  float* kT = qT + HD * QS;  // [HD][KS]
  float* vs = kT + HD * KS;  // [BK][HD]
  float* pT = vs + BK * HD;  // [BK][PS]

  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int rows = min(BQ, Sq - q0);
  const int t = threadIdx.x, ty = t / 8, tx = t % 8;

  const float* qb = q + (((size_t)b * H + h) * Sq + q0) * HD;
  const float* kb = k + ((size_t)b * Hkv + hk) * (size_t)Sk * HD;
  const float* vb = v + ((size_t)b * Hkv + hk) * (size_t)Sk * HD;
  float* ob = o + (((size_t)b * H + h) * Sq + q0) * HD;

  for (int e = t; e < BQ * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    qT[d * QS + r] = r < rows ? qb[e] : 0.f;
  }

  int j_begin, j_end;
  key_tiles((long long)q_off + q0, (long long)q_off + q0 + rows - 1, Sk, BK, causal, window,
            j_begin, j_end);

  float m[RT], l[RT], acc[RT][HD / 8];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) acc[i][c] = 0.f;
  }

  for (int j = j_begin; j < j_end; ++j) {
    const int k0 = j * BK;
    const int kn = min(BK, Sk - k0);
    __syncthreads();  // the previous tile's kT, vs and pT are no longer read
    const float* kt = kb + (size_t)k0 * HD;
    const float* vt = vb + (size_t)k0 * HD;
    for (int e = t; e < BK * HD; e += THREADS) {
      const int c = e / HD, d = e % HD;
      const bool in = c < kn;
      kT[d * KS + c] = in ? kt[e] : 0.f;
      vs[e] = in ? vt[e] : 0.f;
    }
    __syncthreads();

    float s[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < CT; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RT], kv[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) qv[i] = qT[d * QS + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < CT; ++c) kv[c] = kT[d * KS + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int c = 0; c < CT; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

    float mt[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const long long qp = (long long)q_off + q0 + ty + 16 * i;
      mt[i] = -INFINITY;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const int kp = k0 + tx + 8 * c;
        if (kp >= Sk) {
          s[i][c] = -INFINITY;  // no such key: weight exactly 0
          continue;
        }
        s[i][c] *= scale;  // after the sum, as the plain version scales its scores
        bool ok = !causal || kp <= qp;
        if (window > 0) ok = ok && qp - kp < window;
        if (!ok) s[i][c] = NEG;
        mt[i] = fmaxf(mt[i], s[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], off));
      const float m_new = fmaxf(m[i], mt[i]);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const float p = expf(s[i][c] - m_new);
        pT[(tx + 8 * c) * PS + ty + 16 * i] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + ps;  // this thread's share of the row sum
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      float pv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) pv[i] = pT[kk * PS + ty + 16 * i];
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        const float vv = vs[kk * HD + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < RT; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int r = ty + 16 * i;
    if (r < rows) {
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) ob[(size_t)r * HD + tx + 8 * c] = acc[i][c] / lt;
    }
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
                   int Sq, int Sk, int q_off, int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_f32<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, Hkv, Sq, Sk, q_off, causal, window,
      (float)(1.0 / sqrt((double)HD)));
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------- bf16, tensor cores
namespace tc {

constexpr int CH = 64;      // head-dim columns in one 128-byte swizzled chunk
constexpr int ROW = 128;    // bytes of one chunk row
constexpr int ATOM = 1024;  // bytes of one swizzle atom (8 chunk rows)

template <int HD>
struct Shape {
  static constexpr int HDP = (HD + CH - 1) / CH * CH;  // head dim padded to whole chunks
  static constexpr int NCH = HDP / CH;
  static constexpr int NWG = HD <= 64 ? 3 : HD <= 128 ? 2 : 1;  // consumer warpgroups of 64 rows
  static constexpr int BQ = 64 * NWG;
  static constexpr int THREADS = (NWG + 1) * 128;  // + the producer warpgroup
  static constexpr int Q_BYTES = BQ * HDP * 2;
  static constexpr int STAGES = 3;  // K/V tiles in the ring: two that are read, one loading
  // registers of a consumer thread once the producer's threads keep 24 of
  // the 64 K (setmaxnreg); one consumer warpgroup has its 255 from the start
  static constexpr int CONSUMER_REGS = (65536 / 128 - 24) / NWG / 8 * 8;
};

template <int HD, int BK>
constexpr size_t smem_bytes() {  // Q, the K and V rings, 1 + 2 STAGES barriers, alignment slack
  using S = Shape<HD>;
  return ATOM + (size_t)S::Q_BYTES + 2 * S::STAGES * (size_t)BK * S::HDP * 2 +
         (1 + 2 * S::STAGES) * sizeof(uint64_t);
}

// S = Q K^T for one warpgroup: its 64 rows of Q against the BK keys of a K
// tile, over the real head dims (the padded chunk columns are 0).
template <int HD, int BK, int BQ>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], const uint8_t* q_wg,
                                         const uint8_t* k_tile) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int off = (kk % 4) * 32;  // 16 columns of the 128-byte chunk row
    const uint64_t da = sm90::desc_sw128(q_wg + (kk / 4) * BQ * ROW + off, 16, ATOM);
    const uint64_t db = sm90::desc_sw128(k_tile + (kk / 4) * BK * ROW + off, 16, ATOM);
    if constexpr (BK == 128) sm90::wgmma_ss_n128(sc, da, db, kk > 0);
    else sm90::wgmma_ss_n64(sc, da, db, kk > 0);
  }
}

// O += P V: P's bf16 A fragments against a V tile, 64 head-dim columns at a time.
template <int NCH, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[NCH][32], const uint32_t (&pa)[BK / 16][4],
                                         const uint8_t* v_tile) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      sm90::wgmma_rs_n64(acc[c], pa[kk],
                         sm90::desc_sw128(v_tile + c * BK * ROW + kk * 16 * ROW, ATOM, ATOM));
}

// A masked raw score. Like the reference's -1e30 it is finite, so a row
// whose keys are all masked so far weighs them equally (exp2(0) = 1), and
// that is erased by the first real key (alpha = 0) or, for a row with no
// key at all, is its answer. It is a power of two so that c * MASKED is
// exact and the FMA below gives exactly 0 against a max of c * MASKED.
constexpr float MASKED = -0x1p100f;

// The online softmax of one tile, in the wgmma accumulator layout: sc[i] is
// the raw score of row qp0 + 8 ((i / 2) % 2) and key k0 + 8 (i / 4) + c0 + i % 2.
// With MASK (a tile that crosses the causal edge, the window's edge or Sk),
// masked scores become MASKED and keys past Sk -inf. With c = log2(e) /
// sqrt(hd), the running max m is c rowmax, each weight exp2(c s - m) (one
// FMA applies the scale to the f32 score), alpha = exp2(m_old - m). sc is
// left holding the f32 weights; l gains this thread's share of the row sums.
// Maxima and sums run in 4 independent chains per row, for the latency.
template <int BK, bool MASK>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2], float (&m)[2], float (&l)[2],
                                               float (&alpha)[2], float c, int k0,
                                               long long qp0, int c0, int Sk, int causal,
                                               int window) {
  // in key offsets e = kp - (k0 + c0) of this thread's columns: keys past Sk
  // are e >= past, and row r masks e > late[r] (causal) and e <= early[r]
  // (outside the window)
  const int past = Sk - k0 - c0;
  int late[2], early[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long d = qp0 + 8 * r - k0 - c0;  // q_pos - kp at e = 0
    late[r] = causal ? (int)min(d, (long long)INT_MAX) : INT_MAX;
    early[r] = window > 0 ? (int)min(max(d - window, -1LL), (long long)INT_MAX)
                          : -1;  // -1: none, e >= 0
  }
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) mx[r][j] = -INFINITY;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i / 2) % 2;
    if constexpr (MASK) {
      const int e = 8 * (i / 4) + i % 2;
      if (e >= past) sc[i] = -INFINITY;  // no such key: weight exactly 0
      else if (e > late[r] || e <= early[r]) sc[i] = MASKED;
    }
    mx[r][(i / 4) % 4] = fmaxf(mx[r][(i / 4) % 4], sc[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mt = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m[r], mt * c);
    alpha[r] = sm90::exp2_approx(m[r] - m_new);
    m[r] = m_new;
  }
  float ps[2][4] = {};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i / 2) % 2;
    sc[i] = sm90::exp2_approx(fmaf(sc[i], c, -m[r]));
    ps[r][(i / 4) % 4] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] + ((ps[r][0] + ps[r][1]) + (ps[r][2] + ps[r][3]));
}

// One tile's softmax, with the masks only where the tile needs them.
template <int BK>
__device__ __forceinline__ void tile_softmax(float (&sc)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float c, bool masked, int k0,
                                             long long qp0, int c0, int Sk, int causal,
                                             int window) {
  if (masked)
    online_softmax<BK, true>(sc, m, l, alpha, c, k0, qp0, c0, Sk, causal, window);
  else
    online_softmax<BK, false>(sc, m, l, alpha, c, k0, qp0, c0, Sk, causal, window);
}

// P in bf16 as the A fragments of P V: for keys 16 kk .. 16 kk + 15, the
// registers {row r0, row r0 + 8} x {columns c0, c0 + 8}, which is where the
// accumulator layout of S already holds them.
template <int BK>
__device__ __forceinline__ void pack_p(const float (&sc)[BK / 2], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      pa[kk][x] = sm90::pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
}

template <int NCH>
__device__ __forceinline__ void rescale(float (&acc)[NCH][32], const float (&alpha)[2]) {
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] *= alpha[(i / 2) % 2];
}

template <int NCH>
__device__ __forceinline__ void fence_acc(float (&acc)[NCH][32]) {
#pragma unroll
  for (int c = 0; c < NCH; ++c) sm90::fence_regs(acc[c]);
}

template <int HD, int BK>
__global__ void __launch_bounds__(Shape<HD>::THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int H,
                int Hkv, int Sq, int Sk, int q_off, int causal, int window, float c) {
  using S = Shape<HD>;
  constexpr int NCH = S::NCH, NWG = S::NWG, BQ = S::BQ, STAGES = S::STAGES;
  constexpr int KV_BYTES = BK * S::HDP * 2;  // one stage of K (or of V)
  static_assert(BK == 64 || BK == 128, "key tiles are 64 or 128 wide");

  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sq = smem_raw + ((ATOM - (sm90::smem_u32(smem_raw) & (ATOM - 1))) & (ATOM - 1));
  uint8_t* sk = sq + S::Q_BYTES;         // [STAGES][NCH][BK][CH]
  uint8_t* sv = sk + STAGES * KV_BYTES;  // [STAGES][NCH][BK][CH]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + STAGES * KV_BYTES);
  uint64_t* full = q_full + 1;      // [STAGES]: the tile's K and V bytes have landed
  uint64_t* empty = full + STAGES;  // [STAGES]: every consumer thread is done with it

  // CTAs start in the order of their linear index, the q tile slowest: every
  // head's last q tile (the longest causal rows) first, the first ones last
  const int q0 = ((int)gridDim.z - 1 - (int)blockIdx.z) * BQ;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int rows = min(BQ, Sq - q0);

  int j_begin, j_end;
  key_tiles((long long)q_off + q0, (long long)q_off + q0 + rows - 1, Sk, BK, causal, window,
            j_begin, j_end);
  const int n_tiles = j_end - j_begin;

  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], NWG * 128);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= NWG * 128) {  // the producer warpgroup; one thread issues every copy
    // with more than one consumer warpgroup every thread starts with
    // 64 K / THREADS registers; the producer gives most of its share away
    if constexpr (NWG > 1) sm90::regs_dealloc<24>();
    if (tid == NWG * 128) {
      const int qh = b * H + h, kh = b * Hkv + hk;
      sm90::mbar_expect_tx(q_full, S::Q_BYTES);
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
        sm90::tma_load_3d(sq + ch * BQ * ROW, &tq, q_full, ch * CH, q0, qh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) sm90::mbar_wait(&empty[s], (it / STAGES - 1) & 1);
        sm90::mbar_expect_tx(&full[s], 2 * KV_BYTES);
        const int k0 = (j_begin + it) * BK;
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          sm90::tma_load_3d(sk + s * KV_BYTES + ch * BK * ROW, &tk, &full[s], ch * CH, k0, kh);
          sm90::tma_load_3d(sv + s * KV_BYTES + ch * BK * ROW, &tv, &full[s], ch * CH, k0, kh);
        }
      }
    }
    return;
  }

  if constexpr (NWG > 1) sm90::regs_alloc<S::CONSUMER_REGS>();
  // a consumer warpgroup: 64 query rows; this thread holds rows r0 and r0 + 8
  // of them and, in each 8-column block of S and O, columns c0 and c0 + 1
  const int wg = tid / 128, lane = tid % 32;
  const int r0 = 16 * ((tid / 32) % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const int qlo = q0 + 64 * wg;           // the warpgroup's first query row
  const int qhi = min(qlo + 63, Sq - 1);  // its last real one (< qlo: it has none)
  const long long plo = (long long)q_off + qlo, phi = (long long)q_off + qhi;  // their positions
  const uint8_t* q_wg = sq + 64 * wg * ROW;

  // Of the CTA's tiles, [ta, tb) hold an unmasked key for some row of this
  // warpgroup (all of them when a row has no key at all). The others are
  // only waited for and released.
  int ta = 0, tb = n_tiles;
  if (qhi < qlo) {
    tb = 0;
  } else if (!(window > 0 && phi >= (long long)Sk - 1 + window)) {
    while (ta < tb && window > 0 && plo - ((j_begin + ta + 1) * BK - 1) >= window) ++ta;
    while (tb > ta && causal && (long long)(j_begin + tb - 1) * BK > phi) --tb;
  }
  auto tile_is_masked = [&](int k0) {
    return k0 + BK > Sk || (causal && k0 + BK - 1 > plo) ||
           (window > 0 && plo + 63 - k0 >= window);
  };

  float acc[NCH][32], sc[BK / 2];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[ch][i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
  uint32_t pa[BK / 16][4];
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];

  sm90::mbar_wait(q_full, 0);
  for (int it = 0; it < ta; ++it) {
    sm90::mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    sm90::mbar_arrive(&empty[it % STAGES]);
  }
  if (ta < tb) {
    // the first tile: S, then its softmax; P V waits for the next tile's S
    sm90::mbar_wait(&full[ta % STAGES], (ta / STAGES) & 1);
    sm90::fence_regs(sc);
    sm90::wgmma_fence();
    issue_qk<HD, BK, BQ>(sc, q_wg, sk + (ta % STAGES) * KV_BYTES);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    int k0 = (j_begin + ta) * BK;
    tile_softmax<BK>(sc, m, l, alpha, c, tile_is_masked(k0), k0, plo + r0, c0, Sk, causal,
                     window);
    pack_p<BK>(sc, pa);
    // each further tile: issue S = Q K^T of this tile and O += P V of the
    // last one, then take this tile's softmax while P V runs
    for (int it = ta + 1; it < tb; ++it) {
      const int s = it % STAGES, sp = (it - 1) % STAGES;
      sm90::mbar_wait(&full[s], (it / STAGES) & 1);
      rescale<NCH>(acc, alpha);
      fence_acc<NCH>(acc);
      sm90::fence_regs(sc);
      sm90::wgmma_fence();
      issue_qk<HD, BK, BQ>(sc, q_wg, sk + s * KV_BYTES);
      sm90::wgmma_commit();
      issue_pv<NCH, BK>(acc, pa, sv + sp * KV_BYTES);
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
      sm90::fence_regs(sc);
      k0 = (j_begin + it) * BK;
      tile_softmax<BK>(sc, m, l, alpha, c, tile_is_masked(k0), k0, plo + r0, c0, Sk, causal,
                       window);
      sm90::wgmma_wait<0>();
      fence_acc<NCH>(acc);
      sm90::mbar_arrive(&empty[sp]);
      pack_p<BK>(sc, pa);
    }
    // the last tile's P V
    rescale<NCH>(acc, alpha);
    fence_acc<NCH>(acc);
    sm90::wgmma_fence();
    issue_pv<NCH, BK>(acc, pa, sv + ((tb - 1) % STAGES) * KV_BYTES);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    fence_acc<NCH>(acc);
    sm90::mbar_arrive(&empty[(tb - 1) % STAGES]);
  }
  for (int it = tb; it < n_tiles; ++it) {
    sm90::mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    sm90::mbar_arrive(&empty[it % STAGES]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int qp = qlo + r0 + 8 * r;
    if (qp < Sq) {
      __nv_bfloat16* orow = o + (((size_t)b * H + h) * Sq + qp) * HD;
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = ch * CH + 8 * j + c0;
          if (col < HD)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
                acc[ch][4 * j + 2 * r] / lt, acc[ch][4 * j + 2 * r + 1] / lt);
        }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry-point
// query (this library is not linked against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (heads, rows, hd) bf16 tensor as a TMA map whose box is box_rows rows of
// one 64-column chunk, 128-byte swizzled; reads past rows or hd give zeros.
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int hd, int rows,
                int heads, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)hd * 2 * (cuuint64_t)rows};
  const cuuint32_t box[3] = {(cuuint32_t)CH, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
                   int Sq, int Sk, int q_off, int causal, int window, cudaStream_t stream) {
  using S = Shape<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(encode, &tq, q, HD, Sq, B * H, S::BQ) ||
      !tensor_map(encode, &tk, k, HD, Sk, B * Hkv, BK) ||
      !tensor_map(encode, &tv, v, HD, Sk, B * Hkv, BK))
    return cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<HD, BK>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<HD, BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B, (Sq + S::BQ - 1) / S::BQ);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  flash_fwd_wgmma<HD, BK><<<grid, S::THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, Hkv, Sq, Sk, q_off, causal, window,
      (float)(1.4426950408889634 / sqrt((double)HD)));
  return cudaGetLastError();
}

}  // namespace tc

// Key tiles of 128 at hd <= 128, of 64 at hd 256 (registers); PERF.md has
// the measurement behind 128 at hd 64.
cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H,
                          int Hkv, int Sq, int Sk, int hd, int q_off, int causal,
                          int window, cudaStream_t s) {
  switch (hd) {
    case 16: return tc::launch<16, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, q_off, causal, window, s);
    case 32: return tc::launch<32, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, q_off, causal, window, s);
    case 64: return tc::launch<64, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, q_off, causal, window, s);
    case 112: return tc::launch<112, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, q_off, causal, window, s);
    case 128: return tc::launch<128, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, q_off, causal, window, s);
    case 256: return tc::launch<256, 64>(q, k, v, o, B, H, Hkv, Sq, Sk, q_off, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o, int B, int H,
                         int Hkv, int Sq, int Sk, int hd, int q_off, int causal, int window,
                         cudaStream_t s) {
  switch (hd) {
    case 16: return f32::launch<16>(q, k, v, o, B, H, Hkv, Sq, Sk, q_off, causal, window, s);
    case 32: return f32::launch<32>(q, k, v, o, B, H, Hkv, Sq, Sk, q_off, causal, window, s);
    case 64: return f32::launch<64>(q, k, v, o, B, H, Hkv, Sq, Sk, q_off, causal, window, s);
    case 112: return f32::launch<112>(q, k, v, o, B, H, Hkv, Sq, Sk, q_off, causal, window, s);
    case 128: return f32::launch<128>(q, k, v, o, B, H, Hkv, Sq, Sk, q_off, causal, window, s);
    case 256: return f32::launch<256>(q, k, v, o, B, H, Hkv, Sq, Sk, q_off, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, hd), k/v (B, Hkv, Sk, hd), o (B, H, Sq, hd), all contiguous and
// of one dtype (bf16 when is_bf16, else f32); bf16 pointers 16-byte aligned.
// hd in {16, 32, 64, 112, 128, 256}, H % Hkv == 0, Sq >= 1, Sk >= 1, window >= 0
// (0: no window), q_off >= 0 (query row i at position q_off + i). Launches on
// `stream`, does not synchronise, returns the launch's cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int B,
                                      int H, int Hkv, int Sq, int Sk, int hd, int q_off,
                                      int is_bf16, int causal, int window, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1 || window < 0 || q_off < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)dispatch_bf16(q, k, v, o, B, H, Hkv, Sq, Sk, hd, q_off, causal, window, s);
  return (int)dispatch_f32(q, k, v, o, B, H, Hkv, Sq, Sk, hd, q_off, causal, window, s);
}
