// Fused flash attention (online softmax, f32 scores and accumulator) for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, body _flash_kernel). It computes the same
// function: q is scaled by 1/sqrt(hd) in f32, scores are f32, masked scores
// are set to -1e30 (not -inf), and the online-softmax recurrence
//     m' = max(m, rowmax S);  l' = l e^(m - m') + sum e^(S - m')
//     acc' = acc e^(m - m') + e^(S - m') V
// runs over key tiles with an f32 accumulator; the output is acc / l in q's
// dtype. Query and key positions both start at 0 (top-left causal when
// Sq < Sk). Key/value heads may be fewer than query heads: query head h
// reads KV head h / (H / Hkv), which equals repeating the KV heads.
//
// What bounds it on this card: the work is 4 hd flops per unmasked (q, k)
// pair, far above the bytes of q, k, v and o, so it is bound by operations.
// This first form does its products as f32 FMAs on the CUDA cores (67
// TFLOP/s), not on the tensor cores (989 TFLOP/s bf16): it is simple and
// exact in f32, and is the yardstick the tensor-core form must match.
//
// Design. One CTA of 128 threads per (q tile of 64 rows, head, batch); q
// tiles are issued last-first so that the longest causal rows start first.
// The q tile (scaled, f32, transposed) stays in shared memory; each 64-key
// tile of K (transposed) and V is staged there in f32. A thread owns rows
// ty + 16 i (i < 4) and key columns tx + 8 c (c < 8) of the score tile, and
// the same rows with head-dim columns tx + 8 c of the accumulator; the 8
// threads of a row are 8 neighbouring lanes, reduced with shuffles. Strides
// are padded so that no access pattern conflicts on banks. Key tiles wholly
// past the causal edge or wholly outside the window are skipped, unless some
// row of the q tile has no key at all (then, as in the reference, it takes
// the mean of all values and every tile is visited). Ragged Sq and Sk are
// bounds-checked: a key past Sk has weight 0, a row past Sq is not stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per CTA
constexpr int BK = 64;           // keys per tile
constexpr int THREADS = 128;
constexpr int RT = BQ / 16;      // rows per thread
constexpr int CT = BK / 8;       // score columns per thread
constexpr int QS = BQ + 1;       // row stride of the transposed q tile
constexpr int KS = BK + 1;       // row stride of the transposed k tile
constexpr int PS = BQ + 4;       // row stride of the transposed p tile
constexpr float NEG = -1e30f;    // the reference's masked score

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(HD * QS + HD * KS + BK * HD + BK * PS);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int H, int Hkv, int Sq, int Sk, int causal, int window,
          float scale) {
  extern __shared__ float smem[];
  float* qT = smem;             // [HD][QS]
  float* kT = qT + HD * QS;     // [HD][KS]
  float* vs = kT + HD * KS;     // [BK][HD]
  float* pT = vs + BK * HD;     // [BK][PS]

  const int nq = (Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int rows = min(BQ, Sq - q0);
  const int t = threadIdx.x, ty = t / 8, tx = t % 8;

  const T* qb = q + (((size_t)b * H + h) * Sq + q0) * HD;
  const T* kb = k + ((size_t)b * Hkv + hk) * (size_t)Sk * HD;
  const T* vb = v + ((size_t)b * Hkv + hk) * (size_t)Sk * HD;
  T* ob = o + (((size_t)b * H + h) * Sq + q0) * HD;

  for (int e = t; e < BQ * HD; e += THREADS) {
    const int r = e / HD, d = e % HD;
    qT[d * QS + r] = r < rows ? to_f32(qb[e]) * scale : 0.f;
  }

  // the key tiles this q tile needs
  const int nk = (Sk + BK - 1) / BK;
  const int q_last = q0 + rows - 1;
  int j_begin = 0, j_end = nk;
  const bool keyless_row = window > 0 && (long long)q_last >= (long long)Sk - 1 + window;
  if (!keyless_row) {
    if (causal) j_end = min(nk, q_last / BK + 1);
    if (window > 0 && q0 - window + 1 > 0) j_begin = (q0 - window + 1) / BK;
  }

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
    const T* kt = kb + (size_t)k0 * HD;
    const T* vt = vb + (size_t)k0 * HD;
    for (int e = t; e < BK * HD; e += THREADS) {
      const int c = e / HD, d = e % HD;
      const bool in = c < kn;
      kT[d * KS + c] = in ? to_f32(kt[e]) : 0.f;
      vs[e] = in ? to_f32(vt[e]) : 0.f;
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
      const int qp = q0 + ty + 16 * i;
      mt[i] = -INFINITY;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        const int kp = k0 + tx + 8 * c;
        if (kp >= Sk) {
          s[i][c] = -INFINITY;  // no such key: weight exactly 0
          continue;
        }
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
      for (int c = 0; c < HD / 8; ++c) store(&ob[(size_t)r * HD + tx + 8 * c], acc[i][c] / lt);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int Hkv, int Sq, int Sk, int causal, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, Hkv, Sq, Sk, causal, window, (float)(1.0 / sqrt((double)HD)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B, int H,
                     int Hkv, int Sq, int Sk, int hd, int causal, int window,
                     cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, H, Hkv, Sq, Sk, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, H, Sq, hd), k/v (B, Hkv, Sk, hd), o (B, H, Sq, hd), all contiguous and
// of one dtype (bf16 when is_bf16, else f32). hd in {16, 32, 64, 128, 256},
// H % Hkv == 0, Sq >= 1, Sk >= 1, window >= 0 (0: no window). Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int Hkv, int Sq, int Sk, int hd,
                                      int is_bf16, int causal, int window, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv != 0 || Sq < 1 || Sk < 1 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Sk, hd, causal, window, s);
  return (int)dispatch<float>(q, k, v, o, B, H, Hkv, Sq, Sk, hd, causal, window, s);
}
