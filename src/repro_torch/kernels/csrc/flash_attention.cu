// Fused flash attention, forward: one CUDA block per (query head, 64-row
// query tile), online softmax over 64-key tiles.
//
// Replaces the Pallas kernel `_flash_fwd_kernel` (src/repro/kernels/
// flash_attention/kernel.py, wrapped by `flash_attention_fwd_pallas`,
// registered as op `flash_attention_fwd`).
//
// What it computes, as the Pallas kernel does: q [BHG, Sq, D] (already scaled
// by 1/sqrt(D)), k and v [BHkv, Skv, D], query head h reading KV head h / G.
// q and k share one dtype and v may have another: in a bf16 model q and k
// come out of RoPE in float32 (its float32 tables promote them) and v stays
// bf16.  s = q.k^T in float32, an optional softcap * tanh(s / softcap), the mask
// (q_pos < Sq, k_pos < Skv, causal q_pos >= k_pos, window q_pos - k_pos <
// window), online softmax with float32 running max m and sum l, p rounded to
// v's dtype before the PV product, float32 accumulation, and acc / max(l,
// 1e-30) written in q's dtype.  The Pallas kernel writes -1e30 on a masked
// score and lets exp() of it vanish once a later block raises m; a row whose
// every score in a block is masked while m is still -1e30 then takes p = 1
// for every key of that block, and only a later block's alpha = 0 wipes it
// out (at the window's edge: row 1023 against keys 448..511 at window 512).
// Here a masked score gets p = 0 outright, so the result does not hang on
// the order of the key tiles; on every row that has a key it is the same.
//
// What bounds it on the H100, at gemma3-1b's prefill shapes (G = 4 query
// heads on one KV head, D = 256, bf16; S = 32,768, causal global layers and
// window-512 local layers): the products.  A global layer's live (q, k)
// pairs are about 4 * S^2 / 2 = 2.1e9, each 2 * 2 * D = 1,024 flops: 2.2e12
// flops, 2.2 ms at the tensor cores' 989 TFLOP/s, against 4 * 16.8 MB of
// q/k/v/o, 0.02 ms at 3.35 TB/s.  A local layer has about 4 * S * 512 live
// pairs: 6.9e10 flops, 0.07 ms.  So the bound is operations, and only the
// tensor cores reach it.
//
// In a bf16 model q and k arrive in float32 (above), and the q.k^T half of
// the flops, 1.1e12 on a global layer, has the float32 rate: 67 TFLOP/s
// outside the tensor cores, 16.4 ms, which then bounds the layer.
//
// What this design does about it: the first, simple version.  Its products
// are float32 FMAs on the CUDA cores (67 TFLOP/s peak, so at least 15x the
// tensor-core bound); wgmma, TMA and a pipelined ring of tiles are later
// work.  Within that: every live tile is read once into shared memory as
// float32 and reused by 64 query rows (Q once per block); each thread holds a
// 4 x 4 block of scores and a 4-row x (D/16)-column slice of the output in
// registers, so a 16-byte shared load feeds 4 FMAs; padded shared rows keep
// the 16-byte loads free of bank conflicts; below D = 64 only the threads
// whose columns exist hold output; key tiles wholly above the diagonal or
// wholly outside the window are never visited (the dead-block skip of the
// Pallas kernel, as loop bounds); under a causal mask the longest query
// tiles start first.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // 16 x 16: ty owns rows ty + 16a, tx columns
constexpr float kNegInf = -1e30f;

// dtype codes of the C interface
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t hi16) {
  return __uint_as_float(hi16 << 16);
}

__device__ __forceinline__ uint32_t float_to_bf16_bits(float x) {
  // round to nearest even; NaN stays NaN
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

struct F32 {
  using T = float;
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store4(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
  }
};

struct BF16 {
  using T = uint16_t;  // bf16 bits
  static __device__ __forceinline__ float4 load4(const uint16_t* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    return make_float4(bf16_bits_to_float(raw.x & 0xffffu),
                       bf16_bits_to_float(raw.x >> 16),
                       bf16_bits_to_float(raw.y & 0xffffu),
                       bf16_bits_to_float(raw.y >> 16));
  }
  static __device__ __forceinline__ float round(float x) {
    return bf16_bits_to_float(float_to_bf16_bits(x));
  }
  static __device__ __forceinline__ void store4(uint16_t* p, float4 x) {
    uint2 raw;
    raw.x = float_to_bf16_bits(x.x) | (float_to_bf16_bits(x.y) << 16);
    raw.y = float_to_bf16_bits(x.z) | (float_to_bf16_bits(x.w) << 16);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

template <int D>
constexpr size_t smem_bytes() {
  static_assert(D % 16 == 0 && D <= 256, "D: a multiple of 16, at most 256");
  // Q and K tiles with padded rows, the V tile, the P tile with padded rows
  return sizeof(float) * (static_cast<size_t>(kBlockQ) * (D + 4) +
                          static_cast<size_t>(kBlockK) * (D + 4) +
                          static_cast<size_t>(kBlockK) * D +
                          static_cast<size_t>(kBlockQ) * (kBlockK + 1));
}

// EQK: the element type of q, k and o; EV: that of v (and of p)
template <typename EQK, typename EV, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const typename EQK::T* __restrict__ q,
                 const typename EQK::T* __restrict__ k,
                 const typename EV::T* __restrict__ v,
                 typename EQK::T* __restrict__ o, int g, int sq, int skv,
                 int causal, int window, float softcap) {
  constexpr int kStride = D + 4;         // padded shared row of Q and K
  constexpr int kPStride = kBlockK + 1;  // padded shared row of P
  // float4 column groups of O a thread holds: columns 64c + 4tx .. +3
  constexpr int kCols = D >= 64 ? D / 64 : 1;
  constexpr int kVec = D / 4;            // float4s in a row

  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kBlockQ][kStride]
  float* ks = qs + kBlockQ * kStride;            // [kBlockK][kStride]
  float* vs = ks + kBlockK * kStride;            // [kBlockK][D]
  float* ps = vs + kBlockK * D;                  // [kBlockQ][kPStride]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // below D = 64 the columns 4tx .. +3 of the higher tx do not exist
  const bool owns_cols = D >= 64 || 4 * tx < D;
  const int head = blockIdx.y;
  const int kv_head = head / g;
  // the last query tiles have the most live key tiles under a causal mask:
  // hand them out first
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * kBlockQ;

  const typename EQK::T* qh = q + static_cast<size_t>(head) * sq * D;
  const typename EQK::T* kh = k + static_cast<size_t>(kv_head) * skv * D;
  const typename EV::T* vh = v + static_cast<size_t>(kv_head) * skv * D;

  for (int c = tid; c < kBlockQ * kVec; c += kThreads) {
    const int r = c / kVec;
    const int col = (c % kVec) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q_lo + r < sq) x = EQK::load4(qh + static_cast<size_t>(q_lo + r) * D + col);
    *reinterpret_cast<float4*>(qs + r * kStride + col) = x;
  }

  float m[4], l[4], acc[4][kCols][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][c][e] = 0.f;
  }

  // live key tiles: none wholly outside the window, none wholly above the
  // diagonal of this tile's last real row
  const int q_hi = min(q_lo + kBlockQ, sq) - 1;
  int kt_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0) kt_begin = (q_lo - window + 1) / kBlockK;
  int kt_end = (skv + kBlockK - 1) / kBlockK;
  if (causal) kt_end = min(kt_end, q_hi / kBlockK + 1);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_lo = kt * kBlockK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int c = tid; c < kBlockK * kVec; c += kThreads) {
      const int r = c / kVec;
      const int col = (c % kVec) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (k_lo + r < skv) {
        kx = EQK::load4(kh + static_cast<size_t>(k_lo + r) * D + col);
        vx = EV::load4(vh + static_cast<size_t>(k_lo + r) * D + col);
      }
      *reinterpret_cast<float4*>(ks + r * kStride + col) = kx;
      *reinterpret_cast<float4*>(vs + r * D + col) = vx;
    }
    __syncthreads();

    // scores of rows ty + 16a against keys tx + 16b
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qa[a] = *reinterpret_cast<const float4*>(qs + (ty + 16 * a) * kStride + d);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        kb[b] = *reinterpret_cast<const float4*>(ks + (tx + 16 * b) * kStride + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          float t = s[a][b];
          t = fmaf(qa[a].x, kb[b].x, t);
          t = fmaf(qa[a].y, kb[b].y, t);
          t = fmaf(qa[a].z, kb[b].z, t);
          t = fmaf(qa[a].w, kb[b].w, t);
          s[a][b] = t;
        }
    }

    // soft-cap, mask, online softmax; the 16 lanes of a row (one half-warp)
    // reduce its max and sum with butterflies, which leave every lane with the
    // same bits
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qp = q_lo + ty + 16 * a;
      bool live[4];
      float rmax = kNegInf;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int kp = k_lo + tx + 16 * b;
        live[b] = qp < sq && kp < skv && (!causal || qp >= kp) &&
                  (window <= 0 || qp - kp < window);
        float x = s[a][b];
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[a][b] = live[b] ? x : kNegInf;
        rmax = fmaxf(rmax, s[a][b]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[a], rmax);
      const float alpha = expf(m[a] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = live[b] ? expf(s[a][b] - m_new) : 0.f;
        rsum += p;
        ps[(ty + 16 * a) * kPStride + tx + 16 * b] = EV::round(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[a] = l[a] * alpha + rsum;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][c][e] *= alpha;
    }
    __syncthreads();

    // acc += P V: columns 64c + 4tx .. +3 of rows ty + 16a
#pragma unroll 4
    for (int j = 0; j < kBlockK && owns_cols; ++j) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = ps[(ty + 16 * a) * kPStride + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + j * D + 64 * c + 4 * tx);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          acc[a][c][0] = fmaf(pa[a], vv.x, acc[a][c][0]);
          acc[a][c][1] = fmaf(pa[a], vv.y, acc[a][c][1]);
          acc[a][c][2] = fmaf(pa[a], vv.z, acc[a][c][2]);
          acc[a][c][3] = fmaf(pa[a], vv.w, acc[a][c][3]);
        }
      }
    }
  }

  typename EQK::T* oh = o + static_cast<size_t>(head) * sq * D;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q_lo + ty + 16 * a;
    if (row >= sq || !owns_cols) continue;
    const float den = fmaxf(l[a], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      EQK::store4(oh + static_cast<size_t>(row) * D + 64 * c + 4 * tx,
                make_float4(acc[a][c][0] / den, acc[a][c][1] / den,
                            acc[a][c][2] / den, acc[a][c][3] / den));
  }
}

template <typename EQK, typename EV, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bhg,
           int g, int sq, int skv, int causal, int window, float softcap,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<EQK, EV, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, bhg);
  using TQK = typename EQK::T;
  using TV = typename EV::T;
  flash_fwd_kernel<EQK, EV, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQK*>(q), static_cast<const TQK*>(k),
      static_cast<const TV*>(v), static_cast<TQK*>(o), g, sq, skv, causal,
      window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename EQK, typename EV>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             int bhg, int g, int sq, int skv, int causal, int window,
             float softcap, cudaStream_t stream) {
#define FLASH_CASE(D)                                                     \
  case D:                                                                 \
    return launch<EQK, EV, D>(q, k, v, o, bhg, g, sq, skv, causal, window, \
                              softcap, stream);
  switch (d) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

}  // namespace

// q, o: [bhg, sq, d]; k, v: [bhg / g, skv, d]; all contiguous on the device,
// 16-byte aligned.  q, k and o have dtype `qk_dtype`, v has `v_dtype` (0
// float32, 1 bfloat16): both float32, both bfloat16, or float32 q and k with
// bfloat16 v.  d in {16, 32, 64, 128, 256}; bhg <= 65535 (grid y).
// window <= 0 means none, softcap <= 0 means none.  Launches on `stream`;
// returns cudaGetLastError() (cudaErrorInvalidValue for an unsupported
// dtype pair or d).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int bhg, int g,
                                      int sq, int skv, int d, int qk_dtype,
                                      int v_dtype, int causal, int window,
                                      float softcap, void* stream) {
  if (bhg <= 0 || sq <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qk_dtype == kFloat32 && v_dtype == kFloat32)
    return launch_d<F32, F32>(d, q, k, v, o, bhg, g, sq, skv, causal, window,
                              softcap, s);
  if (qk_dtype == kBFloat16 && v_dtype == kBFloat16)
    return launch_d<BF16, BF16>(d, q, k, v, o, bhg, g, sq, skv, causal,
                                window, softcap, s);
  if (qk_dtype == kFloat32 && v_dtype == kBFloat16)
    return launch_d<F32, BF16>(d, q, k, v, o, bhg, g, sq, skv, causal,
                               window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The kernel's tile sizes, so that a caller can find the rows whose first
// live key tile is wholly masked.
extern "C" int flash_attention_block_q() { return kBlockQ; }
extern "C" int flash_attention_block_k() { return kBlockK; }
