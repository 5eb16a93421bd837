// Fused flash attention, backward: dQ, dK and dV from q, k, v, the forward's
// output o, the output's gradient dO and the forward's row log-sum-exp, on
// the CUDA cores in float32, with no atomics: three launches an op.
//
// Replaces no Pallas kernel.  The Pallas forward (`_flash_fwd_kernel`,
// src/repro/kernels/flash_attention/kernel.py) has no custom_vjp; the JAX
// package trains through XLA's autodiff of its chunked flash attention
// (`attention_train`, src/repro/models/attention.py:191).  The port's
// training forward runs the hand-written forward kernel, so its gradient is
// this kernel, called by the `FlashAttention` autograd function
// (kernels/flash_attention/ops.py).
//
// What it computes, for every live (query row i, key j) pair of a head, with
// q already scaled, s = q_i . k_j, x = s or softcap * tanh(s / softcap), the
// forward's masks (i < Sq, j < Skv, causal i >= j, window i - j < window),
// p = exp(x - lse_i) (0 on a masked pair) and Delta_i = sum_d dO_id O_id:
//     dV_j += p dO_i,   dP = dO_i . v_j,   dX = p (dP - Delta_i),
//     dS = dX (1 - (x / softcap)^2) with a softcap, else dX,
//     dQ_i += dS k_j,   dK_j += dS q_i,
// summed over the G query heads of a KV head for dK and dV.  Every operand is
// widened to float32 in shared memory and every sum is float32; the outputs
// are written in their inputs' dtypes (bf16 rounded to nearest even).
//
// The launches, each deterministic (a fixed order of float32 sums, no
// atomics), so that two runs, and a resumed training run and an unbroken
// one, give the same bits:
//   1. `delta_kernel`: Delta_i for every row, one warp a row (a third pass,
//      tiny: it reads O and dO once);
//   2. `dkdv_kernel`: one block a (KV head, 32-key tile).  K and V of the
//      tile stay in shared memory; the block loops over the G query heads of
//      its KV head and, for each, over the live 32-row query tiles, so GQA's
//      sum over heads stays inside the block; dK and dV accumulate in
//      registers;
//   3. `dq_kernel`: one block a (query head, 32-row tile), looping over the
//      live key tiles; dQ accumulates in registers.
// Both recompute p and dP from q, k, v, dO and lse.  Tiles wholly above the
// diagonal or outside the window are never visited.
//
// What bounds it on the H100: the five products (q.k^T recomputed twice, once
// a kernel, dV, dP twice, dQ, dK) over the live pairs.  This first version
// runs them as float32 FFMA from shared memory (each thread a 4 x D/32
// register tile of its outputs, the scores 4 rows x 1 key a thread with
// 16-byte loads along D), not on the tensor cores: simple and exact to
// float32, far from the card's 989 TFLOP/s bf16 bound.  wgmma with TMA and a
// single fused pass are later work (ROADMAP.md).
//
// Shared memory at D = 256: K and V tiles 2 x 32 x 260 floats (rows padded by
// 4 floats, so that 8 lanes reading one column each of 8 rows hit 32 banks),
// Q and dO tiles 2 x 32 x 256, p and dS 2 x 32 x 33, lse and Delta: 140 KB,
// one block an SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBq = 32;        // query rows a tile
constexpr int kBk = 32;        // keys a tile
constexpr int kThreads = 256;  // 8 warps
constexpr int kPS = kBk + 1;   // row stride of the p and dS tiles

// dtype codes of the C interface (as the forward's)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

struct F32 {
  using T = float;
  static __device__ __forceinline__ float load(const T* p, size_t i) {
    return p[i];
  }
  static __device__ __forceinline__ void store(T* p, size_t i, float x) {
    p[i] = x;
  }
};

struct BF16 {
  using T = uint16_t;  // bf16 bits
  static __device__ __forceinline__ float load(const T* p, size_t i) {
    return __uint_as_float(static_cast<uint32_t>(p[i]) << 16);
  }
  // round to nearest even (NaN stays NaN)
  static __device__ __forceinline__ void store(T* p, size_t i, float x) {
    const uint32_t u = __float_as_uint(x);
    p[i] = (u & 0x7fffffffu) > 0x7f800000u
               ? static_cast<uint16_t>(0x7fc0u)
               : static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
  }
};

// Shared-memory plan of one head dim: offsets in floats.
template <int D>
struct Plan {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256, "D");
  static constexpr int kKS = D + 4;  // K and V row stride (padded)
  static constexpr int kK = 0;
  static constexpr int kV = kK + kBk * kKS;
  static constexpr int kQ = kV + kBk * kKS;
  static constexpr int kDO = kQ + kBq * D;
  static constexpr int kP = kDO + kBq * D;
  static constexpr int kDS = kP + kBq * kPS;
  static constexpr int kLse = kDS + kBq * kPS;
  static constexpr int kDelta = kLse + kBq;
  static constexpr int kFloats = kDelta + kBq;
  static constexpr int kBytes = kFloats * 4;
  // the [32, D] register tile of the accumulating products: lanes along D
  // (kDL of them, D / kDL columns each), the rest of the block along the 32
  // rows (kRows each)
  static constexpr int kDL = D < 32 ? D : 32;
  static constexpr int kDI = D / kDL;
  static constexpr int kRowGroups = (kThreads / 32) * (32 / kDL);
  static constexpr int kRows = 32 / kRowGroups;
};

// rows [lo, lo + 32) of a [rows, D] matrix into shared memory as float32
// (row stride `stride`), zeros past `rows`
template <typename E, int D>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const typename E::T* src, int lo,
                                          int rows) {
  for (int i = threadIdx.x; i < 32 * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * stride + d] =
        lo + r < rows ? E::load(src, static_cast<size_t>(lo + r) * D + d)
                      : 0.f;
  }
}

__device__ __forceinline__ bool live(int qp, int kp, int sq, int skv,
                                     int causal, int window) {
  return qp < sq && kp < skv && (!causal || qp >= kp) &&
         (window <= 0 || qp - kp < window);
}

// p and dS of one (32-row, 32-key) tile pair into shared memory.  Thread t
// takes key t % 32 and rows t / 32 + 8 j (j < 4): a warp reads one row of Q
// and dO (broadcast) and 32 rows of K and V (padded: no bank conflict),
// 16 bytes at a time.
template <int D>
__device__ __forceinline__ void p_and_ds(float* sm, int q_lo, int k_lo, int sq,
                                         int skv, int causal, int window,
                                         float softcap) {
  using P = Plan<D>;
  const int c = threadIdx.x % 32;
  const int r0 = threadIdx.x / 32;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  float dp[4] = {0.f, 0.f, 0.f, 0.f};
  const float* krow = sm + P::kK + c * P::kKS;
  const float* vrow = sm + P::kV + c * P::kKS;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(krow + d);
    const float4 vv = *reinterpret_cast<const float4*>(vrow + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = r0 + 8 * j;
      const float4 qv =
          *reinterpret_cast<const float4*>(sm + P::kQ + r * D + d);
      const float4 ov =
          *reinterpret_cast<const float4*>(sm + P::kDO + r * D + d);
      s[j] = fmaf(qv.x, kv.x, s[j]);
      s[j] = fmaf(qv.y, kv.y, s[j]);
      s[j] = fmaf(qv.z, kv.z, s[j]);
      s[j] = fmaf(qv.w, kv.w, s[j]);
      dp[j] = fmaf(ov.x, vv.x, dp[j]);
      dp[j] = fmaf(ov.y, vv.y, dp[j]);
      dp[j] = fmaf(ov.z, vv.z, dp[j]);
      dp[j] = fmaf(ov.w, vv.w, dp[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = r0 + 8 * j;
    float p = 0.f, ds = 0.f;
    if (live(q_lo + r, k_lo + c, sq, skv, causal, window)) {
      float x = s[j], t = 0.f;
      if (softcap > 0.f) {
        t = tanhf(x / softcap);
        x = softcap * t;
      }
      p = expf(x - sm[P::kLse + r]);
      ds = p * (dp[j] - sm[P::kDelta + r]);
      if (softcap > 0.f) ds *= 1.f - t * t;
    }
    sm[P::kP + r * kPS + c] = p;
    sm[P::kDS + r * kPS + c] = ds;
  }
}

// acc[i][e] += sum_r a[r][row(i)] * b[r][col(e)] over the 32 rows r of a
// tile pair: a is a p or dS tile read transposed (row(i) a key), b a [32, D]
// tile (Q or dO).  Thread: rows kRows * group + i, columns lane % kDL + kDL e.
template <int D>
__device__ __forceinline__ void acc_at_b(float (&acc)[Plan<D>::kRows]
                                                     [Plan<D>::kDI],
                                         const float* a, const float* b) {
  using P = Plan<D>;
  const int lane = threadIdx.x % 32;
  const int grp = (threadIdx.x / 32) * (32 / P::kDL) + lane / P::kDL;
  const int col = lane % P::kDL;
#pragma unroll 4
  for (int r = 0; r < kBq; ++r) {
    float bv[P::kDI];
#pragma unroll
    for (int e = 0; e < P::kDI; ++e) bv[e] = b[r * D + col + P::kDL * e];
#pragma unroll
    for (int i = 0; i < P::kRows; ++i) {
      const float av = a[r * kPS + grp * P::kRows + i];
#pragma unroll
      for (int e = 0; e < P::kDI; ++e) acc[i][e] = fmaf(av, bv[e], acc[i][e]);
    }
  }
}

// acc[i][e] += sum_c dS[row(i)][c] * K[c][col(e)] over the 32 keys of a tile
template <int D>
__device__ __forceinline__ void acc_ds_k(float (&acc)[Plan<D>::kRows]
                                                     [Plan<D>::kDI],
                                         const float* ds, const float* k) {
  using P = Plan<D>;
  const int lane = threadIdx.x % 32;
  const int grp = (threadIdx.x / 32) * (32 / P::kDL) + lane / P::kDL;
  const int col = lane % P::kDL;
#pragma unroll 4
  for (int c = 0; c < kBk; ++c) {
    float kv[P::kDI];
#pragma unroll
    for (int e = 0; e < P::kDI; ++e) kv[e] = k[c * P::kKS + col + P::kDL * e];
#pragma unroll
    for (int i = 0; i < P::kRows; ++i) {
      const float dv = ds[(grp * P::kRows + i) * kPS + c];
#pragma unroll
      for (int e = 0; e < P::kDI; ++e) acc[i][e] = fmaf(dv, kv[e], acc[i][e]);
    }
  }
}

// write a [32, D] register tile to rows [lo, lo + 32) of a [rows, D] matrix
template <typename E, int D>
__device__ __forceinline__ void store_tile(
    const float (&acc)[Plan<D>::kRows][Plan<D>::kDI], typename E::T* dst,
    int lo, int rows) {
  using P = Plan<D>;
  const int lane = threadIdx.x % 32;
  const int grp = (threadIdx.x / 32) * (32 / P::kDL) + lane / P::kDL;
  const int col = lane % P::kDL;
#pragma unroll
  for (int i = 0; i < P::kRows; ++i) {
    const int r = lo + grp * P::kRows + i;
    if (r >= rows) continue;
#pragma unroll
    for (int e = 0; e < P::kDI; ++e)
      E::store(dst, static_cast<size_t>(r) * D + col + P::kDL * e, acc[i][e]);
  }
}

// Delta_i = sum_d dO_id O_id, one warp a row
template <typename EQK>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const typename EQK::T* __restrict__ o,
             const typename EQK::T* __restrict__ dout,
             float* __restrict__ delta, long long n_rows, int d) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  for (int i = lane; i < d; i += 32) {
    const size_t at = static_cast<size_t>(row) * d + i;
    acc = fmaf(EQK::load(dout, at), EQK::load(o, at), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <typename EQK, typename EV, int D>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const typename EQK::T* __restrict__ q,
            const typename EQK::T* __restrict__ k,
            const typename EV::T* __restrict__ v,
            const typename EQK::T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            typename EQK::T* __restrict__ dk, typename EV::T* __restrict__ dv,
            int g, int sq, int skv, int causal, int window, float softcap) {
  using P = Plan<D>;
  extern __shared__ __align__(16) float sm[];
  const int kv_head = blockIdx.y;
  const int k_lo = blockIdx.x * kBk;
  const int k_hi = min(k_lo + kBk, skv) - 1;
  const int nq = (sq + kBq - 1) / kBq;
  // live query tiles: none wholly above the diagonal (causal: i >= j), none
  // wholly past the window (i - j < window)
  const int qt_begin = causal ? k_lo / kBq : 0;
  int qt_end = nq;
  if (window > 0) qt_end = min(nq, (k_hi + window - 1) / kBq + 1);

  const size_t kv_off = static_cast<size_t>(kv_head) * skv * D;
  load_tile<EQK, D>(sm + P::kK, P::kKS, k + kv_off, k_lo, skv);
  load_tile<EV, D>(sm + P::kV, P::kKS, v + kv_off, k_lo, skv);
  float acc_dk[P::kRows][P::kDI], acc_dv[P::kRows][P::kDI];
#pragma unroll
  for (int i = 0; i < P::kRows; ++i)
#pragma unroll
    for (int e = 0; e < P::kDI; ++e) acc_dk[i][e] = acc_dv[i][e] = 0.f;

#pragma unroll 1
  for (int h = 0; h < g; ++h) {
    const int head = kv_head * g + h;
    const size_t q_off = static_cast<size_t>(head) * sq * D;
#pragma unroll 1
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q_lo = qt * kBq;
      __syncthreads();  // the last tile pair is done with Q, dO, p, dS
      load_tile<EQK, D>(sm + P::kQ, D, q + q_off, q_lo, sq);
      load_tile<EQK, D>(sm + P::kDO, D, dout + q_off, q_lo, sq);
      if (threadIdx.x < kBq) {
        const int r = q_lo + threadIdx.x;
        const size_t at = static_cast<size_t>(head) * sq + r;
        sm[P::kLse + threadIdx.x] = r < sq ? lse[at] : 0.f;
        sm[P::kDelta + threadIdx.x] = r < sq ? delta[at] : 0.f;
      }
      __syncthreads();
      p_and_ds<D>(sm, q_lo, k_lo, sq, skv, causal, window, softcap);
      __syncthreads();
      acc_at_b<D>(acc_dv, sm + P::kP, sm + P::kDO);
      acc_at_b<D>(acc_dk, sm + P::kDS, sm + P::kQ);
    }
  }
  store_tile<EQK, D>(acc_dk, dk + kv_off, k_lo, skv);
  store_tile<EV, D>(acc_dv, dv + kv_off, k_lo, skv);
}

template <typename EQK, typename EV, int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const typename EQK::T* __restrict__ q,
          const typename EQK::T* __restrict__ k,
          const typename EV::T* __restrict__ v,
          const typename EQK::T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          typename EQK::T* __restrict__ dq, int g, int sq, int skv,
          int causal, int window, float softcap) {
  using P = Plan<D>;
  extern __shared__ __align__(16) float sm[];
  const int head = blockIdx.y;
  const int kv_head = head / g;
  // the last query tiles have the most live key tiles under a causal mask:
  // hand them out first
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * kBq;
  const int q_hi = min(q_lo + kBq, sq) - 1;
  const int nk = (skv + kBk - 1) / kBk;
  int kt_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0) kt_begin = (q_lo - window + 1) / kBk;
  int kt_end = nk;
  if (causal) kt_end = min(nk, q_hi / kBk + 1);

  const size_t q_off = static_cast<size_t>(head) * sq * D;
  const size_t kv_off = static_cast<size_t>(kv_head) * skv * D;
  load_tile<EQK, D>(sm + P::kQ, D, q + q_off, q_lo, sq);
  load_tile<EQK, D>(sm + P::kDO, D, dout + q_off, q_lo, sq);
  if (threadIdx.x < kBq) {
    const int r = q_lo + threadIdx.x;
    const size_t at = static_cast<size_t>(head) * sq + r;
    sm[P::kLse + threadIdx.x] = r < sq ? lse[at] : 0.f;
    sm[P::kDelta + threadIdx.x] = r < sq ? delta[at] : 0.f;
  }
  float acc[P::kRows][P::kDI];
#pragma unroll
  for (int i = 0; i < P::kRows; ++i)
#pragma unroll
    for (int e = 0; e < P::kDI; ++e) acc[i][e] = 0.f;

#pragma unroll 1
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k_lo = kt * kBk;
    __syncthreads();  // the last key tile is done with K, V and dS
    load_tile<EQK, D>(sm + P::kK, P::kKS, k + kv_off, k_lo, skv);
    load_tile<EV, D>(sm + P::kV, P::kKS, v + kv_off, k_lo, skv);
    __syncthreads();
    p_and_ds<D>(sm, q_lo, k_lo, sq, skv, causal, window, softcap);
    __syncthreads();
    acc_ds_k<D>(acc, sm + P::kDS, sm + P::kK);
  }
  store_tile<EQK, D>(acc, dq + q_off, q_lo, sq);
}

template <typename EQK, typename EV, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int bhg, int g, int sq, int skv, int causal,
           int window, float softcap, cudaStream_t stream) {
  using P = Plan<D>;
  using TQ = typename EQK::T;
  using TV = typename EV::T;
  const int bhkv = bhg / g;
  const long long rows = static_cast<long long>(bhg) * sq;
  const long long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (delta_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  delta_kernel<EQK><<<static_cast<unsigned>(delta_blocks), kThreads, 0,
                       stream>>>(static_cast<const TQ*>(o),
                                 static_cast<const TQ*>(dout), delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(dkdv_kernel<EQK, EV, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((skv + kBk - 1) / kBk, bhkv);
  dkdv_kernel<EQK, EV, D><<<grid_kv, kThreads, P::kBytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(k),
      static_cast<const TV*>(v), static_cast<const TQ*>(dout), lse, delta,
      static_cast<TQ*>(dk), static_cast<TV*>(dv), g, sq, skv, causal, window,
      softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(dq_kernel<EQK, EV, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((sq + kBq - 1) / kBq, bhg);
  dq_kernel<EQK, EV, D><<<grid_q, kThreads, P::kBytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(k),
      static_cast<const TV*>(v), static_cast<const TQ*>(dout), lse, delta,
      static_cast<TQ*>(dq), g, sq, skv, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename EQK, typename EV>
int launch_d(int d, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const float* lse, float* delta,
             void* dq, void* dk, void* dv, int bhg, int g, int sq, int skv,
             int causal, int window, float softcap, cudaStream_t stream) {
#define FLASH_BWD_CASE(D)                                                   \
  case D:                                                                   \
    return launch<EQK, EV, D>(q, k, v, o, dout, lse, delta, dq, dk, dv, bhg, \
                              g, sq, skv, causal, window, softcap, stream);
  switch (d) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(128)
    FLASH_BWD_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_BWD_CASE
}

}  // namespace

// q, o, dout, dq: [bhg, sq, d] of `qk_dtype`; k, dk: [bhg / g, skv, d] of
// `qk_dtype`; v, dv: [bhg / g, skv, d] of `v_dtype` (0 float32, 1 bfloat16:
// both float32, both bfloat16, or float32 q and k with bfloat16 v); lse (the
// forward's) and delta (scratch, written here): float32 [bhg, sq].  All
// contiguous on the device.  d in {16, 32, 64, 128, 256}; bhg <= 65535 (grid
// y); sq, skv >= 1.  window <= 0 means none, softcap <= 0 means none.
// Launches three kernels on `stream`; returns the first cudaGetLastError()
// that is not success (cudaErrorInvalidValue for an unsupported dtype pair
// or d).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int bhg, int g, int sq, int skv, int d, int qk_dtype,
    int v_dtype, int causal, int window, float softcap, void* stream) {
  if (bhg <= 0 || sq <= 0 || skv <= 0 || g <= 0 || bhg % g)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* de = static_cast<float*>(delta);
  if (qk_dtype == kFloat32 && v_dtype == kFloat32)
    return launch_d<F32, F32>(d, q, k, v, o, dout, l, de, dq, dk, dv, bhg, g,
                              sq, skv, causal, window, softcap, s);
  if (qk_dtype == kBFloat16 && v_dtype == kBFloat16)
    return launch_d<BF16, BF16>(d, q, k, v, o, dout, l, de, dq, dk, dv, bhg,
                                g, sq, skv, causal, window, softcap, s);
  if (qk_dtype == kFloat32 && v_dtype == kBFloat16)
    return launch_d<F32, BF16>(d, q, k, v, o, dout, l, de, dq, dk, dv, bhg, g,
                               sq, skv, causal, window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
