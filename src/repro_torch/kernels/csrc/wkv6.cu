// RWKV-6 ("Finch") WKV recurrence over time, per batch row and head, with a
// float32 state S of [hd, hd] (key index first) and data-dependent decay.
//
// Replaces no TPU kernel: the reference runs this recurrence as an XLA
// `lax.scan` of `step` (src/repro/models/rwkv6.py:106, the step at :95).
// On the card a plain loop would issue some 8 launches a step and a layer
// (150 a decode step of rwkv6-1.6b's 24 layers, 6.3 million for a 32k
// prefill), so the whole scan is one launch here; prefill runs it over the
// prompt, decode at S = 1 on the cache's state.
//
// For every (b, h), over the steps t in order, with kv = k_t^T v_t:
//   o_t[j] = sum over i of r_t[i] * (S[i][j] + u[i] * kv[i][j])
//   S[i][j] <- S[i][j] * w_t[i] + kv[i][j]
// Operands, all float32 and contiguous:
//   r, k, v, w [B, S, H, hd]   read
//   u [H, hd]                  read
//   state [B, H, hd, hd]       read, then written with the last state
//   o [B, S, H, hd]            written
//
// What bounds it: bytes.  A step reads r, k, v and w and writes o, 20 bytes
// a (head, channel), and does some 6 float operations per state value
// (hd of them a channel), below the card's rate for those bytes.  What
// stands in the way is latency: the steps are a dependent chain, and the
// parallelism is B * H * hd threads (2,048 at rwkv6-1.6b's batch 1).  The
// design is the simple one:
//   * one block per (b, h), with hd threads; thread j holds column j of S
//     (hd values) in registers, and writes o_t[j] coalesced across the
//     block;
//   * the block stages r, k, w and v of kChunk steps at a time in shared
//     memory, by cp.async copies that pass no register (thread j copies
//     entry j of each row, coalesced; r, k and w are then read by every
//     thread, a broadcast), and u once.  Two buffers: the next chunk's
//     copies are in flight while this one is computed, so the loop does
//     not wait on device memory step by step;
//   * o_t[j] is summed over i by a pairwise tree (i and i + 1, then pairs
//     of those), log2(hd) additions deep, where a running sum would be hd.
// Every float operation is an intrinsic (__fmul_rn, __fadd_rn), so nvcc
// does not contract them into FMAs and each rounds once, as the plain
// version's does; and the plain version sums over i in the same tree
// (kernels/wkv6/ref.py).  So the two agree bit for bit, and the result is
// deterministic.  The head size is a template parameter: 64 (rwkv6-1.6b)
// and 16 (its smoke config); the launcher refuses any other.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kChunk = 16;  // steps a block stages at once (two buffers)

// 4-byte copy from device to shared memory that does not pass through
// registers (cp.async, sm_80 and later); completes at the next wait.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most `Pending` committed groups of this thread are in flight
template <int Pending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// sum of v[Lo, Lo + Len), Len a power of two, as the sum of its two halves'
// sums: for v[0..n) that is the pairwise tree, level by level, v[0] + v[1],
// v[2] + v[3], ..., then the same over those sums, the order the plain
// version's tree_sum adds in.  Every index is a constant, so v stays in
// registers.
template <int Lo, int Len, int N>
__device__ __forceinline__ float tree_sum(const float (&v)[N]) {
  if constexpr (Len == 1) {
    return v[Lo];
  } else {
    return __fadd_rn(tree_sum<Lo, Len / 2>(v),
                     tree_sum<Lo + Len / 2, Len / 2>(v));
  }
}

template <int HD>
struct Stage {
  float r[kChunk][HD];
  float k[kChunk][HD];
  float w[kChunk][HD];
  float v[kChunk][HD];
};

// Start the copies of `len` steps from element `first` (step stride
// `step`) into `st`: thread j copies entry j of every row.
template <int HD>
__device__ __forceinline__ void stage_chunk(Stage<HD>& st, const float* r,
                                            const float* k, const float* w,
                                            const float* v, size_t first,
                                            size_t step, int len) {
  const int j = threadIdx.x;
  for (int tt = 0; tt < len; ++tt) {
    const size_t off = first + tt * step + j;
    copy_async(&st.r[tt][j], r + off);
    copy_async(&st.k[tt][j], k + off);
    copy_async(&st.w[tt][j], w + off);
    copy_async(&st.v[tt][j], v + off);
  }
  commit_copies();
}

template <int HD>
__global__ void __launch_bounds__(HD)
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, float* __restrict__ state,
                float* __restrict__ o, int s, int h) {
  static_assert((HD & (HD - 1)) == 0, "the head size is a power of two");
  __shared__ Stage<HD> stage[2];
  __shared__ float su[HD];
  const int bh = blockIdx.x;  // b * h + head
  const int b = bh / h;
  const int head = bh - b * h;
  const int j = threadIdx.x;
  float col[HD];  // column j of S
  float* s_blk = state + static_cast<size_t>(bh) * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) col[i] = s_blk[i * HD + j];
  su[j] = u[static_cast<size_t>(head) * HD + j];
  const size_t step = static_cast<size_t>(h) * HD;  // floats between steps
  const size_t base = static_cast<size_t>(b) * s * step +
                      static_cast<size_t>(head) * HD;
  stage_chunk<HD>(stage[0], r, k, w, v, base, step, min(kChunk, s));
  for (int t0 = 0, buf = 0; t0 < s; t0 += kChunk, buf ^= 1) {
    const int len = min(kChunk, s - t0);
    if (t0 + kChunk < s) {
      // the next chunk's copies run while this one is computed
      stage_chunk<HD>(stage[buf ^ 1], r, k, w, v,
                      base + (t0 + kChunk) * step, step,
                      min(kChunk, s - t0 - kChunk));
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();  // this chunk, staged by all, is in (and su is set)
    const Stage<HD>& cur = stage[buf];
    for (int tt = 0; tt < len; ++tt) {
      const float vj = cur.v[tt][j];
      float term[HD];
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = __fmul_rn(cur.k[tt][i], vj);
        const float att = __fadd_rn(col[i], __fmul_rn(su[i], kv));
        term[i] = __fmul_rn(cur.r[tt][i], att);
        col[i] = __fadd_rn(__fmul_rn(col[i], cur.w[tt][i]), kv);
      }
      o[base + (t0 + tt) * step + j] = tree_sum<0, HD>(term);
    }
    __syncthreads();  // nobody reads this buffer when it is staged again
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) s_blk[i * HD + j] = col[i];
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, float* state, float* o, int batch, int s, int h,
           cudaStream_t stream) {
  wkv6_kernel<HD><<<batch * h, HD, 0, stream>>>(r, k, v, w, u, state, o, s,
                                                h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, w, o [batch, s, h, hd]; u [h, hd]; state [batch, h, hd, hd];
// all float32, contiguous, on the device of `stream`.  hd is 16 or 64.
// Returns the cudaError_t of the launch (0: launched).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, void* state, void* o,
                           int batch, int s, int h, int hd, void* stream) {
  if (batch <= 0 || s <= 0 || h <= 0 ||
      static_cast<long long>(batch) * h > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* rp = static_cast<const float*>(r);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* wp = static_cast<const float*>(w);
  const auto* up = static_cast<const float*>(u);
  auto* sp = static_cast<float*>(state);
  auto* op = static_cast<float*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(rp, kp, vp, wp, up, sp, op, batch, s, h, st);
    case 64:
      return launch<64>(rp, kp, vp, wp, up, sp, op, batch, s, h, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
