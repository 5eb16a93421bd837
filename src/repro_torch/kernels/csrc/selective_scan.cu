// Mamba's selective scan (S6) over time, for a diagonal state of N <= 16
// values per channel.
//
// Replaces no TPU kernel: the reference runs this recurrence as an XLA
// `lax.scan` of `_ssm_step` (src/repro/models/mamba.py:93, the step at
// :55).  On the card a plain loop would issue some 8 launches a step and a
// layer, so the whole scan is one launch here; prefill runs it over the
// prompt, decode at S = 1 on the cache's state.
//
// For every batch row b and channel d, over the steps t in order:
//   state[n] <- state[n] * exp(dt[t] * A[d, n]) + dt[t] * (x[t] * B[t, n])
//   y[t]     =  sum over n of state[n] * C[t, n]
// Operands, all float32 and contiguous:
//   xi [B, S, Di], dt [B, S, Di]   read
//   bm [B, S, N],  cm [B, S, N]    read
//   a  [Di, N]                     read
//   state [B, Di, N]               read, then written with the last state
//   y  [B, S, Di]                  written
// x * B is formed here, one step at a time: the reference materialises it
// for all steps at once (17 GB a layer at jamba's 32k prefill).
//
// What bounds it: bytes.  A step reads x and dt of every channel and writes
// y (12 bytes a channel), and B and C (128 bytes a row, shared by all its
// channels); its arithmetic is some 8 float operations and an exp per
// state value, far below the card's rate for those bytes.  What stands in
// the way is latency: the steps of a channel are a dependent chain, so
// the parallelism is only B * Di threads (8,192 at jamba's batch 1).  The
// design is the simple one:
//   * one thread per (b, d), blocks of kThreads consecutive channels of
//     one batch row: the N state values and the N decay rates live in
//     registers, and x, dt and y are read and written coalesced across the
//     block (kThreads * 4 bytes a step);
//   * the block stages kChunk steps at a time in shared memory, by
//     cp.async copies that pass no register: each thread its own x and
//     dt, the block together B and C (which every thread then reads, a
//     broadcast).  Two buffers: the next chunk's copies are in flight
//     while this one is computed, so the loop does not wait on device
//     memory step by step;
//   * the N products of a step are independent chains, which the unrolled
//     loop interleaves; y is summed over n by a pairwise tree (n and n + 1,
//     then pairs of those), log2(N) additions deep.
// Every float operation but the exp is an intrinsic (__fmul_rn,
// __fadd_rn), so nvcc does not contract them into FMAs and each rounds
// once, as the plain version's does; the exp is expf (not the fast
// __expf), the function torch's exp calls; and the plain version sums over
// n in the same tree (kernels/selective_scan/ref.py, tree_sum).  So the
// two agree bit for bit, and the result is deterministic.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;  // channels of one batch row a block
constexpr int kChunk = 16;     // steps a block stages at once (two buffers)

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

template <int N>
struct Stage {
  float x[kChunk][kThreads];
  float dt[kChunk][kThreads];
  float b[kChunk * N];
  float c[kChunk * N];
};

// Start the copies of chunk `t0` (len steps) into `st`: each thread its own
// channel's x and dt, the block together the rows of B and C.
template <int N>
__device__ __forceinline__ void stage_chunk(Stage<N>& st, const float* xi,
                                            const float* dt, const float* bm,
                                            const float* cm, size_t row0,
                                            int t0, int len, int d, bool on,
                                            int di) {
  if (on) {
    for (int j = 0; j < len; ++j) {
      const size_t off = (row0 + t0 + j) * di + d;
      copy_async(&st.x[j][threadIdx.x], xi + off);
      copy_async(&st.dt[j][threadIdx.x], dt + off);
    }
  }
  const float* bsrc = bm + (row0 + t0) * N;
  const float* csrc = cm + (row0 + t0) * N;
  for (int i = threadIdx.x; i < len * N; i += kThreads) {
    copy_async(&st.b[i], bsrc + i);
    copy_async(&st.c[i], csrc + i);
  }
  commit_copies();
}

template <int N>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const float* __restrict__ xi,
                          const float* __restrict__ dt,
                          const float* __restrict__ bm,
                          const float* __restrict__ cm,
                          const float* __restrict__ a,
                          float* __restrict__ state, float* __restrict__ y,
                          int s, int di) {
  __shared__ Stage<N> stage[2];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool on = d < di;
  float st[N], av[N];
  float* st_row = state + (static_cast<size_t>(b) * di + d) * N;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    st[n] = on ? st_row[n] : 0.f;
    av[n] = on ? a[static_cast<size_t>(d) * N + n] : 0.f;
  }
  const size_t row0 = static_cast<size_t>(b) * s;  // first step of row b
  stage_chunk<N>(stage[0], xi, dt, bm, cm, row0, 0, min(kChunk, s), d, on,
                 di);
  for (int t0 = 0, buf = 0; t0 < s; t0 += kChunk, buf ^= 1) {
    const int len = min(kChunk, s - t0);
    if (t0 + kChunk < s) {
      // the next chunk's copies run while this one is computed
      stage_chunk<N>(stage[buf ^ 1], xi, dt, bm, cm, row0, t0 + kChunk,
                     min(kChunk, s - t0 - kChunk), d, on, di);
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();  // this chunk's B and C, staged by all, are in
    const Stage<N>& cur = stage[buf];
    if (on) {
      for (int j = 0; j < len; ++j) {
        const float x = cur.x[j][threadIdx.x];
        const float h = cur.dt[j][threadIdx.x];
        float term[N];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          const float da = expf(__fmul_rn(h, av[n]));
          const float bx = __fmul_rn(x, cur.b[j * N + n]);
          st[n] = __fadd_rn(__fmul_rn(st[n], da), __fmul_rn(h, bx));
          term[n] = __fmul_rn(st[n], cur.c[j * N + n]);
        }
        y[(row0 + t0 + j) * di + d] = tree_sum<0, N>(term);
      }
    }
    __syncthreads();  // nobody reads this buffer when it is staged again
  }
  if (on) {
#pragma unroll
    for (int n = 0; n < N; ++n) st_row[n] = st[n];
  }
}

template <int N>
int launch(const float* xi, const float* dt, const float* bm, const float* cm,
           const float* a, float* state, float* y, int batch, int s, int di,
           cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, batch);
  selective_scan_kernel<N><<<grid, kThreads, 0, stream>>>(xi, dt, bm, cm, a,
                                                           state, y, s, di);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xi, dt, y [batch, s, di]; bm, cm [batch, s, n]; a [di, n]; state [batch,
// di, n]; all float32, contiguous, on the device of `stream`.  n is 4, 8 or
// 16.  Returns the cudaError_t of the launch (0: launched).
extern "C" int selective_scan_launch(const void* xi, const void* dt,
                                     const void* bm, const void* cm,
                                     const void* a, void* state, void* y,
                                     int batch, int s, int di, int n,
                                     void* stream) {
  if (batch <= 0 || s <= 0 || di <= 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const float*>(xi);
  const auto* h = static_cast<const float*>(dt);
  const auto* bp = static_cast<const float*>(bm);
  const auto* cp = static_cast<const float*>(cm);
  const auto* ap = static_cast<const float*>(a);
  auto* sp = static_cast<float*>(state);
  auto* yp = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4:
      return launch<4>(x, h, bp, cp, ap, sp, yp, batch, s, di, st);
    case 8:
      return launch<8>(x, h, bp, cp, ap, sp, yp, batch, s, di, st);
    case 16:
      return launch<16>(x, h, bp, cp, ap, sp, yp, batch, s, di, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* selective_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
