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
//   ckpt [B, Di, S / 16 + 1, N]    optional (null: not written): the state
//                                  before steps 0, 16, 32, ... (and after
//                                  the last step when 16 divides S), for
//                                  the backward kernel
//                                  (selective_scan_bwd.cu), which
//                                  recomputes the states between two of
//                                  them; y and the state keep their bits
//                                  either way
// x * B is formed here, one step at a time: the reference materialises it
// for all steps at once (17 GB a layer at jamba's 32k prefill).
//
// What bounds it: on paper, bytes (0.96 ms at a jamba Mamba layer's 32k
// prefill).  A step reads x and dt of every channel and writes y (12 bytes
// a channel), and B and C (128 bytes a row, shared by all its channels);
// its arithmetic is some 8 float operations and an exp per state value.  In
// practice the dispatch of instructions and their latency: the exp (expf,
// eight instructions, one of them on the quarter-rate MUFU pipe) and the
// products of the B * Di * N state values a step, whose steps are a
// dependent chain.  The design spreads them over the card:
//   * a channel is held by kLanes = 4 neighbouring lanes of one warp, lane
//     l owning the N / 4 contiguous state values n in [l N/4, (l + 1) N/4)
//     and their decay rates, in registers (4 each at N 16; 2 at N 8, 1 at
//     N 4);
//   * a block holds kChannels = 16 consecutive channels of one batch row
//     (64 threads): 512 blocks at jamba's Di 8,192, some 8 warps an SM on
//     all 132 SMs, where one thread a channel filled 64 SMs with 4 warps
//     (blocks of 32 channels were some 7 % slower at the 32k layer);
//   * the block stages kChunk steps at a time in shared memory, by cp.async
//     copies that pass no register: x and dt of its channels and the rows
//     of B and C, coalesced, 16 bytes a copy when the operands are 16-byte
//     aligned and Di a multiple of 4 (else 4); a channel's lanes then read
//     x and dt as a broadcast, and each lane its range of B and C.  Two
//     buffers: the next chunk's copies are in flight while this one is
//     computed;
//   * a full chunk's kGroup = 16 steps are unrolled: their exps and input
//     terms first (they do not depend on the state), then the state's
//     chain (two operations a step) and the products with C, then the
//     shuffles of all 16 sums, in flight together;
//   * y is summed over n in the recursive halves tree: each lane sums its
//     range (tree_sum), then the lanes add their neighbours' sums by
//     __shfl_xor_sync at xor 1, then 2; a pair's two lanes add the same two
//     values, so both hold the same bits.  For a power-of-two N that is the
//     pairwise tree, level by level, of the plain version's tree_sum
//     (kernels/selective_scan/ref.py).  A different split (lanes owning
//     interleaved n, or the xors in another order) adds in another order
//     and gives other bits (tests/test_torch_scan_split.py).
// Channels past Di (the ragged edge) compute on what the buffers hold, so
// that every lane of a warp takes part in the shuffles, and store nothing.
// Every float operation but the exp is an intrinsic (__fmul_rn,
// __fadd_rn), so nvcc does not contract them into FMAs and each rounds
// once, as the plain version's does; the exp is expf (not the fast
// __expf), the function torch's exp calls.  So the two agree bit for bit,
// and the result is deterministic.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kLanes = 4;      // lanes a channel
constexpr int kChannels = 16;  // channels of one batch row a block
constexpr int kThreads = kChannels * kLanes;  // threads a block
constexpr int kChunk = 16;     // steps a block stages at once (two buffers)
constexpr int kGroup = 16;     // steps of a chunk unrolled together

// copy of W floats (1, or 4 on 16-byte aligned addresses) from device to
// shared memory that does not pass through registers (cp.async, sm_80 and
// later); completes at the next wait.
template <int W>
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (W == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    static_assert(W == 1, "4 or 16 bytes a copy");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  }
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

// V floats (1, 2 or 4) from shared memory aligned to V floats
template <int V>
__device__ __forceinline__ void load_vals(float (&dst)[V], const float* src) {
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x;
    dst[1] = x.y;
    dst[2] = x.z;
    dst[3] = x.w;
  } else if constexpr (V == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x;
    dst[1] = x.y;
  } else {
    static_assert(V == 1, "1, 2 or 4 values a lane");
    dst[0] = src[0];
  }
}

template <int N>
struct __align__(16) Stage {
  float x[kChunk][kChannels];
  float dt[kChunk][kChannels];
  float b[kChunk * N];
  float c[kChunk * N];
};

// Start the copies of chunk `t0` (len steps) into `st`: x and dt of the
// block's channels (from channel d0; none past di) and the rows of B and C,
// W floats a copy (4 when every operand is 16-byte aligned and di a
// multiple of 4, so that no copy straddles the edge).
template <int N, int W>
__device__ __forceinline__ void stage_chunk(Stage<N>& st, const float* xi,
                                            const float* dt, const float* bm,
                                            const float* cm, size_t row0,
                                            int t0, int len, int d0, int di) {
  constexpr int kPerRow = kChannels / W;  // copies a row of x
  for (int e = threadIdx.x; e < len * kPerRow; e += kThreads) {
    const int j = e / kPerRow;
    const int c = e % kPerRow * W;
    if (d0 + c < di) {
      const size_t off = (row0 + t0 + j) * di + d0 + c;
      copy_async<W>(&st.x[j][c], xi + off);
      copy_async<W>(&st.dt[j][c], dt + off);
    }
  }
  const float* bsrc = bm + (row0 + t0) * N;
  const float* csrc = cm + (row0 + t0) * N;
  for (int i = threadIdx.x * W; i < len * N; i += kThreads * W) {
    copy_async<W>(&st.b[i], bsrc + i);
    copy_async<W>(&st.c[i], csrc + i);
  }
  commit_copies();
}

// G consecutive steps of a chunk from step j0: this lane's state values
// updated, and y of each step written (by the first lane of an on channel)
// to y_ch[t * di].  The G steps' exps and input terms, which do not depend
// on the state, come first; then the state's chain (two operations a step)
// and the products with C; then the G sums' shuffles, in flight together.
template <int N, int G>
__device__ __forceinline__ void steps(const Stage<N>& cur, int j0,
                                      float (&st)[N / kLanes],
                                      const float (&av)[N / kLanes], int ch,
                                      int n0, bool store, float* y_ch,
                                      size_t di) {
  constexpr int V = N / kLanes;
  float da[G][V], hbx[G][V], part[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float x = cur.x[j0 + g][ch];
    const float h = cur.dt[j0 + g][ch];
    float bb[V];
    load_vals<V>(bb, &cur.b[(j0 + g) * N + n0]);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      da[g][q] = expf(__fmul_rn(h, av[q]));
      hbx[g][q] = __fmul_rn(h, __fmul_rn(x, bb[q]));
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float cc[V], term[V];
    load_vals<V>(cc, &cur.c[(j0 + g) * N + n0]);
#pragma unroll
    for (int q = 0; q < V; ++q) {
      st[q] = __fadd_rn(__fmul_rn(st[q], da[g][q]), hbx[g][q]);
      term[q] = __fmul_rn(st[q], cc[q]);
    }
    part[g] = tree_sum<0, V>(term);
  }
#pragma unroll
  for (int m = 1; m < kLanes; m <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      part[g] = __fadd_rn(part[g], __shfl_xor_sync(0xffffffffu, part[g], m));
  }
  if (store) {
#pragma unroll
    for (int g = 0; g < G; ++g) y_ch[(j0 + g) * di] = part[g];
  }
}

template <int N, int W>
__global__ void __launch_bounds__(kThreads)
    selective_scan_kernel(const float* __restrict__ xi,
                          const float* __restrict__ dt,
                          const float* __restrict__ bm,
                          const float* __restrict__ cm,
                          const float* __restrict__ a,
                          float* __restrict__ state, float* __restrict__ y,
                          float* __restrict__ ckpt, int s, int di) {
  constexpr int V = N / kLanes;  // state values a lane
  static_assert(V * kLanes == N, "N is 4, 8 or 16");
  __shared__ Stage<N> stage[2];
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;  // the block's first channel
  const int ch = threadIdx.x / kLanes;    // channel within the block
  const int sub = threadIdx.x % kLanes;   // which range of n
  const int d = d0 + ch;
  const int n0 = sub * V;                 // first n of the range
  const bool on = d < di;
  float st[V], av[V];
  float* st_row = state + (static_cast<size_t>(b) * di + d) * N + n0;
#pragma unroll
  for (int q = 0; q < V; ++q) {
    st[q] = on ? st_row[q] : 0.f;
    av[q] = on ? a[static_cast<size_t>(d) * N + n0 + q] : 0.f;
  }
  const size_t row0 = static_cast<size_t>(b) * s;  // first step of row b
  const bool store = on && sub == 0;
  // checkpoint n of this lane's values: the state before step 16 n
  float* ck_row = nullptr;
  if (ckpt != nullptr && on)
    ck_row = ckpt + (static_cast<size_t>(b) * di + d) * (s / kChunk + 1) * N +
             n0;

  stage_chunk<N, W>(stage[0], xi, dt, bm, cm, row0, 0, min(kChunk, s), d0,
                    di);
  for (int t0 = 0, buf = 0; t0 < s; t0 += kChunk, buf ^= 1) {
    const int len = min(kChunk, s - t0);
    if (ck_row != nullptr) {
#pragma unroll
      for (int q = 0; q < V; ++q) ck_row[t0 / kChunk * N + q] = st[q];
    }
    if (t0 + kChunk < s) {
      // the next chunk's copies run while this one is computed
      stage_chunk<N, W>(stage[buf ^ 1], xi, dt, bm, cm, row0, t0 + kChunk,
                        min(kChunk, s - t0 - kChunk), d0, di);
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();  // this chunk, staged by all, is in
    const Stage<N>& cur = stage[buf];
    float* y_ch = y + (row0 + t0) * di + d;
    if (len == kChunk) {
#pragma unroll
      for (int j = 0; j < kChunk; j += kGroup)
        steps<N, kGroup>(cur, j, st, av, ch, n0, store, y_ch, di);
    } else {
      for (int j = 0; j < len; ++j)
        steps<N, 1>(cur, j, st, av, ch, n0, store, y_ch, di);
    }
    __syncthreads();  // nobody reads this buffer when it is staged again
  }
  if (on) {
#pragma unroll
    for (int q = 0; q < V; ++q) st_row[q] = st[q];
  }
  if (ck_row != nullptr && s % kChunk == 0) {
#pragma unroll
    for (int q = 0; q < V; ++q) ck_row[s / kChunk * N + q] = st[q];
  }
}

template <int N>
int launch(const float* xi, const float* dt, const float* bm, const float* cm,
           const float* a, float* state, float* y, float* ckpt, int batch,
           int s, int di, cudaStream_t stream) {
  const dim3 grid((di + kChannels - 1) / kChannels, batch);
  const bool aligned = di % 4 == 0 &&
                       ((reinterpret_cast<uintptr_t>(xi) |
                         reinterpret_cast<uintptr_t>(dt) |
                         reinterpret_cast<uintptr_t>(bm) |
                         reinterpret_cast<uintptr_t>(cm)) & 15) == 0;
  if (aligned)
    selective_scan_kernel<N, 4><<<grid, kThreads, 0, stream>>>(
        xi, dt, bm, cm, a, state, y, ckpt, s, di);
  else
    selective_scan_kernel<N, 1><<<grid, kThreads, 0, stream>>>(
        xi, dt, bm, cm, a, state, y, ckpt, s, di);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xi, dt, y [batch, s, di]; bm, cm [batch, s, n]; a [di, n]; state [batch,
// di, n]; ckpt [batch, di, s / 16 + 1, n] or null; all float32, contiguous,
// on the device of `stream`.  n is 4, 8 or 16.  Returns the cudaError_t of
// the launch (0: launched).
extern "C" int selective_scan_launch(const void* xi, const void* dt,
                                     const void* bm, const void* cm,
                                     const void* a, void* state, void* y,
                                     void* ckpt, int batch, int s, int di,
                                     int n, void* stream) {
  if (batch <= 0 || s <= 0 || di <= 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const float*>(xi);
  const auto* h = static_cast<const float*>(dt);
  const auto* bp = static_cast<const float*>(bm);
  const auto* cp = static_cast<const float*>(cm);
  const auto* ap = static_cast<const float*>(a);
  auto* sp = static_cast<float*>(state);
  auto* yp = static_cast<float*>(y);
  auto* ck = static_cast<float*>(ckpt);
  auto st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4:
      return launch<4>(x, h, bp, cp, ap, sp, yp, ck, batch, s, di,
                          st);
    case 8:
      return launch<8>(x, h, bp, cp, ap, sp, yp, ck, batch, s, di,
                          st);
    case 16:
      return launch<16>(x, h, bp, cp, ap, sp, yp, ck, batch, s, di,
                          st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* selective_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
