// Backward of Mamba's selective scan (csrc/selective_scan.cu), per batch row
// and channel, from the forward's state checkpoints.
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of
// the `lax.scan` of `_ssm_step` (src/repro/models/mamba.py:93, the step at
// :55).  The forward, with s_t the state after step t (s_{-1} the initial
// state) and e_t = exp(dt_t A):
//   s_t = s_{t-1} e_t + dt_t x_t B_t,     y_t = sum over n of s_t C_t.
// With G_t the gradient of s_t (y_t reads the state after its update):
// G_t = dy_t C_t + G_{t+1} e_{t+1}, the last one's second term being the
// final state's gradient dstate_T; for t from the last step down:
//   dx_t  = sum over n of G_t dt_t B_t
//   ddt_t = sum over n of G_t (A s_{t-1} e_t + x_t B_t)
//   dB_t  = sum over channels of G_t dt_t x_t
//   dC_t  = sum over channels of s_t dy_t
//   dA   += G_t s_{t-1} e_t dt_t          (over t, then over b)
//   dstate_0 = G_0 e_0.
// Operands, all float32 and contiguous:
//   xi, dt, dy [B, S, Di]        read (dy: the gradient of y)
//   bm, cm [B, S, N]             read
//   a [Di, N]                    read
//   ckpt [B, Di, S / 16 + 1, N]  read: the forward's checkpoints
//   dstate [B, Di, N]            read: the gradient of the final state
//   dxi, ddt [B, S, Di]; dbm, dcm [B, S, N]; da [Di, N]; dstate0 [B, Di, N]
//                                written
//   work                         scratch (selective_scan_bwd_workspace)
//
// What bounds it: on paper the float operations (24 a state value and step
// with two exps: the recomputed step, the gradient's) against the
// bytes (7 arrays of B S Di read or written, the checkpoints, and B and C's
// partials), of one order at jamba's width; in practice, as in the forward,
// instruction issue and latency, the exps among them.  The design keeps the
// forward's layout:
//   * a channel is held by kLanes = 4 neighbouring lanes, lane l owning the
//     N / 4 contiguous state values n in [l N/4, (l + 1) N/4); a block
//     holds kChannels = 16 channels of one batch row (64 threads);
//   * the block walks the checkpoints' chunks of 16 steps from the last:
//     it stages the chunk's x, dt and dy of its channels and the rows of B
//     and C in shared memory (cp.async, 16 bytes a copy when every operand
//     is 16-byte aligned and Di a multiple of 4, else 4), reads the
//     checkpoint before the chunk, recomputes the chunk's states with the
//     forward's own operations (so their bits are the forward's) into
//     shared memory, a thread's own values a step, then runs the 16 steps
//     backwards;
//   * dx and ddt sum over n: a lane's values, then xor 1, 2, as the
//     forward's y; dB and dC sum over the channels: a reduce-scatter over
//     the warp's 8 channels (at each xor level a lane hands its partner
//     half of its values and adds the partner's half of the ones it keeps),
//     then the block's two warps in shared memory, then one float32 partial
//     a block; a second small pass adds the blocks' partials, and sums dA's
//     per-batch partials.  No float atomics: two launches give the same
//     bits.
// Every sum is the pairwise tree of the plain version's tree_sum
// (kernels/selective_scan/ref.py): over n, and over the Di channels (a
// block's 16, then the blocks', the odd one out going up a level as it
// is; channels past Di add exact zeros).  Every float operation but the
// exp is an intrinsic (__fmul_rn, __fadd_rn); the exp is expf, as the
// forward's.  State sizes N are 4, 8 and 16.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kLanes = 4;      // lanes a channel
constexpr int kChannels = 16;  // channels of one batch row a block
constexpr int kThreads = kChannels * kLanes;  // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;     // steps between two checkpoints

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
__device__ __forceinline__ void commit_and_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <int Lo, int Len, int N>
__device__ __forceinline__ float tree_sum(const float (&v)[N]) {
  if constexpr (Len == 1) {
    return v[Lo];
  } else {
    return __fadd_rn(tree_sum<Lo, Len / 2>(v),
                     tree_sum<Lo + Len / 2, Len / 2>(v));
  }
}

// Sums v over the lanes that differ from this one in the bits M, 2 M, ...,
// 16, in that order; see csrc/wkv6_bwd.cu.
template <int Cnt, int M, int K>
__device__ __forceinline__ void scatter_sum(float (&v)[K], int lane,
                                            int& off) {
  if constexpr (M < 32) {
    if constexpr (Cnt > 1) {
      constexpr int H = Cnt / 2;
      const bool hi = (lane & M) != 0;
#pragma unroll
      for (int q = 0; q < H; ++q) {
        const float give = hi ? v[q] : v[q + H];
        const float mine = hi ? v[q + H] : v[q];
        v[q] = __fadd_rn(mine, __shfl_xor_sync(0xffffffffu, give, M));
      }
      if (hi) off += H;
      scatter_sum<H, 2 * M>(v, lane, off);
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(0xffffffffu, v[0], M));
      scatter_sum<1, 2 * M>(v, lane, off);
    }
  }
}

__host__ __device__ constexpr int scattered(int cnt, int m) {
  return m >= 32 ? cnt : scattered(cnt > 1 ? cnt / 2 : 1, 2 * m);
}

template <int N>
struct __align__(16) Smem {
  static constexpr int V = N / kLanes;
  float x[kChunk][kChannels];
  float dt[kChunk][kChannels];
  float dy[kChunk][kChannels];
  float b[kChunk * N];
  float c[kChunk * N];
  float hist[kChunk][V][kThreads];      // the state before each step
  float bc[kChunk][kWarps][2 * N];      // each warp's dB, dC sums
};

template <int N, int W>
__device__ __forceinline__ void stage_chunk(Smem<N>& sm, const float* xi,
                                            const float* dt, const float* dy,
                                            const float* bm, const float* cm,
                                            size_t row0, int t0, int len,
                                            int d0, int di) {
  constexpr int kPerRow = kChannels / W;
  for (int e = threadIdx.x; e < len * kPerRow; e += kThreads) {
    const int j = e / kPerRow;
    const int c = e % kPerRow * W;
    if (d0 + c < di) {
      const size_t off = (row0 + t0 + j) * di + d0 + c;
      copy_async<W>(&sm.x[j][c], xi + off);
      copy_async<W>(&sm.dt[j][c], dt + off);
      copy_async<W>(&sm.dy[j][c], dy + off);
    }
  }
  const float* bsrc = bm + (row0 + t0) * N;
  const float* csrc = cm + (row0 + t0) * N;
  for (int i = threadIdx.x * W; i < len * N; i += kThreads * W) {
    copy_async<W>(&sm.b[i], bsrc + i);
    copy_async<W>(&sm.c[i], csrc + i);
  }
  commit_and_wait_all();
}

template <int N, int W>
__global__ void __launch_bounds__(kThreads)
    selective_scan_bwd_kernel(const float* __restrict__ xi,
                              const float* __restrict__ dt,
                              const float* __restrict__ bm,
                              const float* __restrict__ cm,
                              const float* __restrict__ a,
                              const float* __restrict__ ckpt,
                              const float* __restrict__ dy,
                              const float* __restrict__ dstate,
                              float* __restrict__ dxi,
                              float* __restrict__ ddt,
                              float* __restrict__ bc_part,
                              float* __restrict__ da_part,
                              float* __restrict__ dstate0, int s, int di) {
  constexpr int V = N / kLanes;  // state values a lane
  static_assert(V * kLanes == N, "N is 4, 8 or 16");
  __shared__ Smem<N> sm;
  const int b = blockIdx.y;
  const int batch = gridDim.y;
  const int d0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ch = tid / kLanes;
  const int sub = tid % kLanes;
  const int d = d0 + ch;
  const int n0 = sub * V;
  const bool on = d < di;
  const size_t row0 = static_cast<size_t>(b) * s;
  const size_t bsn = static_cast<size_t>(batch) * s * N;
  const int n_ck = s / kChunk + 1;
  const size_t lane_off = (static_cast<size_t>(b) * di + d) * N + n0;
  float av[V], gc[V], da_acc[V];
  // gc: the gradient of the state after the step being processed, carried
  // back through its decay: G_{t+1} e_{t+1} (dstate_T at the last step)
#pragma unroll
  for (int q = 0; q < V; ++q) {
    av[q] = on ? a[static_cast<size_t>(d) * N + n0 + q] : 0.f;
    gc[q] = on ? dstate[lane_off + q] : 0.f;
    da_acc[q] = 0.f;
  }
  const float* ck_row =
      ckpt + (static_cast<size_t>(b) * di + d) * n_ck * N + n0;

  for (int n = (s + kChunk - 1) / kChunk - 1; n >= 0; --n) {
    const int t0 = n * kChunk;
    const int len = min(kChunk, s - t0);
    __syncthreads();  // nobody reads the last chunk's stage or sums
    stage_chunk<N, W>(sm, xi, dt, dy, bm, cm, row0, t0, len, d0, di);
    float p[V];
#pragma unroll
    for (int q = 0; q < V; ++q) p[q] = on ? ck_row[n * N + q] : 0.f;
    __syncthreads();  // the chunk, staged by all, is in
    // the chunk's states, by the forward's operations (channels past di
    // compute on what the buffers hold and add nothing below)
    for (int tt = 0; tt < len; ++tt) {
      const float h = sm.dt[tt][ch];
      const float x = sm.x[tt][ch];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        sm.hist[tt][q][tid] = p[q];
        const float e = expf(__fmul_rn(h, av[q]));
        const float hbx = __fmul_rn(h, __fmul_rn(x, sm.b[tt * N + n0 + q]));
        p[q] = __fadd_rn(__fmul_rn(p[q], e), hbx);
      }
    }
    for (int tt = len - 1; tt >= 0; --tt) {
      const float h = sm.dt[tt][ch];
      const float x = sm.x[tt][ch];
      const float gy = sm.dy[tt][ch];
      float tx[V], tdt[V], vals[2 * V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float bq = sm.b[tt * N + n0 + q];
        const float cq = sm.c[tt * N + n0 + q];
        const float e = expf(__fmul_rn(h, av[q]));
        const float pe = __fmul_rn(sm.hist[tt][q][tid], e);
        const float xb = __fmul_rn(x, bq);
        const float st = __fadd_rn(pe, __fmul_rn(h, xb));  // s_t
        const float g = __fadd_rn(__fmul_rn(gy, cq), gc[q]);  // G_t
        const float gh = __fmul_rn(g, h);
        const float gpe = __fmul_rn(g, pe);
        tx[q] = __fmul_rn(gh, bq);
        tdt[q] = __fadd_rn(__fmul_rn(gpe, av[q]), __fmul_rn(g, xb));
        da_acc[q] = __fadd_rn(da_acc[q], __fmul_rn(gpe, h));
        vals[q] = on ? __fmul_rn(gh, x) : 0.f;       // dB
        vals[V + q] = on ? __fmul_rn(st, gy) : 0.f;  // dC
        gc[q] = __fmul_rn(g, e);
      }
      float sx = tree_sum<0, V>(tx), sdt = tree_sum<0, V>(tdt);
#pragma unroll
      for (int m = 1; m < kLanes; m <<= 1) {
        sx = __fadd_rn(sx, __shfl_xor_sync(0xffffffffu, sx, m));
        sdt = __fadd_rn(sdt, __shfl_xor_sync(0xffffffffu, sdt, m));
      }
      if (on && sub == 0) {
        const size_t o = (row0 + t0 + tt) * di + d;
        dxi[o] = sx;
        ddt[o] = sdt;
      }
      // dB and dC over the warp's channels
      int off = 0;
      scatter_sum<2 * V, kLanes>(vals, lane, off);
      constexpr int kKept = scattered(2 * V, kLanes);
#pragma unroll
      for (int q = 0; q < kKept; ++q) {
        const int idx = off + q;  // (quantity, value of this lane's range)
        sm.bc[tt][warp][idx / V * N + n0 + idx % V] = vals[q];
      }
    }
    __syncthreads();  // both warps' sums are in
    // the block's partial: its two warps' sums
    for (int e = tid; e < len * 2 * N; e += kThreads) {
      const int tt = e / (2 * N);
      const int m = e - tt * 2 * N;
      const int which = m / N;
      const float sum = __fadd_rn(sm.bc[tt][0][m], sm.bc[tt][1][m]);
      bc_part[(static_cast<size_t>(blockIdx.x) * 2 + which) * bsn +
              (row0 + t0 + tt) * N + m % N] = sum;
    }
  }
  if (on) {
#pragma unroll
    for (int q = 0; q < V; ++q) {
      dstate0[lane_off + q] = gc[q];
      da_part[lane_off + q] = da_acc[q];
    }
  }
}

// dB and dC: the blocks' partials in tree_sum's order (a stack of the
// pairwise tree's partial sums, the odd ones out going up as they are);
// dA: the batch rows' partials in order
__global__ void selective_scan_bwd_finish(const float* __restrict__ bc_part,
                                          const float* __restrict__ da_part,
                                          float* __restrict__ dbm,
                                          float* __restrict__ dcm,
                                          float* __restrict__ da, size_t bsn,
                                          int blocks, int batch, size_t dn) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e < 2 * bsn) {
    const int which = e >= bsn;
    const size_t i = e - which * bsn;
    float sums[32];
    int level[32];
    int top = 0;
    for (int blk = 0; blk < blocks; ++blk) {
      float x = bc_part[(static_cast<size_t>(blk) * 2 + which) * bsn + i];
      int l = 0;
      while (top > 0 && level[top - 1] == l) {
        x = __fadd_rn(sums[--top], x);
        ++l;
      }
      sums[top] = x;
      level[top++] = l;
    }
    float acc = sums[--top];
    while (top > 0) acc = __fadd_rn(sums[--top], acc);
    (which ? dcm : dbm)[i] = acc;
  }
  if (e < dn) {
    float acc = 0.f;
    for (int b = 0; b < batch; ++b) acc = __fadd_rn(acc, da_part[b * dn + e]);
    da[e] = acc;
  }
}

size_t workspace_floats(int batch, int s, int di, int n) {
  const size_t blocks = (di + kChannels - 1) / kChannels;
  return blocks * 2 * static_cast<size_t>(batch) * s * n +
         static_cast<size_t>(batch) * di * n;
}

template <int N>
int launch(const float* xi, const float* dt, const float* bm, const float* cm,
           const float* a, const float* ckpt, const float* dy,
           const float* dstate, float* dxi, float* ddt, float* dbm,
           float* dcm, float* da, float* dstate0, float* work, int batch,
           int s, int di, cudaStream_t stream) {
  const int blocks = (di + kChannels - 1) / kChannels;
  const size_t bsn = static_cast<size_t>(batch) * s * N;
  float* bc_part = work;
  float* da_part = bc_part + static_cast<size_t>(blocks) * 2 * bsn;
  const dim3 grid(blocks, batch);
  const bool aligned = di % 4 == 0 &&
                       ((reinterpret_cast<uintptr_t>(xi) |
                         reinterpret_cast<uintptr_t>(dt) |
                         reinterpret_cast<uintptr_t>(dy) |
                         reinterpret_cast<uintptr_t>(bm) |
                         reinterpret_cast<uintptr_t>(cm)) & 15) == 0;
  if (aligned)
    selective_scan_bwd_kernel<N, 4><<<grid, kThreads, 0, stream>>>(
        xi, dt, bm, cm, a, ckpt, dy, dstate, dxi, ddt, bc_part, da_part,
        dstate0, s, di);
  else
    selective_scan_bwd_kernel<N, 1><<<grid, kThreads, 0, stream>>>(
        xi, dt, bm, cm, a, ckpt, dy, dstate, dxi, ddt, bc_part, da_part,
        dstate0, s, di);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t dn = static_cast<size_t>(di) * N;
  const size_t n = 2 * bsn > dn ? 2 * bsn : dn;
  constexpr int kFinish = 256;
  selective_scan_bwd_finish<<<static_cast<unsigned>((n + kFinish - 1) /
                                                    kFinish),
                              kFinish, 0, stream>>>(
      bc_part, da_part, dbm, dcm, da, bsn, blocks, batch, dn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of the scratch `work` that selective_scan_bwd_launch needs.
extern "C" long long selective_scan_bwd_workspace(int batch, int s, int di,
                                                  int n) {
  return 4LL * static_cast<long long>(workspace_floats(batch, s, di, n));
}

// xi, dt, dy, dxi, ddt [batch, s, di]; bm, cm, dbm, dcm [batch, s, n]; a, da
// [di, n]; ckpt [batch, di, s / 16 + 1, n] as selective_scan_launch wrote
// it; dstate, dstate0 [batch, di, n]; work of selective_scan_bwd_workspace
// bytes; all float32, contiguous, on the device of `stream`.  n is 4, 8 or
// 16.  Two launches (the scan, then the sums over blocks and batch rows).
// Returns the cudaError_t of the launches (0: launched).
extern "C" int selective_scan_bwd_launch(
    const void* xi, const void* dt, const void* bm, const void* cm,
    const void* a, const void* ckpt, const void* dy, const void* dstate,
    void* dxi, void* ddt, void* dbm, void* dcm, void* da, void* dstate0,
    void* work, int batch, int s, int di, int n, void* stream) {
  if (batch <= 0 || s <= 0 || di <= 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const float*>(xi);
  const auto* h = static_cast<const float*>(dt);
  const auto* bp = static_cast<const float*>(bm);
  const auto* cp = static_cast<const float*>(cm);
  const auto* ap = static_cast<const float*>(a);
  const auto* kp = static_cast<const float*>(ckpt);
  const auto* gp = static_cast<const float*>(dy);
  const auto* sp = static_cast<const float*>(dstate);
  auto* o_x = static_cast<float*>(dxi);
  auto* o_h = static_cast<float*>(ddt);
  auto* o_b = static_cast<float*>(dbm);
  auto* o_c = static_cast<float*>(dcm);
  auto* o_a = static_cast<float*>(da);
  auto* o_s = static_cast<float*>(dstate0);
  auto* wk = static_cast<float*>(work);
  auto st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4:
      return launch<4>(x, h, bp, cp, ap, kp, gp, sp, o_x, o_h, o_b, o_c, o_a,
                       o_s, wk, batch, s, di, st);
    case 8:
      return launch<8>(x, h, bp, cp, ap, kp, gp, sp, o_x, o_h, o_b, o_c, o_a,
                       o_s, wk, batch, s, di, st);
    case 16:
      return launch<16>(x, h, bp, cp, ap, kp, gp, sp, o_x, o_h, o_b, o_c,
                        o_a, o_s, wk, batch, s, di, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* selective_scan_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
