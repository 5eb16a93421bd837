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
// What bounds it: on paper the bytes (7 arrays of B S Di read or written,
// and the checkpoints: 0.24 ms at a jamba Mamba layer, B 1 x 4,096) ahead
// of the float operations (24 a state value and step, an exp as one, at
// 67 TFLOP/s, a rate only FMAs reach: the bound's operations side assumes
// them; the recompute's stay unfused, as the forward's); in practice
// shared memory, the exp and latency, at 5 blocks (10 warps) an SM, the
// most that keeps every cluster of jamba's Di 8,192 resident at once (168
// registers a thread, 43 KB of shared memory a block).  The design keeps
// the forward's layout:
//   * a channel is held by kLanes = 4 neighbouring lanes, lane l owning the
//     N / 4 contiguous state values n in [l N/4, (l + 1) N/4); a block
//     holds kChannels = 16 channels of one batch row (64 threads), and
//     kCluster = 8 neighbouring blocks (128 channels) form a thread block
//     cluster; the grid is padded to whole clusters, a block past Di adding
//     exact zeros;
//   * the block walks the checkpoints' chunks of 16 steps from the last:
//     it stages the chunk's x, dt and dy of its channels and the rows of B
//     and C in shared memory (cp.async, 16 bytes a copy when every operand
//     is 16-byte aligned and Di a multiple of 4, else 4; the chunk before's
//     copies and checkpoint go in flight as soon as the walk has read the
//     stage), and recomputes the chunk's states from its checkpoint with
//     the forward's own operations (so their bits are the forward's) into
//     shared memory, with each step's e_t = expf(dt_t A) beside them: the
//     walk back reuses it, so every exp is computed once;
//   * the walk, unrolled at compile time (a ragged last chunk has its own
//     instance, each step guarded), carries one chain, G's (an FMA and a
//     product a value); each lane sums its own values of dx and ddt (FMAs)
//     into 2 x 16 registers, summed over the channel's 4 lanes once a chunk
//     by one reduce-scatter over (quantity, step) (24 shuffles where a sum
//     at a time took 64);
//   * dB and dC sum over the channels: a reduce-scatter over the warp's 8
//     channels a step, into shared memory; after the chunk the block adds
//     its two warps' sums and arrives at the cluster's barrier; while the
//     next chunk's states are recomputed the other blocks arrive, and then
//     each block sums its share of the chunk's (step, quantity, n) over
//     the cluster's 8 blocks, read from their shared memory
//     (map_shared_rank), and writes one float32 partial a cluster; a
//     second small launch adds the clusters' partials (64 at jamba's Di
//     8,192, where one a block made 512) and sums dA's per-batch partials.
//     No float atomics: two launches give the same bits.
// Sum orders (fixed, so deterministic; not the plain version's, which the
// tests hold the kernel to within 1e-4 of each gradient's largest value):
// dx and ddt a lane's values in order of n as an FMA chain (ddt's two
// terms a value in turn), then the channel's lanes in the pairwise tree;
// dB and dC over the 128 channels of a cluster in the pairwise tree
// (channels at xor 4, 8, 16 in a warp, then warps and blocks), then over
// the clusters in tree_sum's order (kernels/selective_scan/ref.py); dA over
// t from the last step as an FMA chain, then over b in order.  The
// gradient's own products contract to FMAs; the recomputed states use the
// forward's operations (__fmul_rn, __fadd_rn, expf).  State sizes N are 4,
// 8 and 16.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 4;      // lanes a channel
constexpr int kChannels = 16;  // channels of one batch row a block
constexpr int kThreads = kChannels * kLanes;  // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;     // steps between two checkpoints
constexpr int kCluster = 8;    // blocks a cluster (the portable most)

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
// the cluster's barrier in two halves; see csrc/wkv6_bwd.cu
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int Lo, int Len, int N>
__device__ __forceinline__ float tree_sum(const float (&v)[N]) {
  if constexpr (Len == 1) {
    return v[Lo];
  } else {
    return tree_sum<Lo, Len / 2>(v) + tree_sum<Lo + Len / 2, Len / 2>(v);
  }
}

// Sums v over the lanes that differ from this one in the bits M, 2 M, ...
// below End, in that order; see csrc/wkv6_bwd.cu.
template <int Cnt, int M, int End, int K>
__device__ __forceinline__ void scatter_sum(float (&v)[K], int lane,
                                            int& off) {
  if constexpr (M < End) {
    if constexpr (Cnt > 1) {
      static_assert(Cnt % 2 == 0, "halves at every level");
      constexpr int H = Cnt / 2;
      const bool hi = (lane & M) != 0;
#pragma unroll
      for (int q = 0; q < H; ++q) {
        const float give = hi ? v[q] : v[q + H];
        const float mine = hi ? v[q + H] : v[q];
        v[q] = mine + __shfl_xor_sync(0xffffffffu, give, M);
      }
      if (hi) off += H;
      scatter_sum<H, 2 * M, End>(v, lane, off);
    } else {
      v[0] = v[0] + __shfl_xor_sync(0xffffffffu, v[0], M);
      scatter_sum<1, 2 * M, End>(v, lane, off);
    }
  }
}

__host__ __device__ constexpr int scattered(int cnt, int m, int end) {
  return m >= end ? cnt : scattered(cnt > 1 ? cnt / 2 : 1, 2 * m, end);
}

template <int N>
struct __align__(16) Smem {
  static constexpr int V = N / kLanes;
  float x[kChunk][kChannels];
  float dt[kChunk][kChannels];
  float dy[kChunk][kChannels];
  float b[kChunk * N];
  float c[kChunk * N];
  float hist[kChunk][V][kThreads];   // the state before each step
  float ex[kChunk][V][kThreads];     // e_t = expf(dt_t A), the forward's
  // the block's dB, dC sums, by the chunk's parity (warp 0's sums, then
  // warp 1's added), which the cluster reads; warp 1's
  float bcb[2][kChunk][2 * N];
  float bcw[kChunk][2 * N];
};

// issues the copies of a chunk's operands into shared memory (one group)
template <int N, int W>
__device__ __forceinline__ void stage_issue(Smem<N>& sm, const float* xi,
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
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// what a thread knows of its place
struct Where {
  int tid, lane, warp, ch, sub, n0, d, rank, cluster_id;
  bool on;
  size_t row0, bsn;
  int di;
};

// a chunk: steps [t0, t0 + len); its sums in the buffers of parity buf
struct Span {
  int t0, len, buf;
};

// dB and dC of chunk sp: this block's share of (step, m), summed over the
// cluster's blocks (read from their shared memory); one partial a cluster
template <int N>
__device__ __forceinline__ void cluster_bc(Smem<N>& sm, const Where& at,
                                           const Span& sp,
                                           float* __restrict__ bc_part) {
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kShare = kChunk * 2 * N / kCluster;
  for (int e = at.tid; e < kShare; e += kThreads) {
    const int idx = at.rank * kShare + e;
    const int tt = idx / (2 * N);
    const int m = idx - tt * 2 * N;
    if (tt < sp.len) {
      float parts[kCluster];
#pragma unroll
      for (int rr = 0; rr < kCluster; ++rr)
        parts[rr] = *cluster.map_shared_rank(&sm.bcb[sp.buf][tt][m], rr);
      const int which = m / N;
      bc_part[(static_cast<size_t>(at.cluster_id) * 2 + which) * at.bsn +
              (at.row0 + sp.t0 + tt) * N + m % N] =
          tree_sum<0, kCluster>(parts);
    }
  }
}

// One chunk (len == kChunk when kFull): recompute its states and exps from
// p (the state before it), finish the chunk before it (prev: its dB and dC
// partials, once the cluster's blocks have summed theirs), walk it back
// (gc: G_{t+1} e_{t+1}), write dx and ddt, sum the block's dB and dC; and
// start the copies of the chunk before, and its checkpoint (into ck).
template <int N, int W, bool kFull>
__device__ __forceinline__ void chunk(
    Smem<N>& sm, const Where& at, const Span& sp, const Span& prev,
    float (&p)[N / kLanes], float (&gc)[N / kLanes],
    float (&da_acc)[N / kLanes], const float (&av)[N / kLanes],
    float (&ck)[N / kLanes], int n, int s, const float* __restrict__ xi,
    const float* __restrict__ dt, const float* __restrict__ dy,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ ck_row, float* __restrict__ dxi,
    float* __restrict__ ddt, float* __restrict__ bc_part) {
  constexpr int V = N / kLanes;
  const int len = sp.len;
  // the chunk's states and exps, by the forward's operations (channels
  // past di compute on what the buffers hold and add nothing below)
#pragma unroll
  for (int tt = 0; tt < kChunk; ++tt) {
    if (kFull || tt < len) {
      const float h = sm.dt[tt][at.ch];
      const float x = sm.x[tt][at.ch];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        sm.hist[tt][q][at.tid] = p[q];
        const float e = expf(__fmul_rn(h, av[q]));
        sm.ex[tt][q][at.tid] = e;
        const float hbx = __fmul_rn(h, __fmul_rn(x, sm.b[tt * N + at.n0 + q]));
        p[q] = __fadd_rn(__fmul_rn(p[q], e), hbx);
      }
    }
  }
  // the chunk before: every block's dB and dC sums are in
  if (prev.buf >= 0) {
    cluster_wait();
    cluster_bc(sm, at, prev, bc_part);
  }
  float xs[2 * kChunk];  // [quantity][step]: dx, ddt of the lane's values
  constexpr int kKept = scattered(2 * V, kLanes, 32);
  float yk[kChunk][kKept];  // each step's dB, dC sums over the warp
  int yoff = 0;
#pragma unroll
  for (int tt = kChunk - 1; tt >= 0; --tt) {
    if (kFull || tt < len) {
      const float h = sm.dt[tt][at.ch];
      const float x = sm.x[tt][at.ch];
      const float gy = sm.dy[tt][at.ch];
      float sx = 0.f, sdt = 0.f, vals[2 * V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const float bq = sm.b[tt * N + at.n0 + q];
        const float cq = sm.c[tt * N + at.n0 + q];
        const float e = sm.ex[tt][q][at.tid];
        const float pe = __fmul_rn(sm.hist[tt][q][at.tid], e);
        const float xb = __fmul_rn(x, bq);
        const float st = __fadd_rn(pe, __fmul_rn(h, xb));  // s_t
        const float g = fmaf(gy, cq, gc[q]);                // G_t
        const float gh = g * h;
        const float gpe = g * pe;
        sx = fmaf(gh, bq, sx);
        sdt = fmaf(gpe, av[q], sdt);
        sdt = fmaf(g, xb, sdt);
        da_acc[q] = fmaf(gpe, h, da_acc[q]);
        vals[q] = at.on ? gh * x : 0.f;       // dB
        vals[V + q] = at.on ? st * gy : 0.f;  // dC
        gc[q] = g * e;
      }
      xs[tt] = sx;
      xs[kChunk + tt] = sdt;
      // dB and dC over the warp's channels
      int off = 0;
      scatter_sum<2 * V, kLanes, 32>(vals, at.lane, off);
      yoff = off;
#pragma unroll
      for (int q = 0; q < kKept; ++q) yk[tt][q] = vals[q];
    } else {
      xs[tt] = 0.f;
      xs[kChunk + tt] = 0.f;
    }
  }
  {
    float* mine = at.warp == 0 ? &sm.bcb[sp.buf][0][0] : &sm.bcw[0][0];
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt)
      if (kFull || tt < len) {
#pragma unroll
        for (int q = 0; q < kKept; ++q) {
          const int idx = yoff + q;  // (quantity, value of the lane's range)
          mine[tt * 2 * N + idx / V * N + at.n0 + idx % V] = yk[tt][q];
        }
      }
  }
  __syncthreads();  // both warps' sums are in, the stage is read
  if (n > 0) {
    // the chunk before: its operands and checkpoint, in flight meanwhile
    const int t0 = (n - 1) * kChunk;
    stage_issue<N, W>(sm, xi, dt, dy, bm, cm, at.row0, t0, kChunk,
                      blockIdx.x * kChannels, at.di);
#pragma unroll
    for (int q = 0; q < V; ++q) ck[q] = at.on ? ck_row[(n - 1) * N + q] : 0.f;
  }
  // dx and ddt over the channel's lanes, all the chunk's steps at once
  {
    int off = 0;
    scatter_sum<2 * kChunk, 1, kLanes>(xs, at.lane, off);
    constexpr int kKeep = scattered(2 * kChunk, 1, kLanes);
#pragma unroll
    for (int q = 0; q < kKeep; ++q) {
      const int f = off + q;
      const int which = f / kChunk;
      const int tt = f - which * kChunk;
      if (at.on && (kFull || tt < len)) {
        const size_t o = (at.row0 + sp.t0 + tt) * at.di + at.d;
        (which == 0 ? dxi : ddt)[o] = xs[q];
      }
    }
  }
  // the block's dB and dC: warp 0's sums plus warp 1's
  static_assert(kWarps == 2, "two warps a block");
  for (int e = at.tid; e < kChunk * 2 * N; e += kThreads) {
    const int tt = e / (2 * N);
    const int m = e - tt * 2 * N;
    if (kFull || tt < len) sm.bcb[sp.buf][tt][m] += sm.bcw[tt][m];
  }
  cluster_arrive();  // this block's sums are in, and it has read the last
}

template <int N, int W>
__global__ void __launch_bounds__(kThreads, 6)
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
  static_assert(kChunk * 2 * N % kCluster == 0, "a share a block");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(smem_raw);
  Where at;
  const int b = blockIdx.y;
  const int batch = gridDim.y;
  const int d0 = blockIdx.x * kChannels;
  at.tid = threadIdx.x;
  at.lane = at.tid % 32;
  at.warp = at.tid / 32;
  at.ch = at.tid / kLanes;
  at.sub = at.tid % kLanes;
  at.d = d0 + at.ch;
  at.n0 = at.sub * V;
  at.on = at.d < di;
  at.di = di;
  at.rank = static_cast<int>(cg::this_cluster().block_rank());
  at.cluster_id = blockIdx.x / kCluster;
  at.row0 = static_cast<size_t>(b) * s;
  at.bsn = static_cast<size_t>(batch) * s * N;
  const int n_ck = s / kChunk + 1;
  const size_t lane_off = (static_cast<size_t>(b) * di + at.d) * N + at.n0;
  float av[V], gc[V], da_acc[V];
  // gc: the gradient of the state after the step being processed, carried
  // back through its decay: G_{t+1} e_{t+1} (dstate_T at the last step)
#pragma unroll
  for (int q = 0; q < V; ++q) {
    av[q] = at.on ? a[static_cast<size_t>(at.d) * N + at.n0 + q] : 0.f;
    gc[q] = at.on ? dstate[lane_off + q] : 0.f;
    da_acc[q] = 0.f;
  }
  const float* ck_row =
      ckpt + (static_cast<size_t>(b) * di + at.d) * n_ck * N + at.n0;
  // the last chunk's operands and checkpoint
  const int n_last = (s + kChunk - 1) / kChunk - 1;
  float ck[V];
  stage_issue<N, W>(sm, xi, dt, dy, bm, cm, at.row0, n_last * kChunk,
                    s - n_last * kChunk, d0, di);
#pragma unroll
  for (int q = 0; q < V; ++q) ck[q] = at.on ? ck_row[n_last * N + q] : 0.f;
  Span prev = {0, 0, -1};
  int parity = 0;

  for (int n = n_last; n >= 0; --n) {
    const Span sp = {n * kChunk, min(kChunk, s - n * kChunk), parity};
    stage_wait();
    __syncthreads();  // the chunk, staged by all, is in
    float p[V];
#pragma unroll
    for (int q = 0; q < V; ++q) p[q] = ck[q];
    if (sp.len == kChunk)
      chunk<N, W, true>(sm, at, sp, prev, p, gc, da_acc, av, ck, n, s, xi,
                        dt, dy, bm, cm, ck_row, dxi, ddt, bc_part);
    else
      chunk<N, W, false>(sm, at, sp, prev, p, gc, da_acc, av, ck, n, s, xi,
                         dt, dy, bm, cm, ck_row, dxi, ddt, bc_part);
    prev = sp;
    parity ^= 1;
  }
  cluster_wait();
  cluster_bc(sm, at, prev, bc_part);
  cluster_arrive();
  cluster_wait();  // no block leaves while another reads its shared memory
  if (at.on) {
#pragma unroll
    for (int q = 0; q < V; ++q) {
      dstate0[lane_off + q] = gc[q];
      da_part[lane_off + q] = da_acc[q];
    }
  }
}

// dB and dC: the clusters' partials in tree_sum's order (a stack of the
// pairwise tree's partial sums, the odd ones out going up as they are);
// dA: the batch rows' partials in order
__global__ void selective_scan_bwd_finish(const float* __restrict__ bc_part,
                                          const float* __restrict__ da_part,
                                          float* __restrict__ dbm,
                                          float* __restrict__ dcm,
                                          float* __restrict__ da, size_t bsn,
                                          int clusters, int batch, size_t dn) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e < 2 * bsn) {
    const int which = e >= bsn;
    const size_t i = e - which * bsn;
    float sums[32];
    int level[32];
    int top = 0;
    for (int cl = 0; cl < clusters; ++cl) {
      float x = bc_part[(static_cast<size_t>(cl) * 2 + which) * bsn + i];
      int l = 0;
      while (top > 0 && level[top - 1] == l) {
        x = sums[--top] + x;
        ++l;
      }
      sums[top] = x;
      level[top++] = l;
    }
    float acc = sums[--top];
    while (top > 0) acc = sums[--top] + acc;
    (which ? dcm : dbm)[i] = acc;
  }
  if (e < dn) {
    float acc = 0.f;
    for (int b = 0; b < batch; ++b) acc += da_part[b * dn + e];
    da[e] = acc;
  }
}

int clusters_of(int di) {
  const int blocks = (di + kChannels - 1) / kChannels;
  return (blocks + kCluster - 1) / kCluster;
}

size_t workspace_floats(int batch, int s, int di, int n) {
  return static_cast<size_t>(clusters_of(di)) * 2 * batch * s * n +
         static_cast<size_t>(batch) * di * n;
}

template <int N, int W>
cudaError_t launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                          int batch, int di, cudaStream_t stream) {
  auto kernel = &selective_scan_bwd_kernel<N, W>;
  const int smem = static_cast<int>(sizeof(Smem<N>));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters_of(di) * kCluster),
                     static_cast<unsigned>(batch));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <int N>
int launch(const float* xi, const float* dt, const float* bm, const float* cm,
           const float* a, const float* ckpt, const float* dy,
           const float* dstate, float* dxi, float* ddt, float* dbm,
           float* dcm, float* da, float* dstate0, float* work, int batch,
           int s, int di, cudaStream_t stream) {
  const int clusters = clusters_of(di);
  const size_t bsn = static_cast<size_t>(batch) * s * N;
  float* bc_part = work;
  float* da_part = bc_part + static_cast<size_t>(clusters) * 2 * bsn;
  const bool aligned = di % 4 == 0 &&
                       ((reinterpret_cast<uintptr_t>(xi) |
                         reinterpret_cast<uintptr_t>(dt) |
                         reinterpret_cast<uintptr_t>(dy) |
                         reinterpret_cast<uintptr_t>(bm) |
                         reinterpret_cast<uintptr_t>(cm)) & 15) == 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err;
  if (aligned) {
    err = launch_config<N, 4>(cfg, attr, batch, di, stream);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, selective_scan_bwd_kernel<N, 4>, xi, dt,
                               bm, cm, a, ckpt, dy, dstate, dxi, ddt, bc_part,
                               da_part, dstate0, s, di);
  } else {
    err = launch_config<N, 1>(cfg, attr, batch, di, stream);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, selective_scan_bwd_kernel<N, 1>, xi, dt,
                               bm, cm, a, ckpt, dy, dstate, dxi, ddt, bc_part,
                               da_part, dstate0, s, di);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t dn = static_cast<size_t>(di) * N;
  const size_t n = 2 * bsn > dn ? 2 * bsn : dn;
  constexpr int kFinish = 256;
  selective_scan_bwd_finish<<<static_cast<unsigned>((n + kFinish - 1) /
                                                    kFinish),
                              kFinish, 0, stream>>>(
      bc_part, da_part, dbm, dcm, da, bsn, clusters, batch, dn);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int plan_of(int batch, int di, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = launch_config<N, 4>(cfg, attr, batch, di, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, selective_scan_bwd_kernel<N, 4>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0, clusters = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, selective_scan_bwd_kernel<N, 4>, kThreads, sizeof(Smem<N>));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveClusters(
      &clusters, selective_scan_bwd_kernel<N, 4>, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[] = {N / kLanes, kChunk, kThreads, kCluster,
                      static_cast<int>(sizeof(Smem<N>)), fa.numRegs,
                      static_cast<int>(fa.localSizeBytes), blocks, clusters,
                      clusters_of(di) * kCluster * batch};
  for (int x = 0; x < 10; ++x) out[x] = vals[x];
  return 0;
}

}  // namespace

// Bytes of the scratch `work` that selective_scan_bwd_launch needs: dB and
// dC's partials, one a cluster of 128 channels, and dA's per-batch ones.
extern "C" long long selective_scan_bwd_workspace(int batch, int s, int di,
                                                  int n) {
  return 4LL * static_cast<long long>(workspace_floats(batch, s, di, n));
}

// The launch selective_scan_bwd_launch makes at this shape, into out[10]:
// values a lane, steps a chunk, threads a block, blocks a cluster, shared
// bytes a block, registers a thread, local (spill) bytes a thread, blocks
// resident an SM, clusters resident on the card, blocks launched.  Returns
// a cudaError_t (0: filled).
extern "C" int selective_scan_bwd_plan(int batch, int s, int di, int n,
                                       int* out) {
  (void)s;
  switch (n) {
    case 4:
      return plan_of<4>(batch, di, out);
    case 8:
      return plan_of<8>(batch, di, out);
    case 16:
      return plan_of<16>(batch, di, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// xi, dt, dy, dxi, ddt [batch, s, di]; bm, cm, dbm, dcm [batch, s, n]; a, da
// [di, n]; ckpt [batch, di, s / 16 + 1, n] as selective_scan_launch wrote
// it; dstate, dstate0 [batch, di, n]; work of selective_scan_bwd_workspace
// bytes; all float32, contiguous, on the device of `stream`.  n is 4, 8 or
// 16.  Two launches (the scan with its cluster sums, then the sums over
// clusters and batch rows).  Returns the cudaError_t of the launches (0:
// launched).
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
