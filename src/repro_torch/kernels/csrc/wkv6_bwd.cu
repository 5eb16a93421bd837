// Backward of RWKV-6's WKV recurrence (csrc/wkv6.cu), per batch row and
// head, from the forward's state checkpoints.
//
// Replaces no TPU kernel: the reference trains through XLA's autodiff of
// the `lax.scan` of `step` (src/repro/models/rwkv6.py:106, the step at :95).
// The forward, with P_t the state before step t (P_0 the initial state):
//   o_t[j]     = sum over i of r_t[i] (P_t[i][j] + u[i] k_t[i] v_t[j])
//   P_{t+1}    = diag(w_t) P_t + k_t^T v_t
// With G_t the gradient of P_{t+1} (G_{S-1} = dstate_T, the final state's),
// a_t = v_t . do_t and b_t = sum over i of u[i] r_t[i] k_t[i], for t from
// the last step down:
//   dv_t[j] = sum over i of k_t[i] G_t[i][j]  +  do_t[j] b_t
//   dk_t[i] = sum over j of v_t[j] G_t[i][j]  +  u[i] r_t[i] a_t
//   dr_t[i] = sum over j of do_t[j] P_t[i][j] +  u[i] k_t[i] a_t
//   dw_t[i] = sum over j of G_t[i][j] P_t[i][j]
//   du[i]  += r_t[i] k_t[i] a_t                 (over t, then over b)
//   G_{t-1} = diag(w_t) G_t + r_t^T do_t,   dstate_0 = G_{-1}.
// Operands, all float32 and contiguous:
//   r, k, v, w, do [B, S, H, hd]   read (do: the gradient of o)
//   u [H, hd]                      read
//   ckpt [B, H, S / 16 + 1, hd, hd] read: the forward's checkpoints
//   dstate [B, H, hd, hd]          read: the gradient of the final state
//   dr, dk, dv, dw [B, S, H, hd]   written
//   du [H, hd], dstate0 [B, H, hd, hd] written
//   work                           scratch (wkv6_bwd_workspace bytes)
//
// What bounds it: on paper the bytes (9 arrays of B S H hd read or
// written, and the checkpoints: 0.52 ms at rwkv6-1.6b's B 4 x 4,096)
// ahead of the float operations (14 a state value and step at 67 TFLOP/s,
// a rate only FMAs reach: the bound's operations side assumes them; the
// recompute's 3 of the 14 stay unfused, as the forward's).  In practice
// shared memory's bandwidth and latency: a state value and step reads v_t
// and do_t, the steps are a dependent chain, backwards, and most of the
// work sums over i or over j.  The design:
//   * layout: a ROW i of the head's state is held by kLanes = hd / 8
//     neighbouring lanes of one warp, lane l owning G[i][j] for the 8
//     contiguous j in [8 l, 8 l + 8), in registers; a thread holds kRpt
//     rows (so v_t and do_t, read once, serve them all), a block kRows
//     rows, and the hd / kRows blocks of a head form one thread block
//     cluster;
//   * plans, chosen at launch: with many heads (B H hd / 16 blocks past
//     two an SM, as rwkv6-1.6b's training batch of 4) two rows a thread,
//     32 a block (4 warps), clusters of 2, sub-chunks of 4 steps: 80 KB of
//     shared memory and some 234 registers a thread, 2 blocks an SM, every
//     cluster resident at once (clusters of 4 left 8 of 132 SMs unused and
//     4 clusters to a second wave); with few (batch 1) one row a thread, 16
//     a block, clusters of 4, sub-chunks of 8; hd 16 (the smoke config) is
//     one block of one warp a head, sub-chunks of 4;
//   * the block walks the checkpoints' chunks of 16 steps from the last;
//     the operands of the chunk before, v and do of the whole head and r,
//     k, w of the block's rows, and its checkpoint are in flight while a
//     chunk is worked (cp.async into the other of two shared buffers, 16
//     bytes a copy when every operand is 16-byte aligned, else 4);
//   * the states: from the checkpoint the block recomputes the chunk's
//     states with the forward's own operations (so their bits are the
//     forward's), keeping the first state of each sub-chunk but the last in
//     shared memory and every state of the last sub-chunk in registers;
//     each earlier sub-chunk's are recomputed into registers from its first
//     when its turn comes (24 steps of recompute a 16-step chunk).  No
//     state goes through shared memory step by step;
//   * the walk, each sub-chunk unrolled at compile time (a ragged last
//     chunk has its own instance, each step guarded), carries one chain,
//     G's update (an FMA and a product a value); a lane sums its own values
//     of dk, dr and dw (FMA chains) into registers, which are summed over
//     the row's lanes once a sub-chunk by one reduce-scatter over
//     (quantity, row, step): at each xor level a lane hands its partner
//     half of the values it holds and adds the partner's half of the ones
//     it keeps (24 values over 8 lanes: 21 shuffles, where a sum at a time
//     took 72);
//   * dv: a thread's rows' products k_i G[i][j] (an FMA), then a
//     reduce-scatter over the warp's row groups a step, into shared
//     memory; after the chunk the block adds its warps' sums and do_t[j]
//     times its rows' part of b_t, and arrives at the cluster's barrier;
//     while the next chunk's states are recomputed the other blocks
//     arrive, and then each block sums its share of the chunk's (step, j)
//     over the cluster's blocks, read from their shared memory
//     (map_shared_rank), and writes dv.  No dv partial reaches device
//     memory;
//   * du's per-batch partials [B, H, hd] are summed over B by a second,
//     small launch.  No float atomics: two launches give the same bits.
// Sum orders (fixed, so deterministic; not the plain version's, which the
// tests hold the kernel to within 1e-4 of each gradient's largest value):
// dk, dr, dw and a_t: a lane's 8 values in order of j as an FMA chain, then
// the row's lanes in the pairwise tree (xor 1, 2, ...); dv: a thread's rows
// in order, the block's row groups in the pairwise tree (xor kLanes, 2
// kLanes, ... in a warp, then warps), plus do_t[j] times the block's part
// of b_t (its rows in order, an FMA chain), then the cluster's blocks in
// the pairwise tree; du over t from the last step, then over b in order.
// The head size is a template parameter: 64 (rwkv6-1.6b) and 16 (its smoke
// config); the launcher refuses any other.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 16;  // steps between two checkpoints (the forward's)

template <int HD, int VALS, int RPT, int ROWS, int SUB, int MIN_BLOCKS>
struct Plan {
  static_assert((HD & (HD - 1)) == 0 && HD % ROWS == 0 && HD % VALS == 0,
                "the head size is a power of two, rows a block divide it");
  static constexpr int kHD = HD;
  static constexpr int kVals = VALS;               // values a lane, a row
  static constexpr int kRpt = RPT;                 // rows a thread
  static constexpr int kRows = ROWS;               // rows of a head a block
  static constexpr int kSub = SUB;                 // steps a sub-chunk
  static constexpr int kNSub = kChunk / SUB;       // sub-chunks a chunk
  static constexpr int kMinBlocks = MIN_BLOCKS;    // resident an SM
  static constexpr int kLanes = HD / VALS;         // lanes a row
  static constexpr int kGroups = ROWS / RPT;       // a block's row groups
  static constexpr int kThreads = kGroups * kLanes;  // threads a block
  static constexpr int kWarps = kThreads / 32;     // warps a block
  static constexpr int kSplit = HD / kRows;        // blocks a head: a cluster
  static constexpr int kRow = HD + HD / 32 * 4;    // a padded shared row
  static constexpr int kHeld = RPT * VALS;         // state values a thread
  // dk, dr, dw of each row a step of a sub-chunk, padded with zeros to
  // halve at every lane level
  static constexpr int kSums =
      (3 * RPT * SUB + kLanes - 1) / kLanes * kLanes;
  static constexpr int kOut = kChunk * HD / kSplit;  // dv sums a block forms
  static_assert(kThreads % 32 == 0 && 32 % kLanes == 0,
                "whole warps, and a row's lanes in one warp");
  static_assert(kChunk % SUB == 0 && VALS % 4 == 0, "sub-chunks, float4s");
  static_assert(kChunk % kGroups == 0 || kGroups % kChunk == 0,
                "a_t: row groups share the chunk's steps evenly");
};

// many heads (B H hd / 16 blocks past two an SM: rwkv6-1.6b's training
// batch), few heads, and hd 16
using Many64 = Plan<64, 8, 2, 32, 4, 2>;
using Few64 = Plan<64, 8, 1, 16, 8, 2>;
using Head16 = Plan<16, 8, 1, 16, 4, 1>;

// where entry i of a row sits in shared memory: 4 floats of padding after
// every 32, so that lanes 0 and 4 of a row start on other banks
__device__ __forceinline__ int padded(int i) { return i + (i >> 5) * 4; }

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

// the cluster's barrier in two halves: arrive (release this block's shared
// writes and reads), then wait (acquire the other blocks')
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the pairwise tree over v[Lo, Lo + Len)
template <int Lo, int Len, int N>
__device__ __forceinline__ float tree_sum(const float (&v)[N]) {
  if constexpr (Len == 1) {
    return v[Lo];
  } else {
    return tree_sum<Lo, Len / 2>(v) + tree_sum<Lo + Len / 2, Len / 2>(v);
  }
}

template <int N>
__device__ __forceinline__ void load_vals(float (&dst)[N], const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 x = s4[q];
    dst[4 * q] = x.x;
    dst[4 * q + 1] = x.y;
    dst[4 * q + 2] = x.z;
    dst[4 * q + 3] = x.w;
  }
}

// Sums v over the lanes that differ from this one in the bits M, 2 M, ...
// below End of the lane index, in that order (the pairwise tree over
// them).  While this lane holds more than one value (Cnt), each level
// hands the partner half of them and adds the partner's half of the ones
// kept, which move to v[0, Cnt / 2); `off` grows by the index of the first
// one kept.  Once one value is left, the levels add it whole (both lanes
// then hold the sum).
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

// values a lane holds after scatter_sum from Cnt values at bit M to End
__host__ __device__ constexpr int scattered(int cnt, int m, int end) {
  return m >= end ? cnt : scattered(cnt > 1 ? cnt / 2 : 1, 2 * m, end);
}

// a chunk's operands in shared memory
template <class P>
struct __align__(16) Stage {
  float v[kChunk][P::kRow];      // v of the whole head
  float dout[kChunk][P::kRow];   // and its do
  float r[kChunk][P::kRows];     // r, k, w of the block's rows
  float k[kChunk][P::kRows];
  float w[kChunk][P::kRows];
};

template <class P>
struct __align__(16) Smem {
  Stage<P> st[2];                // by the chunk's parity: one in flight
  float u[P::kRows];
  float a[kChunk];               // v_t . do_t
  float bpart[kChunk];           // the block's rows' u r_t k_t
  // the state before each sub-chunk but the last, a thread's values
  float4 mid[P::kNSub > 1 ? P::kNSub - 1 : 1][P::kHeld / 4][P::kThreads];
  // each warp's dv sums over its row groups, a step of the chunk
  float dvp[kChunk][P::kWarps][P::kHD];
  // the block's, which the cluster reads, by the chunk's parity
  float dvb[2][kChunk][P::kHD];
};

// issues the copies of a chunk's operands into shared memory (one group)
template <class P, int W>
__device__ __forceinline__ void stage_issue(Stage<P>& st, const float* r,
                                            const float* k, const float* w,
                                            const float* v, const float* dout,
                                            size_t first, size_t step,
                                            int len, int i0) {
  constexpr int HD = P::kHD;
  for (int e = threadIdx.x; e < len * (HD / W); e += P::kThreads) {
    const int tt = e / (HD / W);
    const int j = e % (HD / W) * W;
    const size_t off = first + tt * step + j;
    copy_async<W>(&st.v[tt][padded(j)], v + off);
    copy_async<W>(&st.dout[tt][padded(j)], dout + off);
  }
  for (int e = threadIdx.x; e < len * (P::kRows / W); e += P::kThreads) {
    const int tt = e / (P::kRows / W);
    const int ii = e % (P::kRows / W) * W;
    const size_t off = first + tt * step + i0 + ii;
    copy_async<W>(&st.r[tt][ii], r + off);
    copy_async<W>(&st.k[tt][ii], k + off);
    copy_async<W>(&st.w[tt][ii], w + off);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits for this thread's copies
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a step's operands of a thread, for the forward's step
template <class P>
struct StepIn {
  float v[P::kVals];
  float w[P::kRpt], k[P::kRpt];
};
template <class P>
__device__ __forceinline__ void step_in(StepIn<P>& in, const Stage<P>& st,
                                        int tt, int row0, int pj0) {
  load_vals(in.v, &st.v[tt][pj0]);
#pragma unroll
  for (int e = 0; e < P::kRpt; ++e) {
    in.w[e] = st.w[tt][row0 + e];
    in.k[e] = st.k[tt][row0 + e];
  }
}
// one step of the forward on a thread's values: P <- P w_i + k_i v, row
// by row, by the forward kernel's own operations
template <class P>
__device__ __forceinline__ void forward_step(float (&p)[P::kHeld],
                                             const StepIn<P>& in) {
#pragma unroll
  for (int e = 0; e < P::kRpt; ++e) {
#pragma unroll
    for (int q = 0; q < P::kVals; ++q) {
      float& x = p[e * P::kVals + q];
      x = __fadd_rn(__fmul_rn(x, in.w[e]), __fmul_rn(in.k[e], in.v[q]));
    }
  }
}

// what a thread knows of its place
struct Where {
  int tid, lane, warp, row0, sub, split, i0, pj0;
  size_t base, step;
};

// a chunk: steps [t0, t0 + len); its dv sums in the buffer of parity buf
struct Span {
  int t0, len, buf;
};

// dv of chunk sp: this block's share of (step, j), the cluster's blocks'
// sums (read from their shared memory) in the pairwise tree
template <class P>
__device__ __forceinline__ void cluster_dv(Smem<P>& sm, const Where& at,
                                           const Span& sp,
                                           float* __restrict__ dv) {
  constexpr int HD = P::kHD;
  cg::cluster_group cluster = cg::this_cluster();
  for (int e = at.tid; e < P::kOut; e += P::kThreads) {
    const int idx = at.split * P::kOut + e;
    const int tt = idx / HD;
    const int j = idx - tt * HD;
    if (tt < sp.len) {
      float parts[P::kSplit];
#pragma unroll
      for (int rr = 0; rr < P::kSplit; ++rr)
        parts[rr] = *cluster.map_shared_rank(&sm.dvb[sp.buf][tt][j], rr);
      dv[at.base + static_cast<size_t>(sp.t0 + tt) * at.step + j] =
          tree_sum<0, P::kSplit>(parts);
    }
  }
}

template <class P>
__device__ __forceinline__ void copy_held(float (&dst)[P::kHeld],
                                          const float (&src)[P::kHeld]) {
#pragma unroll
  for (int q = 0; q < P::kHeld; ++q) dst[q] = src[q];
}

// Walks steps [s0, s0 + cnt) of the chunk at t0 back (cnt == kSub when
// kFull), from their states in hist (registers) and G in g: writes dk, dr,
// dw, and each warp's dv sums over its row groups into dvp.
template <class P, bool kFull>
__device__ __forceinline__ void walk(
    Smem<P>& sm, const Stage<P>& st, const Where& at,
    const float (&hist)[P::kSub][P::kHeld], float (&g)[P::kHeld],
    float (&du_acc)[P::kRpt], int t0, int s0, int cnt,
    float* __restrict__ dr, float* __restrict__ dk, float* __restrict__ dw) {
  constexpr int VALS = P::kVals, SUB = P::kSub, RPT = P::kRpt;
  // [quantity][row][step]: dk, dr, dw of each row's values of the lane
  float xs[P::kSums];
  constexpr int kKept = scattered(VALS, P::kLanes, 32);
  float yk[SUB][kKept];  // each step's dv sums over the warp's row groups
  int yoff = 0;
#pragma unroll
  for (int f = 3 * RPT * SUB; f < P::kSums; ++f) xs[f] = 0.f;
#pragma unroll
  for (int e = SUB - 1; e >= 0; --e) {
    if (kFull || e < cnt) {
      const int ts = s0 + e;
      const float a_t = sm.a[ts];
      float vv[VALS], dd[VALS], y[VALS];
      load_vals(vv, &st.v[ts][at.pj0]);
      load_vals(dd, &st.dout[ts][at.pj0]);
#pragma unroll
      for (int ee = 0; ee < RPT; ++ee) {
        const float ri = st.r[ts][at.row0 + ee];
        const float ki = st.k[ts][at.row0 + ee];
        const float wi = st.w[ts][at.row0 + ee];
        float sk = 0.f, sr = 0.f, sw = 0.f;
#pragma unroll
        for (int q = 0; q < VALS; ++q) {
          float& gq = g[ee * VALS + q];
          const float pq = hist[e][ee * VALS + q];
          sk = fmaf(vv[q], gq, sk);
          sr = fmaf(dd[q], pq, sr);
          sw = fmaf(gq, pq, sw);
          y[q] = ee == 0 ? ki * gq : fmaf(ki, gq, y[q]);
          gq = fmaf(wi, gq, ri * dd[q]);
        }
        xs[(0 * RPT + ee) * SUB + e] = sk;
        xs[(1 * RPT + ee) * SUB + e] = sr;
        xs[(2 * RPT + ee) * SUB + e] = sw;
        du_acc[ee] = fmaf(ri * ki, a_t, du_acc[ee]);
      }
      // dv over the warp's row groups
      int off = 0;
      scatter_sum<VALS, P::kLanes, 32>(y, at.lane, off);
      yoff = off;
#pragma unroll
      for (int q = 0; q < kKept; ++q) yk[e][q] = y[q];
    } else {
#pragma unroll
      for (int f = 0; f < 3 * RPT; ++f) xs[f * SUB + e] = 0.f;
    }
  }
#pragma unroll
  for (int e = 0; e < SUB; ++e)
    if (kFull || e < cnt) {
#pragma unroll
      for (int q = 0; q < kKept; ++q)
        sm.dvp[s0 + e][at.warp][at.sub * VALS + yoff + q] = yk[e][q];
    }
  // dk, dr, dw over the row's lanes, all the sub-chunk's steps at once
  int off = 0;
  scatter_sum<P::kSums, 1, P::kLanes>(xs, at.lane, off);
  constexpr int kKeep = scattered(P::kSums, 1, P::kLanes);
#pragma unroll
  for (int q = 0; q < kKeep; ++q) {
    const int f = off + q;
    const int which = f / (RPT * SUB);
    const int ee = f / SUB - which * RPT;
    const int e = f % SUB;
    if (which < 3 && (kFull || e < cnt)) {
      const int ts = s0 + e;
      const int row = at.row0 + ee;
      const size_t o = at.base + static_cast<size_t>(t0 + ts) * at.step +
                       at.i0 + row;
      const float x = which == 0 ? st.r[ts][row] : st.k[ts][row];
      const float val = which == 2 ? xs[q]
                                   : fmaf(sm.u[row] * x, sm.a[ts], xs[q]);
      (which == 0 ? dk : which == 1 ? dr : dw)[o] = val;
    }
  }
}

// One chunk (len == kChunk when kFull) staged in st: its states from p
// (the checkpoint before it), the first of each sub-chunk but the last
// kept in shared memory and the last sub-chunk's in registers; finish the
// chunk before it (prev: its dv, once the cluster's blocks have summed
// theirs); walk the sub-chunks back, each but the last recomputed from its
// first state; sum the block's dv.
template <class P, bool kFull>
__device__ __forceinline__ void chunk(
    Smem<P>& sm, const Stage<P>& st, const Where& at, const Span& sp,
    const Span& prev, float (&p)[P::kHeld], float (&g)[P::kHeld],
    float (&du_acc)[P::kRpt], float* __restrict__ dr,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dw) {
  constexpr int SUB = P::kSub, NSUB = P::kNSub, HELD = P::kHeld;
  constexpr int HD = P::kHD;
  const int len = kFull ? kChunk : sp.len;
  const int top = (len - 1) / SUB;  // the last sub-chunk
  float hist[SUB][HELD];
  // the states, by the forward's operations, each step's operands read one
  // step ahead
  StepIn<P> in;
  step_in(in, st, 0, at.row0, at.pj0);
#pragma unroll
  for (int hh = 0; hh < NSUB; ++hh) {
#pragma unroll
    for (int e = 0; e < SUB; ++e) {
      const int tt = hh * SUB + e;
      if (kFull || tt < len) {
        if (hh < top) {
          if (e == 0) {
#pragma unroll
            for (int q = 0; q < HELD / 4; ++q)
              sm.mid[hh][q][at.tid] = make_float4(p[4 * q], p[4 * q + 1],
                                                  p[4 * q + 2], p[4 * q + 3]);
          }
        } else {
          copy_held<P>(hist[e], p);
        }
        if (tt + 1 < len) {
          const StepIn<P> cur = in;
          step_in(in, st, tt + 1, at.row0, at.pj0);
          forward_step(p, cur);
        }
      }
    }
  }
  // the chunk before: every block's dv sums are in
  if (prev.buf >= 0) {
    cluster_wait();
    cluster_dv(sm, at, prev, dv);
  }
  walk<P, kFull>(sm, st, at, hist, g, du_acc, sp.t0, top * SUB,
                 len - top * SUB, dr, dk, dw);
  for (int hh = top - 1; hh >= 0; --hh) {
#pragma unroll
    for (int q = 0; q < HELD / 4; ++q) {
      const float4 x = sm.mid[hh][q][at.tid];
      p[4 * q] = x.x;
      p[4 * q + 1] = x.y;
      p[4 * q + 2] = x.z;
      p[4 * q + 3] = x.w;
    }
    step_in(in, st, hh * SUB, at.row0, at.pj0);
#pragma unroll
    for (int e = 0; e < SUB; ++e) {
      copy_held<P>(hist[e], p);
      if (e + 1 < SUB) {
        const StepIn<P> cur = in;
        step_in(in, st, hh * SUB + e + 1, at.row0, at.pj0);
        forward_step(p, cur);
      }
    }
    walk<P, true>(sm, st, at, hist, g, du_acc, sp.t0, hh * SUB, SUB, dr, dk,
                  dw);
  }
  if (at.tid < len) {
    // b_t's part over the block's rows, for step tid of the chunk
    float acc = 0.f;
#pragma unroll
    for (int rr = 0; rr < P::kRows; ++rr)
      acc = fmaf(sm.u[rr] * st.r[at.tid][rr], st.k[at.tid][rr], acc);
    sm.bpart[at.tid] = acc;
  }
  __syncthreads();  // every warp's dv sums are in, and b_t's parts
  // the block's dv: its warps' sums in the pairwise tree, plus do_t[j]
  // times its rows' part of b_t
  for (int e = at.tid; e < kChunk * HD; e += P::kThreads) {
    const int tt = e / HD;
    const int j = e - tt * HD;
    if (kFull || tt < len) {
      float ws[P::kWarps];
#pragma unroll
      for (int x = 0; x < P::kWarps; ++x) ws[x] = sm.dvp[tt][x][j];
      sm.dvb[sp.buf][tt][j] = fmaf(st.dout[tt][padded(j)], sm.bpart[tt],
                                   tree_sum<0, P::kWarps>(ws));
    }
  }
  cluster_arrive();  // this block's sums are in, and it has read the last
}

template <class P, int W>
__global__ void __launch_bounds__(P::kThreads, P::kMinBlocks)
    wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u,
                    const float* __restrict__ ckpt,
                    const float* __restrict__ dout,
                    const float* __restrict__ dstate,
                    float* __restrict__ dr, float* __restrict__ dk,
                    float* __restrict__ dw, float* __restrict__ dv,
                    float* __restrict__ du_part,
                    float* __restrict__ dstate0, int s, int h) {
  constexpr int HD = P::kHD, VALS = P::kVals, RPT = P::kRpt;
  constexpr int HELD = P::kHeld;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<P>& sm = *reinterpret_cast<Smem<P>*>(smem_raw);
  Where at;
  const int bh = blockIdx.x / P::kSplit;  // b * h + head
  at.split = static_cast<int>(cg::this_cluster().block_rank());
  const int b = bh / h;
  const int head = bh - b * h;
  at.tid = threadIdx.x;
  at.lane = at.tid % 32;
  at.warp = at.tid / 32;
  const int group = at.tid / P::kLanes;  // row group within the block
  at.row0 = group * RPT;                 // its first row within the block
  at.sub = at.tid % P::kLanes;           // which range of j
  at.i0 = at.split * P::kRows;           // the block's first row
  const int j0 = at.sub * VALS;
  at.pj0 = padded(j0);                   // a lane's values never cross 32
  at.step = static_cast<size_t>(h) * HD;
  at.base = static_cast<size_t>(b) * s * at.step +
            static_cast<size_t>(head) * HD;
  for (int e = at.tid; e < P::kRows; e += P::kThreads)
    sm.u[e] = u[static_cast<size_t>(head) * HD + at.i0 + e];
  float du_acc[RPT];
  float g[HELD];  // G[i][j0 + q] of the thread's rows: the gradient of the
                  // state after the step
  const int n_ck = s / kChunk + 1;
  const size_t row_off =
      (static_cast<size_t>(bh) * HD + at.i0 + at.row0) * HD + j0;
#pragma unroll
  for (int e = 0; e < RPT; ++e) {
    du_acc[e] = 0.f;
#pragma unroll
    for (int q = 0; q < VALS; ++q)
      g[e * VALS + q] = dstate[row_off + e * HD + q];
  }
  const float* ck_row = ckpt + static_cast<size_t>(bh) * n_ck * HD * HD +
                        static_cast<size_t>(at.i0 + at.row0) * HD + j0;
  // the last chunk's operands and checkpoint
  const int n_last = (s + kChunk - 1) / kChunk - 1;
  float ck[HELD];
  stage_issue<P, W>(sm.st[n_last & 1], r, k, w, v, dout,
                    at.base + n_last * kChunk * at.step, at.step,
                    s - n_last * kChunk, at.i0);
#pragma unroll
  for (int e = 0; e < RPT; ++e) {
    float x[VALS];
    load_vals(x, ck_row + static_cast<size_t>(n_last) * HD * HD + e * HD);
#pragma unroll
    for (int q = 0; q < VALS; ++q) ck[e * VALS + q] = x[q];
  }
  Span prev = {0, 0, -1};

  for (int n = n_last; n >= 0; --n) {
    const Span sp = {n * kChunk, min(kChunk, s - n * kChunk), n & 1};
    const Stage<P>& st = sm.st[n & 1];
    stage_wait();
    __syncthreads();  // the chunk, staged by all, is in; the other buffer
                      // is read
    float p[HELD];    // the state before the chunk, from its checkpoint
    copy_held<P>(p, ck);
    if (n > 0) {
      // the chunk before: its operands and checkpoint, in flight meanwhile
      stage_issue<P, W>(sm.st[(n - 1) & 1], r, k, w, v, dout,
                        at.base + (sp.t0 - kChunk) * at.step, at.step,
                        kChunk, at.i0);
#pragma unroll
      for (int e = 0; e < RPT; ++e) {
        float x[VALS];
        load_vals(x, ck_row + static_cast<size_t>(n - 1) * HD * HD + e * HD);
#pragma unroll
        for (int q = 0; q < VALS; ++q) ck[e * VALS + q] = x[q];
      }
    }
    // a_t of steps group, group + kGroups, ...: a group's lanes each sum
    // their products, then add their neighbours' sums; steps past the
    // chunk store nothing read
#pragma unroll
    for (int tt0 = 0; tt0 < kChunk; tt0 += P::kGroups) {
      const int tt = (tt0 + group) % kChunk;
      float vv[VALS], dd[VALS];
      load_vals(vv, &st.v[tt][at.pj0]);
      load_vals(dd, &st.dout[tt][at.pj0]);
      float sa = 0.f;
#pragma unroll
      for (int q = 0; q < VALS; ++q) sa = fmaf(vv[q], dd[q], sa);
#pragma unroll
      for (int x = 1; x < P::kLanes; x <<= 1)
        sa += __shfl_xor_sync(0xffffffffu, sa, x);
      if (at.sub == 0 && tt0 + group < kChunk) sm.a[tt] = sa;
    }
    __syncthreads();  // a_t is in
    if (sp.len == kChunk)
      chunk<P, true>(sm, st, at, sp, prev, p, g, du_acc, dr, dk, dv, dw);
    else
      chunk<P, false>(sm, st, at, sp, prev, p, g, du_acc, dr, dk, dv, dw);
    prev = sp;
  }
  cluster_wait();
  cluster_dv(sm, at, prev, dv);
  cluster_arrive();
  cluster_wait();  // no block leaves while another reads its shared memory
#pragma unroll
  for (int e = 0; e < RPT; ++e) {
#pragma unroll
    for (int q = 0; q < VALS; ++q)
      dstate0[row_off + e * HD + q] = g[e * VALS + q];
    if (at.sub == 0)
      du_part[(static_cast<size_t>(b) * h + head) * HD + at.i0 + at.row0 +
              e] = du_acc[e];
  }
}

// du: the batch rows' partials in order
__global__ void wkv6_bwd_finish(const float* __restrict__ du_part,
                                float* __restrict__ du, int hh, int batch) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < hh) {
    float acc = 0.f;
    for (int b = 0; b < batch; ++b)
      acc += du_part[static_cast<size_t>(b) * hh + e];
    du[e] = acc;
  }
}

template <class P, int W>
cudaError_t launch_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                          int batch, int h, cudaStream_t stream) {
  auto kernel = &wkv6_bwd_kernel<P, W>;
  const int smem = static_cast<int>(sizeof(Smem<P>));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(batch * h * P::kSplit));
  cfg.blockDim = dim3(P::kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = P::kSplit;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <class P>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* ckpt, const float* dout,
           const float* dstate, float* dr, float* dk, float* dv, float* dw,
           float* du, float* dstate0, float* work, int batch, int s, int h,
           cudaStream_t stream) {
  float* du_part = work;
  const bool aligned = ((reinterpret_cast<uintptr_t>(r) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(dout)) & 15) == 0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err;
  if (aligned) {
    err = launch_config<P, 4>(cfg, attr, batch, h, stream);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, wkv6_bwd_kernel<P, 4>, r, k, v, w, u,
                               ckpt, dout, dstate, dr, dk, dw, dv, du_part,
                               dstate0, s, h);
  } else {
    err = launch_config<P, 1>(cfg, attr, batch, h, stream);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, wkv6_bwd_kernel<P, 1>, r, k, v, w, u,
                               ckpt, dout, dstate, dr, dk, dw, dv, du_part,
                               dstate0, s, h);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int hh = h * P::kHD;
  constexpr int kFinish = 256;
  wkv6_bwd_finish<<<(hh + kFinish - 1) / kFinish, kFinish, 0, stream>>>(
      du_part, du, hh, batch);
  return static_cast<int>(cudaGetLastError());
}

// the plan for hd 64: Many64 once the blocks outnumber two an SM
bool many_heads(int batch, int h) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  return static_cast<long long>(batch) * h * Few64::kSplit > 2LL * sms;
}

template <class P>
int plan_of(int batch, int h, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = launch_config<P, 4>(cfg, attr, batch, h, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, wkv6_bwd_kernel<P, 4>);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0, clusters = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, wkv6_bwd_kernel<P, 4>, P::kThreads, sizeof(Smem<P>));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveClusters(&clusters, wkv6_bwd_kernel<P, 4>,
                                       &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[] = {P::kVals, P::kRpt, P::kSub, P::kThreads, P::kSplit,
                      static_cast<int>(sizeof(Smem<P>)), fa.numRegs,
                      static_cast<int>(fa.localSizeBytes), blocks, clusters,
                      batch * h * P::kSplit};
  for (int x = 0; x < 11; ++x) out[x] = vals[x];
  return 0;
}

}  // namespace

// Bytes of the scratch `work` that wkv6_bwd_launch needs (0: refused):
// du's per-batch partials.
extern "C" long long wkv6_bwd_workspace(int batch, int s, int h, int hd) {
  (void)s;
  if (hd != 16 && hd != 64) return 0;
  return 4LL * batch * h * hd;
}

// The launch wkv6_bwd_launch makes at this shape, into out[11]: values a
// lane of a row, rows a thread, steps a sub-chunk, threads a block, blocks
// a cluster, shared bytes a block, registers a thread, local (spill) bytes
// a thread, blocks resident an SM, clusters resident on the card, blocks
// launched.
// Returns a cudaError_t (0: filled).
extern "C" int wkv6_bwd_plan(int batch, int s, int h, int hd, int* out) {
  (void)s;
  switch (hd) {
    case 16:
      return plan_of<Head16>(batch, h, out);
    case 64:
      return many_heads(batch, h) ? plan_of<Many64>(batch, h, out)
                                  : plan_of<Few64>(batch, h, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// r, k, v, w, dout, dr, dk, dv, dw [batch, s, h, hd]; u, du [h, hd]; ckpt
// [batch, h, s / 16 + 1, hd, hd] as wkv6_launch wrote it; dstate, dstate0
// [batch, h, hd, hd]; work of wkv6_bwd_workspace bytes; all float32,
// contiguous, on the device of `stream`.  hd is 16 or 64.  Two launches
// (the scan with its cluster sums, then du's sum over the batch rows).
// Returns the cudaError_t of the launches (0: launched).
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* ckpt,
                               const void* dout, const void* dstate, void* dr,
                               void* dk, void* dv, void* dw, void* du,
                               void* dstate0, void* work, int batch, int s,
                               int h, int hd, void* stream) {
  if (batch <= 0 || s <= 0 || h <= 0 ||
      static_cast<long long>(batch) * h * (hd / 16) > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* rp = static_cast<const float*>(r);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* wp = static_cast<const float*>(w);
  const auto* up = static_cast<const float*>(u);
  const auto* cp = static_cast<const float*>(ckpt);
  const auto* op = static_cast<const float*>(dout);
  const auto* sp = static_cast<const float*>(dstate);
  auto* o_r = static_cast<float*>(dr);
  auto* o_k = static_cast<float*>(dk);
  auto* o_v = static_cast<float*>(dv);
  auto* o_w = static_cast<float*>(dw);
  auto* o_u = static_cast<float*>(du);
  auto* o_s = static_cast<float*>(dstate0);
  auto* wk = static_cast<float*>(work);
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<Head16>(rp, kp, vp, wp, up, cp, op, sp, o_r, o_k, o_v,
                            o_w, o_u, o_s, wk, batch, s, h, st);
    case 64:
      if (many_heads(batch, h))
        return launch<Many64>(rp, kp, vp, wp, up, cp, op, sp, o_r, o_k, o_v,
                              o_w, o_u, o_s, wk, batch, s, h, st);
      return launch<Few64>(rp, kp, vp, wp, up, cp, op, sp, o_r, o_k, o_v,
                           o_w, o_u, o_s, wk, batch, s, h, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* wkv6_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
