// Brandes' betweenness centrality, one BFS level at a time, batched over
// up to 1,024 sources, over a CSR graph, with bit-packed multi-source
// frontiers and values kept in level order.
//
// Replaces no TPU kernel: the reference computes these steps as XLA dots
// over a dense [N, N] float32 adjacency, `(sigma * frontier) @ adj` and
// `coeff @ adj.T` (src/repro/algorithms/betweenness.py:107, :124).  At the
// paper's scale 17 that adjacency is 64 GiB and one level's product
// 3.5e13 FLOP, for a graph with 5.8e-5 of its entries set; so the port
// keeps the edges as CSR index lists and each level pulls over them.
//
// State, vertex-major for N vertices and S sources (S a power of two from
// 32 to 1,024; W = S / 32 words a vertex), updated in place
// (kernels/bc/ref.py):
//   on[L]   int32 [N, W] the pairs on level L, bit b of word j is pair
//                        (v, 32 j + b): the BFS's multi-source frontier,
//                        as in "The More the Merrier" (Then et al., VLDB
//                        2015); the masks are the BFS distances, and no
//                        distance array is kept;
//   visited int32 [N, W] the pairs reached so far;
//   live    int32 [W]    the sources whose frontier is not empty;
//   sigma, coeff float [N, S] in level order: each row is cut into parts
//                        of 512 sources (kPartWords words), and a part
//                        holds its pairs' values level by level, each
//                        level's in source order, from column
//                        base[L][v, part], the part's pairs on the levels
//                        before L (base[L] int32 [N, parts]).  sigma is
//                        the shortest-path count, coeff (1 + delta) /
//                        sigma, written by the backward level that
//                        finalises delta;
//   delta float [N, S]   dependencies, in source order.
//
//   forward level L  (in-edges): for every pair (v, s) not visited whose
//     source is live, reach = sum over u in in(v), in CSR order, of
//     sigma[u, s] where (u, s) is on level L; if reach > 0 the pair joins:
//     sigma = reach at the end of v's run, its bit set in on[L + 1],
//     visited and the next level's live words; base[L + 1][v] = the
//     part's pairs visited before.
//   backward level L (out-edges): for every pair (u, s) on level L - 1,
//     back = sum over w in out(u), in CSR order, of coeff[w, s] where
//     (w, s) is on level L; delta = sigma * back, then coeff = (1 + delta)
//     / sigma.  A pair is on one level, so its delta is written once, by
//     this launch, and 0 before: the reference's delta + sigma * back
//     (betweenness.py:127) with delta = 0 has the same bits, since the
//     product is +0.0 or positive.  The sweep's first backward launch is
//     at an empty level (the one the BFS ran out on, or one past a cut):
//     it writes the top pairs' coeff, 1 / sigma.
//
// In place is safe: a forward level reads the level-L runs of sigma and
// writes level L + 1's, which lie after them in each part; a backward
// level reads the level-L runs of coeff and writes level L - 1's, and
// writes delta only of the pairs on L - 1.
//
// Determinism and rounding: the warp that owns (a part of) vertex v sums
// each of its pairs sequentially, in CSR order, from +0.0; no float
// atomics.  Every float operation is an intrinsic (__fadd_rn, __fmul_rn,
// __fdiv_rn), so nvcc cannot contract 1 + sigma * back into an FMA.
// A neighbour off the level adds nothing, which leaves a sum of
// non-negative terms as the plain versions leave it, adding +0.0; so the
// two agree bit for bit.  coeff is the reference's expression once a pair
// instead of once an edge, so it has the same bits.  The live words are
// built with atomicOr, which commutes.
//
// What bounds it: bytes.  To know which pairs are on duty a level must
// read one bit a pair (visited and on[L], and write on[L + 1], forward;
// on[L] and on[L - 1] backward), sigma of the frontier pairs (forward) or
// coeff of the pairs on L and sigma of those on L - 1 (backward), write
// the values that change (sigma of the joined pairs; delta and coeff of
// those on L - 1), and read the CSR.  What stands
// in the way, and the design:
//   * A pull re-reads a neighbour's values for every edge.  Lane j loads
//     word j of the neighbour's row of on[L], so its membership for a part
//     of 512 sources is one coalesced 64-byte load; ANDed with the
//     vertex's own words (not visited and live forward, on L - 1
//     backward) it says whether the neighbour is wanted at all.  A wanted
//     neighbour's level-L values are one run in level order (its values
//     on the level and no others), copied whole into the warp's stage in
//     shared memory by cp.async, or, where few of them are wanted (below
//     1 in kSparse), only those; the warp waits once for all the runs
//     that fit.  So the loads in flight are the level's values, held in
//     shared memory, not a register a lane and source.
//   * Adding a run is work for the pairs wanted, not for every source:
//     the 32 / KW lanes of word j (KW words a part) each walk the wanted
//     bits of their KW-bit slice of it and add each value, found by its
//     rank in the run, into the warp's sums in shared memory (a row of 33
//     floats a word, against bank conflicts).  So no lane idles while
//     others add, as those past a part's words did when a lane took a
//     word.
//   * A level writes sigma and coeff as whole runs, not a column here and
//     there: a 32-byte sector written in part costs the memory a read and
//     a write.  (delta stays in source order, the order its sum over the
//     sources takes; it is written, never read.)
//   * Rows are cut into parts of 512 sources, a block of warps a part, so
//     a warp's state is small and a card holds many warps.  The warps of
//     a part split the work by CSR row length (binary search of the row
//     pointers), so a hub does not hold up a grid-stride stripe.

#include <cstdint>
#include <type_traits>

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxWords = 32;   // 1,024 sources
constexpr int kPartWords = 16;  // words of a row part: one warp's share
constexpr int kBatch = 8;       // neighbours whose mask loads go together
constexpr int kSparse = 8;      // stage the wanted values alone below 1/8
constexpr int kVertexCost = 8;  // a vertex's own work, in edges
constexpr unsigned kFull = 0xffffffffu;

// (1 + delta) / safe_sigma, the reference's coefficient (betweenness.py:122)
__device__ __forceinline__ float coeff_of(float delta, float sigma) {
  return __fdiv_rn(__fadd_rn(1.0f, delta), sigma > 0.0f ? sigma : 1.0f);
}

// The bits below this lane's.
__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// The sum of `n` over the lanes below this one (an exclusive scan).
__device__ __forceinline__ int before(int n, int lane) {
  int sum = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, sum, d);
    if (lane >= d) sum += up;
  }
  return sum - n;
}

// This warp's vertices [*first, *last): the warps of a part split the
// cost indptr[v] + kVertexCost * v evenly, each taking a run of whole
// vertices.  Lanes 0-15 search for the first vertex of this warp, lanes
// 16-31 for that of the next, 16 probes a round: five rounds of loads at
// N = 2^17.
__device__ __forceinline__ void warp_vertices(const int* __restrict__ indptr,
                                              int n, int lane, int* first,
                                              int* last) {
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kWarps +
                       (threadIdx.x >> 5);
  const int half = lane >> 4;
  const int probe = lane & 15;
  const int64_t total = indptr[n] + static_cast<int64_t>(kVertexCost) * n;
  const int64_t target = (warp + half) * total / warps;
  // the least v in [lo, hi] with cost(v) >= target; cost(n) = total
  int lo = 0;
  int hi = n;
  while (!__all_sync(kFull, lo == hi)) {
    const int p = lo + static_cast<int>(
                           static_cast<int64_t>(hi - lo) * (probe + 1) / 16);
    const bool ge =
        indptr[p] + static_cast<int64_t>(kVertexCost) * p >= target;
    const unsigned m = (__ballot_sync(kFull, ge) >> (16 * half)) & 0xffffu;
    const int f = __ffs(m) - 1;  // probe 15 is hi: m != 0
    const int at = __shfl_sync(kFull, p, 16 * half + f);
    const int below = __shfl_sync(kFull, p, 16 * half + (f > 0 ? f - 1 : 0));
    lo = f > 0 ? below + 1 : lo;
    hi = at;
  }
  *first = __shfl_sync(kFull, lo, 0);
  *last = __shfl_sync(kFull, lo, 16);
}

// A warp's view of one part (KW words, the block's `part`) of the rows.
struct Part {
  int index;   // p: this part
  int parts;   // P: parts a row
  int word;    // its first word, p KW
  int words;   // W: words a row
  int s_pad;   // S: sources a row
  bool own;    // this lane holds one of the part's words
};

// A warp's sums: the pair (v, 32 j + b) of its part at acc[j * kRow + b],
// so that the lanes of word j add into its row (a row padded by one word
// against bank conflicts between the lanes).
constexpr int kRow = 33;

// The pull over the CSR row [beg, end): for each neighbour x in order and
// every pair (x, s) of the part on the level (bit b of on[x, j], s = 32 j +
// b) that this vertex wants (bit b of want's word j, on lane j), the
// pair's value is added to the warp's sum of (v, s) in `acc`.  `vals`
// holds values in level order: x's values on the level, in source order,
// from column base[x, p] of x's part.  The mask loads of kBatch neighbours
// go together (lane j word j, one coalesced load a neighbour), with their
// base; they are kept in `rows` (kBatch x 32 words of shared memory).
// Then the run of values of each neighbour with a pair wanted is copied
// whole (or, where fewer than 1 in kSparse of them are wanted, those
// values alone, at their places), asynchronously (cp.async: no register
// held, 4 bytes a lane), into the warp's `stage` of 32 KW floats, as many
// runs as fit before the warp waits once and adds them, in CSR order: the
// loads in flight are the level's values, not a lane a source.  The
// lanes of word j add its wanted pairs, each from its rank in the run, so
// a neighbour costs the warp its most wanted pairs in one slice of a
// word, not a pass over every source.  One loop stages and adds, so the
// adds are compiled once.
template <int KW>
__device__ __forceinline__ void pull(const int* __restrict__ indices, int beg,
                                     int end, const unsigned* on,
                                     const float* vals, const int* base,
                                     const Part& pt, float* stage,
                                     unsigned* rows, float* acc,
                                     unsigned want, int lane) {
  static_assert(KW <= 16 && (KW & (KW - 1)) == 0, "a part of 1 to 16 words");
  constexpr int kStage = 32 * KW;
  // Each word's bits are shared by 32 / KW lanes: lane l adds the bits
  // [KW s, KW (s + 1)) of word l % KW, s = l / KW.  A source's values
  // are still added by one lane, in CSR order.
  const int wj = lane % KW;
  const unsigned slice = ((1u << KW) - 1u) << (KW * (lane / KW));
  const unsigned want_add = __shfl_sync(kFull, want, wj) & slice;
  for (int j0 = beg; j0 < end; j0 += 32) {
    const int cnt = min(32, end - j0);
    const int mine = lane < cnt ? indices[j0 + lane] : 0;
    for (int t0 = 0; t0 < cnt; t0 += kBatch) {
      unsigned row[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const int x = __shfl_sync(kFull, mine, t0 + k);
        row[k] = pt.own && t0 + k < cnt
                     ? on[static_cast<int64_t>(x) * pt.words + lane]
                     : 0u;
      }
      // lane k < kBatch: where neighbour t0 + k's run starts
      const int xk = __shfl_sync(kFull, mine, t0 + (lane & (kBatch - 1)));
      const int run = lane < kBatch && t0 + lane < cnt
                          ? base[static_cast<int64_t>(xk) * pt.parts +
                                 pt.index]
                          : 0;
      unsigned todo = 0u;  // neighbours with a pair wanted, not staged
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        rows[32 * k + lane] = row[k];
        todo |= __any_sync(kFull, (row[k] & want) != 0u) ? 1u << k : 0u;
      }
      __syncwarp();
      int staged = 0;         // values in the stage
      unsigned waiting = 0u;  // neighbours staged, not added
      while (todo != 0u || waiting != 0u) {
        bool add = todo == 0u;
        if (!add) {
          const int k = __ffs(todo) - 1;
          const unsigned w = rows[32 * k + lane];
          const int count = __reduce_add_sync(kFull, __popc(w));
          if (staged + count > kStage) {
            add = true;
          } else {
            const int x = __shfl_sync(kFull, mine, t0 + k);
            const float* src = vals + static_cast<int64_t>(x) * pt.s_pad +
                               __shfl_sync(kFull, run, k);
            if (__reduce_add_sync(kFull, __popc(w & want)) * kSparse <
                count) {
              // few pairs wanted: their values alone, at their places
              const int first =
                  __shfl_sync(kFull, before(__popc(w), lane), wj);
              const unsigned wa = __shfl_sync(kFull, w, wj);
              for (unsigned hit = wa & want_add; hit != 0u; hit &= hit - 1u) {
                const int c = first + __popc(wa & lanes_below(__ffs(hit) - 1));
                __pipeline_memcpy_async(stage + staged + c, src + c, 4);
              }
            } else {
              for (int c = lane; c < count; c += 32) {
                __pipeline_memcpy_async(stage + staged + c, src + c, 4);
              }
            }
            __pipeline_commit();
            staged += count;
            waiting |= 1u << k;
            todo &= todo - 1u;
          }
        }
        if (add) {
          __pipeline_wait_prior(0);
          __syncwarp();
          int at = 0;  // the run's first value in the stage
          for (unsigned left = waiting; left != 0u; left &= left - 1u) {
            const unsigned w = rows[32 * (__ffs(left) - 1) + lane];
            // word wj's first value in the stage
            const int first =
                __shfl_sync(kFull, at + before(__popc(w), lane), wj);
            const int next = at + __reduce_add_sync(kFull, __popc(w));
            const unsigned wa = __shfl_sync(kFull, w, wj);
            for (unsigned hits = wa & want_add; hits != 0u;
                 hits &= hits - 1u) {
              const int b = __ffs(hits) - 1;
              float* sum = acc + wj * kRow + b;
              *sum = __fadd_rn(*sum,
                               stage[first + __popc(wa & lanes_below(b))]);
            }
            at = next;
          }
          __syncwarp();
          staged = 0;
          waiting = 0u;
        }
      }
    }
  }
}

template <int KW>
__global__ void __launch_bounds__(kThreads, 2)
bc_forward_level_kernel(const int* __restrict__ indptr,
                        const int* __restrict__ indices, float* sigma,
                        unsigned* visited,
                        const unsigned* __restrict__ on,
                        unsigned* __restrict__ on_next,
                        const int* __restrict__ base,
                        int* __restrict__ base_next,
                        const unsigned* __restrict__ live,
                        unsigned* live_next, int n, int s_pad) {
  __shared__ unsigned block_live[KW];
  __shared__ float stages[kWarps][32 * KW];
  __shared__ unsigned row_words[kWarps][32 * kBatch];
  __shared__ float sums[kWarps][KW * kRow];
  float* stage = stages[threadIdx.x >> 5];
  unsigned* rows = row_words[threadIdx.x >> 5];
  float* acc = sums[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int words = s_pad >> 5;
  const Part pt{static_cast<int>(blockIdx.y), static_cast<int>(gridDim.y),
                static_cast<int>(blockIdx.y) * KW, words, s_pad,
                lane < min(KW, words - static_cast<int>(blockIdx.y) * KW)};
  const unsigned below = lanes_below(lane);
  if (threadIdx.x < KW) block_live[threadIdx.x] = 0u;
  __syncthreads();
  const unsigned live_w = pt.own ? live[pt.word + lane] : 0u;
  int first = 0;
  int last = 0;
  warp_vertices(indptr, n, lane, &first, &last);
  // the next vertex's words and row end, loaded one vertex ahead
  unsigned seen =
      first < last && pt.own
          ? visited[static_cast<int64_t>(first) * words + pt.word + lane]
          : 0u;
  int beg = first < last ? indptr[first] : 0;
  int end = first < last ? indptr[first + 1] : 0;
  for (int v = first; v < last; ++v) {
    const bool more = v + 1 < last;
    const int64_t vw = static_cast<int64_t>(v) * words + pt.word + lane;
    const unsigned seen_next = more && pt.own ? visited[vw + words] : 0u;
    const int end_next = more ? indptr[v + 2] : 0;
    const unsigned todo = ~seen & live_w;
    // the part's pairs visited before: where the joined pairs' run starts
    const int start = __reduce_add_sync(kFull, __popc(seen));
    unsigned joined = 0u;
    if (__any_sync(kFull, todo != 0u)) {
#pragma unroll
      for (int j = 0; j < KW; ++j) acc[j * kRow + lane] = 0.0f;
      __syncwarp();
      pull<KW>(indices, beg, end, on + pt.word, sigma + 32 * pt.word, base,
               pt, stage, rows, acc, todo, lane);
      const int64_t row = static_cast<int64_t>(v) * s_pad + 32 * pt.word;
      int at = start;
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        // a sum > 0 only for a pair in todo with a neighbour on the level
        const float reach = acc[j * kRow + lane];
        const bool join = reach > 0.0f;
        const unsigned bits = __ballot_sync(kFull, join);
        if (lane == j) joined = bits;
        if (join) sigma[row + at + __popc(bits & below)] = reach;
        at += __popc(bits);
      }
      __syncwarp();
      if (joined != 0u) {
        visited[vw] = seen | joined;
        atomicOr(&block_live[lane], joined);
      }
    }
    if (pt.own) on_next[vw] = joined;
    if (lane == 0) {
      base_next[static_cast<int64_t>(v) * pt.parts + pt.index] = start;
    }
    seen = seen_next;
    beg = end;
    end = end_next;
  }
  __syncthreads();
  if (threadIdx.x < KW && pt.word + threadIdx.x < words &&
      block_live[threadIdx.x] != 0u) {
    atomicOr(&live_next[pt.word + threadIdx.x], block_live[threadIdx.x]);
  }
}

template <int KW>
__global__ void __launch_bounds__(kThreads, 2)
bc_backward_level_kernel(const int* __restrict__ indptr,
                         const int* __restrict__ indices,
                         const float* __restrict__ sigma,
                         float* __restrict__ delta, float* coeff,
                         const unsigned* __restrict__ on,
                         const unsigned* __restrict__ on_below,
                         const int* __restrict__ base,
                         const int* __restrict__ base_below, int n,
                         int s_pad) {
  constexpr int kChunk = KW < 8 ? KW : 8;  // epilogue words loaded together
  __shared__ float stages[kWarps][32 * KW];
  __shared__ unsigned row_words[kWarps][32 * kBatch];
  __shared__ float sums[kWarps][KW * kRow];
  float* stage = stages[threadIdx.x >> 5];
  unsigned* rows = row_words[threadIdx.x >> 5];
  float* acc = sums[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int words = s_pad >> 5;
  const Part pt{static_cast<int>(blockIdx.y), static_cast<int>(gridDim.y),
                static_cast<int>(blockIdx.y) * KW, words, s_pad,
                lane < min(KW, words - static_cast<int>(blockIdx.y) * KW)};
  const unsigned below = lanes_below(lane);
  int first = 0;
  int last = 0;
  warp_vertices(indptr, n, lane, &first, &last);
  unsigned mine =
      first < last && pt.own
          ? on_below[static_cast<int64_t>(first) * words + pt.word + lane]
          : 0u;
  int start = first < last
                  ? base_below[static_cast<int64_t>(first) * pt.parts +
                               pt.index]
                  : 0;
  int beg = first < last ? indptr[first] : 0;
  int end = first < last ? indptr[first + 1] : 0;
  for (int u = first; u < last; ++u) {
    const bool more = u + 1 < last;
    const unsigned mine_next =
        more && pt.own
            ? on_below[static_cast<int64_t>(u + 1) * words + pt.word + lane]
            : 0u;
    const int start_next =
        more ? base_below[static_cast<int64_t>(u + 1) * pt.parts + pt.index]
             : 0;
    const int end_next = more ? indptr[u + 2] : 0;
    if (__any_sync(kFull, mine != 0u)) {
#pragma unroll
      for (int j = 0; j < KW; ++j) acc[j * kRow + lane] = 0.0f;
      __syncwarp();
      pull<KW>(indices, beg, end, on + pt.word, coeff + 32 * pt.word, base,
               pt, stage, rows, acc, mine, lane);
      const int64_t row = static_cast<int64_t>(u) * s_pad + 32 * pt.word;
      int at = start;  // the pairs' run in level order
#pragma unroll
      for (int j0 = 0; j0 < KW; j0 += kChunk) {
        int to[kChunk];
        float sg[kChunk];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const unsigned w = __shfl_sync(kFull, mine, j0 + c);
          const bool here = (w >> lane) & 1u;
          to[c] = here ? at + __popc(w & below) : -1;
          at += __popc(w);
          sg[c] = here ? sigma[row + to[c]] : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          if (to[c] >= 0) {
            const float d = __fmul_rn(sg[c], acc[(j0 + c) * kRow + lane]);
            delta[row + 32 * (j0 + c) + lane] = d;
            coeff[row + to[c]] = coeff_of(d, sg[c]);
          }
        }
      }
    }
    __syncwarp();
    mine = mine_next;
    start = start_next;
    beg = end;
    end = end_next;
  }
}

// Launches `kernel` over n vertices on `stream`: as many blocks as stay
// resident on the card (no more than the work needs, a warp a vertex),
// split among the parts of KW words that s_pad sources make.
template <int KW, typename Kernel, typename... Args>
int launch(Kernel kernel, int n, int s_pad, cudaStream_t stream,
           Args... args) {
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int parts = (s_pad / 32 + KW - 1) / KW;
  const int64_t need = (static_cast<int64_t>(n) + kWarps - 1) / kWarps;
  int64_t cap = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1) / parts;
  cap = cap > 0 ? cap : 1;
  const dim3 grid(static_cast<unsigned>(need < cap ? need : cap), parts);
  kernel<<<grid, kThreads, 0, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Calls go(std::integral_constant<int, KW>) with KW, the words of a row
// part for s_pad sources: s_pad / 32 up to kPartWords, kPartWords above
// (the row cut into parts).  s_pad, a power of two from 32 to 32
// kMaxWords, is checked.
template <typename Go>
int with_words(int s_pad, Go go) {
  if (s_pad < 32 || (s_pad & (s_pad - 1)) || s_pad > 32 * kMaxWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (s_pad / 32) {
    case 1: return go(std::integral_constant<int, 1>());
    case 2: return go(std::integral_constant<int, 2>());
    case 4: return go(std::integral_constant<int, 4>());
    case 8: return go(std::integral_constant<int, 8>());
    default: return go(std::integral_constant<int, kPartWords>());
  }
}

}  // namespace

// indptr [n + 1], indices [E]: int32 CSR of the in-edges; sigma [n,
// s_pad] float32, in level order by row part, and visited [n, s_pad / 32]
// int32, updated in place; on [n, s_pad / 32] int32, the pairs on the
// level, and base [n, parts] int32, where their values start, read;
// on_next [n, s_pad / 32] and base_next [n, parts] int32, every entry
// written; live [s_pad / 32] int32 read; live_next [s_pad / 32] int32,
// zeroed by the caller, ORed with the sources of which a pair joins.
// s_pad a power of two from 32 to 1,024; parts = s_pad / 512, at least 1.
// All on the device, contiguous.  Launches on `stream`; returns a
// cudaError_t as int, 0 on success.
extern "C" int bc_forward_level_launch(const void* indptr, const void* indices,
                                       void* sigma, void* visited,
                                       const void* on,
                                       void* on_next, const void* base,
                                       void* base_next, const void* live,
                                       void* live_next, int n, int s_pad,
                                       void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  return with_words(s_pad, [&](auto kw) {
    constexpr int KW = decltype(kw)::value;
    if (n == 0) return 0;
    return launch<KW>(
        bc_forward_level_kernel<KW>, n, s_pad,
        static_cast<cudaStream_t>(stream), static_cast<const int*>(indptr),
        static_cast<const int*>(indices), static_cast<float*>(sigma),
        static_cast<unsigned*>(visited),
        static_cast<const unsigned*>(on), static_cast<unsigned*>(on_next),
        static_cast<const int*>(base), static_cast<int*>(base_next),
        static_cast<const unsigned*>(live),
        static_cast<unsigned*>(live_next), n, s_pad);
  });
}

// indptr [n + 1], indices [E]: int32 CSR of the out-edges; sigma [n,
// s_pad] float32, in level order, read; delta [n, s_pad] float32, in
// source order, written for the pairs on the level below (0 before), and
// coeff [n, s_pad] float32, in level order, updated in place; on and on_below [n, s_pad / 32] int32, the pairs on the level and
// on the level below, and base and base_below [n, parts] int32, where
// their values start, read.  As above otherwise.
extern "C" int bc_backward_level_launch(const void* indptr,
                                        const void* indices,
                                        const void* sigma, void* delta,
                                        void* coeff, const void* on,
                                        const void* on_below,
                                        const void* base,
                                        const void* base_below, int n,
                                        int s_pad, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  return with_words(s_pad, [&](auto kw) {
    constexpr int KW = decltype(kw)::value;
    if (n == 0) return 0;
    return launch<KW>(
        bc_backward_level_kernel<KW>, n, s_pad,
        static_cast<cudaStream_t>(stream), static_cast<const int*>(indptr),
        static_cast<const int*>(indices), static_cast<const float*>(sigma),
        static_cast<float*>(delta), static_cast<float*>(coeff),
        static_cast<const unsigned*>(on),
        static_cast<const unsigned*>(on_below),
        static_cast<const int*>(base), static_cast<const int*>(base_below),
        n, s_pad);
  });
}

extern "C" int bc_level_max_sources() { return 32 * kMaxWords; }

extern "C" int bc_level_part_sources() { return 32 * kPartWords; }

extern "C" const char* bc_level_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
