// Brandes' betweenness centrality, one BFS level at a time, batched over
// sources, over a CSR graph.
//
// Replaces no TPU kernel: the reference computes these steps as XLA dots
// over a dense [N, N] float32 adjacency, `(sigma * frontier) @ adj` and
// `coeff @ adj.T` (src/repro/algorithms/betweenness.py:107, :124).  At the
// paper's scale 17 that adjacency is 64 GiB and one level's product
// 3.5e13 FLOP, for a graph with 5.8e-5 of its entries set; so the port
// keeps the edges as CSR index lists and each level pulls over them.
//
// State, vertex-major [N, S] for N vertices and S sources (a multiple of
// 32), updated in place:  dist int32 (BFS level, kInf if not reached),
// sigma float32 (shortest-path counts), delta float32 (dependencies).
//
//   forward level L  (in-edges):  for every (v, s) with dist == kInf whose
//     source is live (live_in[s] != 0: some pair of s has dist == L, its
//     frontier is not empty), reach = sum over u in in(v), in CSR
//     order, of sigma[u, s] where dist[u, s] == L; if reach > 0:
//     dist = L + 1, sigma = reach, live_out[s] = 1.
//   backward level L (out-edges): for every (u, s) with dist == L - 1,
//     back = sum over w in out(u), in CSR order, of
//     (1 + delta[w, s]) / safe_sigma[w, s] where dist[w, s] == L;
//     delta[u, s] = delta[u, s] + sigma[u, s] * back.
//
// In place is safe: a forward level writes only pairs that were kInf and
// reads sigma only where dist == L, and kInf and L + 1 both differ from L;
// a backward level writes delta only where dist == L - 1 and reads it only
// where dist == L.
//
// Determinism and rounding: one thread owns one (vertex, source) pair and
// sums its row sequentially, in CSR order, from +0.0; no atomics.  Every
// float operation is an intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn), so
// nvcc cannot contract delta + sigma * back into an FMA.  A neighbour that
// is not on the level is skipped; the plain version (kernels/bc/ref.py)
// adds +0.0 for it, which leaves a sum of non-negative terms unchanged.
// So the two agree bit for bit.
//
// What bounds it: bytes.  A level must read dist of every pair once, and
// the CSR; sigma only of the pairs on the frontier (forward), sigma and
// delta only of the pairs on level L and L - 1 (backward); and write the
// pairs that change.  The pull reads a neighbour's dist for every edge of
// an active pair, 4 bytes a lane, at random rows, so it moves far more.
// What the design does about it: one warp per (vertex, 32-source strip),
// so each neighbour's strip is one coalesced 128-byte load; the warp
// reads its own strip's dist first and leaves at once if no lane is on
// duty (visited forward, not at L - 1 backward), which is most warps on
// most levels; sigma and delta are loaded only for neighbours on the
// level; the loads of kBatch neighbours are issued before any is used.
// Forward, a lane is also off duty once its source's frontier is empty
// (live_in[s] == 0): such a source reaches no one more.  Without that, the
// sources of a block that reach nothing (a vertex with no out-edge) keep
// an unvisited lane in nearly every warp, and every level pulls over
// every in-edge.
// Warps walk the (vertex, strip) pairs grid-stride, from a grid sized to
// the card, so a level with few busy warps is not a million-block launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kInf = 1 << 30;
constexpr int kWarps = 8;  // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSm = 8;
constexpr int kBatch = 8;  // neighbours whose loads are issued together
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int64_t first_warp() {
  return static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
}

__device__ __forceinline__ int64_t warp_stride() {
  return static_cast<int64_t>(gridDim.x) * kWarps;
}

__global__ void __launch_bounds__(kThreads)
bc_forward_level_kernel(const int* __restrict__ indptr,
                        const int* __restrict__ indices, int* dist,
                        float* sigma, int n, int s_pad, int level,
                        const int* __restrict__ live_in, int* live_out) {
  const int lane = threadIdx.x & 31;
  const int strips = s_pad >> 5;
  const int64_t total = static_cast<int64_t>(n) * strips;
  for (int64_t w = first_warp(); w < total; w += warp_stride()) {
    const int v = static_cast<int>(w / strips);
    const int s = static_cast<int>(w % strips) * 32 + lane;
    const int64_t vs = static_cast<int64_t>(v) * s_pad + s;
    const bool active = live_in[s] != 0 && dist[vs] == kInf;
    if (!__any_sync(kFull, active)) continue;
    const int beg = indptr[v];
    const int end = indptr[v + 1];
    float acc = 0.0f;
    for (int j0 = beg; j0 < end; j0 += 32) {
      const int cnt = min(32, end - j0);
      const int mine = lane < cnt ? indices[j0 + lane] : 0;
      for (int t0 = 0; t0 < cnt; t0 += kBatch) {
        int64_t at[kBatch];
        int d[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int u = __shfl_sync(kFull, mine, t0 + k);
          at[k] = static_cast<int64_t>(u) * s_pad + s;
          d[k] = (active && t0 + k < cnt) ? dist[at[k]] : -1;
        }
        float x[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          x[k] = d[k] == level ? sigma[at[k]] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) acc = __fadd_rn(acc, x[k]);
      }
    }
    if (active && acc > 0.0f) {
      dist[vs] = level + 1;
      sigma[vs] = acc;
      live_out[s] = 1;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bc_backward_level_kernel(const int* __restrict__ indptr,
                         const int* __restrict__ indices,
                         const int* __restrict__ dist,
                         const float* __restrict__ sigma, float* delta, int n,
                         int s_pad, int level) {
  const int lane = threadIdx.x & 31;
  const int strips = s_pad >> 5;
  const int64_t total = static_cast<int64_t>(n) * strips;
  for (int64_t w = first_warp(); w < total; w += warp_stride()) {
    const int u = static_cast<int>(w / strips);
    const int s = static_cast<int>(w % strips) * 32 + lane;
    const int64_t us = static_cast<int64_t>(u) * s_pad + s;
    const bool active = dist[us] == level - 1;
    if (!__any_sync(kFull, active)) continue;
    const int beg = indptr[u];
    const int end = indptr[u + 1];
    float back = 0.0f;
    for (int j0 = beg; j0 < end; j0 += 32) {
      const int cnt = min(32, end - j0);
      const int mine = lane < cnt ? indices[j0 + lane] : 0;
      for (int t0 = 0; t0 < cnt; t0 += kBatch) {
        int64_t at[kBatch];
        int d[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int x = __shfl_sync(kFull, mine, t0 + k);
          at[k] = static_cast<int64_t>(x) * s_pad + s;
          d[k] = (active && t0 + k < cnt) ? dist[at[k]] : -1;
        }
        float c[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          c[k] = 0.0f;
          if (d[k] == level) {
            const float sg = sigma[at[k]];
            c[k] = __fdiv_rn(__fadd_rn(1.0f, delta[at[k]]),
                             sg > 0.0f ? sg : 1.0f);
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) back = __fadd_rn(back, c[k]);
      }
    }
    if (active) delta[us] = __fadd_rn(delta[us], __fmul_rn(sigma[us], back));
  }
}

// Blocks for a level over n * s_pad / 32 warps: enough to fill the card,
// no more than the work needs.
int grid_for(int n, int s_pad, int* blocks) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t warps = static_cast<int64_t>(n) * (s_pad / 32);
  const int64_t need = (warps + kWarps - 1) / kWarps;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  *blocks = static_cast<int>(need < cap ? need : cap);
  return 0;
}

}  // namespace

// indptr [n + 1], indices [E]: int32 CSR of the in-edges; dist [n, s_pad]
// int32, sigma [n, s_pad] float32, updated in place; live_in [s_pad] int32
// read; live_out [s_pad] int32, zeroed by the caller, set to 1 for every
// source of which a pair joins.  s_pad is a multiple of 32.  All on the
// device, contiguous.  Launches on `stream`; returns a cudaError_t as int,
// 0 on success.
extern "C" int bc_forward_level_launch(const void* indptr, const void* indices,
                                       void* dist, void* sigma, int n,
                                       int s_pad, int level,
                                       const void* live_in, void* live_out,
                                       void* stream) {
  if (n <= 0 || s_pad <= 0) return 0;
  if (s_pad % 32) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  if (int err = grid_for(n, s_pad, &blocks)) return err;
  bc_forward_level_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<int*>(dist), static_cast<float*>(sigma), n, s_pad, level,
      static_cast<const int*>(live_in), static_cast<int*>(live_out));
  return static_cast<int>(cudaGetLastError());
}

// indptr [n + 1], indices [E]: int32 CSR of the out-edges; dist [n, s_pad]
// int32 and sigma [n, s_pad] float32 read; delta [n, s_pad] float32
// updated in place.  As above otherwise.
extern "C" int bc_backward_level_launch(const void* indptr,
                                        const void* indices, const void* dist,
                                        const void* sigma, void* delta, int n,
                                        int s_pad, int level, void* stream) {
  if (n <= 0 || s_pad <= 0) return 0;
  if (s_pad % 32) return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  if (int err = grid_for(n, s_pad, &blocks)) return err;
  bc_backward_level_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const int*>(dist), static_cast<const float*>(sigma),
      static_cast<float*>(delta), n, s_pad, level);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bc_level_inf() { return kInf; }

extern "C" const char* bc_level_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
