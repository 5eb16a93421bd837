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
//   ckpt [B, H, S / 16 + 1, hd, hd], optional (null: not written): the
//                              state before steps 0, 16, 32, ... (and after
//                              the last step when 16 divides S), for the
//                              backward kernel (wkv6_bwd.cu), which
//                              recomputes the states between two of them;
//                              o and the state keep their bits either way
//
// What bounds it: on paper, the float operations (7 a state value and step,
// 0.45 ms at rwkv6-1.6b's 32k layer) and the bytes (20 a head channel and
// step, 0.40 ms) about equally.  In practice the dispatch of instructions
// and their latency: the steps are a dependent chain, so the parallelism is
// the B * H * hd * hd state values, and each step sums over i for every
// column j.  Column j of S and o_t[j] read only the head's r, k, w and v_j,
// so the columns are independent.  The design spreads them over the card:
//   * a column is held by kLanes neighbouring lanes of one warp (8 at hd 64,
//     2 at hd 16), lane l owning S[i][j] for the kVals = 8 contiguous i in
//     [8l, 8l + 8), in registers, with u[i] beside them;
//   * a block holds kCols = 16 columns of one head (128 threads at hd 64),
//     so a head is hd / 16 blocks: 128 blocks of 4 warps at rwkv6-1.6b's
//     batch 1, one an SM, where one block of 2 warps a head filled 32 SMs;
//   * the block stages r, k and w of the head and v of its columns, kChunk
//     steps at a time, in shared memory, by cp.async copies that pass no
//     register: 16 bytes a copy when the operands are 16-byte aligned (as a
//     fresh tensor is), else 4, coalesced.  Each row is padded by 4 floats
//     after every 32, so the 8 lanes of a column read their 8 ranges by
//     float4 on distinct banks.  Two buffers: the next chunk's copies are in
//     flight while this one is computed.  The 4 blocks of a head each read
//     its r, k and w (0.8 GB more at the 32k layer, from L2);
//   * a full chunk runs kGroup = 8 steps at a time, unrolled: their updates
//     and each lane's sums first (the state's own chain is two operations a
//     step), then the shuffles of all 8 sums, in flight together;
//   * o_t[j] is summed over i in the recursive halves tree: each lane sums
//     its range (tree_sum), then the lanes add their neighbours' sums by
//     __shfl_xor_sync at xor 1, 2, 4 in that order; a pair's two lanes add
//     the same two values, so both hold the same bits.  For a power-of-two
//     hd that is the pairwise tree, level by level, of the plain version's
//     tree_sum (kernels/selective_scan/ref.py).  A different split (lanes
//     owning interleaved i, or the xors in another order) adds in another
//     order and gives other bits (tests/test_torch_scan_split.py).
// Every float operation is an intrinsic (__fmul_rn, __fadd_rn), so nvcc
// does not contract them into FMAs and each rounds once, as the plain
// version's does.  So the two agree bit for bit, and the result is
// deterministic.  The head size is a template parameter: 64 (rwkv6-1.6b)
// and 16 (its smoke config); the launcher refuses any other.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kChunk = 16;  // steps a block stages at once (two buffers)
constexpr int kVals = 8;    // state values (key indices) a lane holds
constexpr int kCols = 16;   // columns of a head a block holds
constexpr int kGroup = 8;   // steps of a chunk unrolled together

template <int HD>
struct Shape {
  static_assert((HD & (HD - 1)) == 0 && HD >= kCols,
                "the head size is a power of two, at least kCols");
  static constexpr int kLanes = HD / kVals;        // lanes a column
  static constexpr int kThreads = kCols * kLanes;  // threads a block
  static constexpr int kSplit = HD / kCols;        // blocks a head
  static constexpr int kRow = HD + HD / 32 * 4;    // a padded shared row
  static_assert(kLanes <= 32 && 32 % kLanes == 0, "a column in one warp");
};

// where entry i of a row sits in shared memory: 4 floats of padding after
// every 32, so that lanes 0 and 4 of a column start on other banks
__device__ __forceinline__ int padded(int i) { return i + (i >> 5) * 4; }

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

// kVals floats from 16-byte aligned shared memory into registers
__device__ __forceinline__ void load_vals(float (&dst)[kVals],
                                          const float* src) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int q = 0; q < kVals / 4; ++q) {
    const float4 x = s4[q];
    dst[4 * q] = x.x;
    dst[4 * q + 1] = x.y;
    dst[4 * q + 2] = x.z;
    dst[4 * q + 3] = x.w;
  }
}

template <int HD>
struct __align__(16) Stage {
  float r[kChunk][Shape<HD>::kRow];
  float k[kChunk][Shape<HD>::kRow];
  float w[kChunk][Shape<HD>::kRow];
  float v[kChunk][kCols];
};

// Start the copies of `len` steps from element `first` (step stride `step`)
// into `st`: the head's rows of r, k and w, and the block's columns of v
// (which start at column `col0`), coalesced across the block, W floats a
// copy (4 when every operand is 16-byte aligned).
template <int HD, int W>
__device__ __forceinline__ void stage_chunk(Stage<HD>& st, const float* r,
                                            const float* k, const float* w,
                                            const float* v, size_t first,
                                            size_t step, int len, int col0) {
  constexpr int kThreads = Shape<HD>::kThreads;
  for (int e = threadIdx.x; e < len * (HD / W); e += kThreads) {
    const int tt = e / (HD / W);
    const int i = e % (HD / W) * W;
    const size_t off = first + tt * step + i;
    const int p = padded(i);
    copy_async<W>(&st.r[tt][p], r + off);
    copy_async<W>(&st.k[tt][p], k + off);
    copy_async<W>(&st.w[tt][p], w + off);
  }
  for (int e = threadIdx.x; e < len * (kCols / W); e += kThreads) {
    const int tt = e / (kCols / W);
    const int c = e % (kCols / W) * W;
    copy_async<W>(&st.v[tt][c], v + first + tt * step + col0 + c);
  }
  commit_copies();
}

// G consecutive steps of a chunk from step tt0: this lane's state values
// updated, and o_t[j] of each step written (by the column's first lane) to
// o_col[t * step].  The G steps' products come first and their sums after,
// so that the G sums' shuffles are in flight together; the state's own
// chain is two operations a step.
template <int HD, int G>
__device__ __forceinline__ void steps(const Stage<HD>& cur, int tt0,
                                      float (&col)[kVals],
                                      const float (&uu)[kVals], int lane_col,
                                      int p0, int sub, float* o_col,
                                      size_t step) {
  float part[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int tt = tt0 + g;
    const float vj = cur.v[tt][lane_col];
    float rr[kVals], kk[kVals], ww[kVals], term[kVals];
    load_vals(rr, &cur.r[tt][p0]);
    load_vals(kk, &cur.k[tt][p0]);
    load_vals(ww, &cur.w[tt][p0]);
#pragma unroll
    for (int q = 0; q < kVals; ++q) {
      const float kv = __fmul_rn(kk[q], vj);
      const float att = __fadd_rn(col[q], __fmul_rn(uu[q], kv));
      term[q] = __fmul_rn(rr[q], att);
      col[q] = __fadd_rn(__fmul_rn(col[q], ww[q]), kv);
    }
    part[g] = tree_sum<0, kVals>(term);
  }
#pragma unroll
  for (int x = 1; x < Shape<HD>::kLanes; x <<= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      part[g] = __fadd_rn(part[g], __shfl_xor_sync(0xffffffffu, part[g], x));
  }
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) o_col[(tt0 + g) * step] = part[g];
  }
}

template <int HD, int W>
__global__ void __launch_bounds__(Shape<HD>::kThreads)
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, float* __restrict__ state,
                float* __restrict__ o, float* __restrict__ ckpt, int s,
                int h) {
  using Sh = Shape<HD>;
  __shared__ Stage<HD> stage[2];
  const int bh = blockIdx.x / Sh::kSplit;  // b * h + head
  const int col0 = (blockIdx.x - bh * Sh::kSplit) * kCols;
  const int b = bh / h;
  const int head = bh - b * h;
  const int lane_col = threadIdx.x / Sh::kLanes;  // column within the block
  const int sub = threadIdx.x % Sh::kLanes;       // which range of i
  const int j = col0 + lane_col;                  // column of S
  const int i0 = sub * kVals;                     // first i of the range
  const int p0 = padded(i0);
  float col[kVals];  // S[i0 + q][j]
  float uu[kVals];   // u[i0 + q]
  float* s_blk = state + static_cast<size_t>(bh) * HD * HD;
#pragma unroll
  for (int q = 0; q < kVals; ++q) {
    col[q] = s_blk[(i0 + q) * HD + j];
    uu[q] = u[static_cast<size_t>(head) * HD + i0 + q];
  }
  const size_t step = static_cast<size_t>(h) * HD;  // floats between steps
  const size_t base = static_cast<size_t>(b) * s * step +
                      static_cast<size_t>(head) * HD;

  // checkpoint n of this block's columns: the state before step 16 n
  float* ck_col = nullptr;
  if (ckpt != nullptr)
    ck_col = ckpt + static_cast<size_t>(bh) * (s / kChunk + 1) * HD * HD +
             static_cast<size_t>(i0) * HD + j;

  stage_chunk<HD, W>(stage[0], r, k, w, v, base, step, min(kChunk, s), col0);
  for (int t0 = 0, buf = 0; t0 < s; t0 += kChunk, buf ^= 1) {
    const int len = min(kChunk, s - t0);
    if (ck_col != nullptr) {
      float* dst = ck_col + static_cast<size_t>(t0 / kChunk) * HD * HD;
#pragma unroll
      for (int q = 0; q < kVals; ++q) dst[q * HD] = col[q];
    }
    if (t0 + kChunk < s) {
      // the next chunk's copies run while this one is computed
      stage_chunk<HD, W>(stage[buf ^ 1], r, k, w, v,
                         base + (t0 + kChunk) * step, step,
                         min(kChunk, s - t0 - kChunk), col0);
      wait_copies<1>();
    } else {
      wait_copies<0>();
    }
    __syncthreads();  // this chunk, staged by all, is in
    const Stage<HD>& cur = stage[buf];
    float* o_col = o + base + t0 * step + j;
    if (len == kChunk) {
#pragma unroll
      for (int tt = 0; tt < kChunk; tt += kGroup)
        steps<HD, kGroup>(cur, tt, col, uu, lane_col, p0, sub, o_col, step);
    } else {
      for (int tt = 0; tt < len; ++tt)
        steps<HD, 1>(cur, tt, col, uu, lane_col, p0, sub, o_col, step);
    }
    __syncthreads();  // nobody reads this buffer when it is staged again
  }
#pragma unroll
  for (int q = 0; q < kVals; ++q) s_blk[(i0 + q) * HD + j] = col[q];
  if (ck_col != nullptr && s % kChunk == 0) {
    float* dst = ck_col + static_cast<size_t>(s / kChunk) * HD * HD;
#pragma unroll
    for (int q = 0; q < kVals; ++q) dst[q * HD] = col[q];
  }
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, float* state, float* o, float* ckpt, int batch,
           int s, int h, cudaStream_t stream) {
  using Sh = Shape<HD>;
  const int blocks = batch * h * Sh::kSplit;
  const bool aligned = ((reinterpret_cast<uintptr_t>(r) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  if (aligned)
    wkv6_kernel<HD, 4><<<blocks, Sh::kThreads, 0, stream>>>(
        r, k, v, w, u, state, o, ckpt, s, h);
  else
    wkv6_kernel<HD, 1><<<blocks, Sh::kThreads, 0, stream>>>(
        r, k, v, w, u, state, o, ckpt, s, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k, v, w, o [batch, s, h, hd]; u [h, hd]; state [batch, h, hd, hd];
// ckpt [batch, h, s / 16 + 1, hd, hd] or null; all float32, contiguous, on
// the device of `stream`.  hd is 16 or 64.  Returns the cudaError_t of the
// launch (0: launched).
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, void* state, void* o,
                           void* ckpt, int batch, int s, int h, int hd,
                           void* stream) {
  if (batch <= 0 || s <= 0 || h <= 0 ||
      static_cast<long long>(batch) * h * (hd / kCols) > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* rp = static_cast<const float*>(r);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* wp = static_cast<const float*>(w);
  const auto* up = static_cast<const float*>(u);
  auto* sp = static_cast<float*>(state);
  auto* op = static_cast<float*>(o);
  auto* cp = static_cast<float*>(ckpt);
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(rp, kp, vp, wp, up, sp, op, cp, batch, s, h, st);
    case 64:
      return launch<64>(rp, kp, vp, wp, up, sp, op, cp, batch, s, h, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
