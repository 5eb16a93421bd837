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
// What bounds it: on paper, the float operations (14 a state value and
// step: the recomputed step, 4 products and their sums, the gradient's
// step) and the bytes (9 arrays of B S H hd read or written, the
// checkpoints and the dv partials) are of one order.  In practice, as in
// the forward, instruction issue and latency: the steps are a dependent
// chain, backwards, and most of the work sums over i or over j.  The design:
//   * the layout is the forward's turned over: a ROW i of the head's state
//     is held by kLanes neighbouring lanes of one warp (8 at hd 64, 2 at hd
//     16), lane l owning G[i][j] for the kVals = 8 contiguous j in
//     [8l, 8l + 8), in registers; a block holds kRows = 16 rows of one head
//     (128 threads at hd 64), a head is hd / 16 blocks.  Three of the four
//     sums (dk, dr, dw: over j) are then a lane's own 8 values and the
//     shuffles of a row's lanes, as the forward's o; only dv sums over the
//     rows, across lanes, warps and blocks;
//   * the block walks the checkpoints' chunks of 16 steps from the last:
//     it stages the chunk's r, k, w, v and do of the whole head in shared
//     memory (cp.async, 16 bytes a copy when every operand is 16-byte
//     aligned, else 4), reads the checkpoint before the chunk into
//     registers, recomputes the chunk's states P_t with the forward's own
//     operations (so their bits are the forward's) into shared memory, a
//     thread's own 8 values a step, and then runs the 16 steps backwards;
//   * a_t and b_t are summed once a step by the block, 16 steps at a time;
//   * dv's sum over a warp's rows is a reduce-scatter: at each xor level a
//     lane hands its partner half of the values it holds and adds the
//     partner's half of the ones it keeps (8, then 4, then 2 values at hd
//     64); each warp's sums go to shared memory, the block adds its warps'
//     and writes one float32 partial a block; a second small pass adds the
//     hd / 16 blocks' partials and do_t[j] b_t, and sums du's per-batch
//     partials.  No float atomics: two launches give the same bits.
// Every sum is the pairwise tree, level by level, of the plain version's
// tree_sum (kernels/selective_scan/ref.py), over the 64 (or 16) values:
// a lane's 8 values, then its neighbours' at xor 1, 2, 4 for a row; rows
// pair by xor kLanes, 2 kLanes, ..., then warps, then blocks, for dv.
// Every float operation is an intrinsic (__fmul_rn, __fadd_rn), so nvcc
// contracts nothing into FMAs.  The head size is a template parameter: 64
// (rwkv6-1.6b) and 16 (its smoke config); the launcher refuses any other.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kChunk = 16;  // steps between two checkpoints (the forward's)
constexpr int kVals = 8;    // state values (value indices j) a lane holds
constexpr int kRows = 16;   // rows (key indices i) of a head a block holds

template <int HD>
struct Shape {
  static_assert((HD & (HD - 1)) == 0 && HD >= kRows,
                "the head size is a power of two, at least kRows");
  static constexpr int kLanes = HD / kVals;        // lanes a row
  static constexpr int kThreads = kRows * kLanes;  // threads a block
  static constexpr int kWarps = kThreads / 32;     // warps a block
  static constexpr int kSplit = HD / kRows;        // blocks a head
  static constexpr int kRow = HD + HD / 32 * 4;    // a padded shared row
  static_assert(kThreads % 32 == 0 && 32 % kLanes == 0, "whole warps");
};

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
__device__ __forceinline__ void commit_and_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// the pairwise tree over v[Lo, Lo + Len), as the forward's
template <int Lo, int Len, int N>
__device__ __forceinline__ float tree_sum(const float (&v)[N]) {
  if constexpr (Len == 1) {
    return v[Lo];
  } else {
    return __fadd_rn(tree_sum<Lo, Len / 2>(v),
                     tree_sum<Lo + Len / 2, Len / 2>(v));
  }
}

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

// Sums v over the lanes that differ from this one in the bits M, 2 M, ...,
// 16 of the lane index, in that order (the pairwise tree over them).  While
// this lane holds more than one value (Cnt), each level hands the partner
// half of them and adds the partner's half of the ones kept, which move to
// v[0, Cnt / 2); `off` grows by the index of the first one kept.  Once one
// value is left, the levels add it whole (both lanes then hold the sum).
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

// values a lane holds after scatter_sum from Cnt values at bit M
__host__ __device__ constexpr int scattered(int cnt, int m) {
  return m >= 32 ? cnt : scattered(cnt > 1 ? cnt / 2 : 1, 2 * m);
}

template <int HD>
struct __align__(16) Smem {
  using Sh = Shape<HD>;
  float r[kChunk][Sh::kRow];
  float k[kChunk][Sh::kRow];
  float w[kChunk][Sh::kRow];
  float v[kChunk][Sh::kRow];
  float dout[kChunk][Sh::kRow];
  float u[HD];
  float a[kChunk];   // v_t . do_t
  float b[kChunk];   // sum over i of u[i] r_t[i] k_t[i]
  // the state before each step of the chunk, a thread's 8 values
  float hist[kChunk][kVals][Sh::kThreads];
  // each warp's dv sums over its rows
  float dvp[kChunk][Sh::kWarps][HD];
};

template <int HD, int W>
__device__ __forceinline__ void stage_chunk(Smem<HD>& sm, const float* r,
                                            const float* k, const float* w,
                                            const float* v, const float* dout,
                                            size_t first, size_t step,
                                            int len) {
  constexpr int kThreads = Shape<HD>::kThreads;
  for (int e = threadIdx.x; e < len * (HD / W); e += kThreads) {
    const int tt = e / (HD / W);
    const int i = e % (HD / W) * W;
    const size_t off = first + tt * step + i;
    const int p = padded(i);
    copy_async<W>(&sm.r[tt][p], r + off);
    copy_async<W>(&sm.k[tt][p], k + off);
    copy_async<W>(&sm.w[tt][p], w + off);
    copy_async<W>(&sm.v[tt][p], v + off);
    copy_async<W>(&sm.dout[tt][p], dout + off);
  }
  commit_and_wait_all();
}

template <int HD, int W>
__global__ void __launch_bounds__(Shape<HD>::kThreads)
    wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u,
                    const float* __restrict__ ckpt,
                    const float* __restrict__ dout,
                    const float* __restrict__ dstate,
                    float* __restrict__ dr, float* __restrict__ dk,
                    float* __restrict__ dw, float* __restrict__ dv_part,
                    float* __restrict__ b_sum, float* __restrict__ du_part,
                    float* __restrict__ dstate0, int s, int h, int batch) {
  using Sh = Shape<HD>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<HD>& sm = *reinterpret_cast<Smem<HD>*>(smem_raw);
  const int bh = blockIdx.x / Sh::kSplit;  // b * h + head
  const int split = blockIdx.x - bh * Sh::kSplit;
  const int b = bh / h;
  const int head = bh - b * h;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int lane_row = tid / Sh::kLanes;  // row within the block
  const int sub = tid % Sh::kLanes;       // which range of j
  const int i = split * kRows + lane_row; // row of the state
  const int j0 = sub * kVals;             // first j of the range
  const int pj0 = padded(j0);             // 8 values never cross 32
  const int pi = padded(i);
  const size_t step = static_cast<size_t>(h) * HD;  // floats between steps
  const size_t base = static_cast<size_t>(b) * s * step +
                      static_cast<size_t>(head) * HD;
  const size_t total = static_cast<size_t>(batch) * s * step;
  const int n_ck = s / kChunk + 1;
  for (int e = tid; e < HD; e += Sh::kThreads)
    sm.u[e] = u[static_cast<size_t>(head) * HD + e];
  const float ui = u[static_cast<size_t>(head) * HD + i];
  const size_t row_off = (static_cast<size_t>(bh) * HD + i) * HD + j0;
  float g[kVals];  // G[i][j0 + q]: the gradient of the state after the step
#pragma unroll
  for (int q = 0; q < kVals; ++q) g[q] = dstate[row_off + q];
  float du_acc = 0.f;
  const float* ck_row = ckpt + static_cast<size_t>(bh) * n_ck * HD * HD +
                        static_cast<size_t>(i) * HD + j0;

  for (int n = (s + kChunk - 1) / kChunk - 1; n >= 0; --n) {
    const int t0 = n * kChunk;
    const int len = min(kChunk, s - t0);
    __syncthreads();  // nobody reads the last chunk's stage or dv sums
    stage_chunk<HD, W>(sm, r, k, w, v, dout, base + t0 * step, step, len);
    float p[kVals];  // the state before step t0 + tt, from the checkpoint
    load_vals(p, ck_row + static_cast<size_t>(n) * HD * HD);
    __syncthreads();  // the chunk, staged by all, is in
    {
      // a_t and b_t of step tt = lane_row (kRows == kChunk): a row's lanes
      // each sum 8 products, then add their neighbours' sums; every lane
      // takes part in the shuffles, and steps past the chunk store nothing
      const int tt = lane_row;
      float pa[kVals], pb[kVals];
#pragma unroll
      for (int q = 0; q < kVals; ++q) {
        pa[q] = __fmul_rn(sm.v[tt][pj0 + q], sm.dout[tt][pj0 + q]);
        pb[q] = __fmul_rn(__fmul_rn(sm.u[j0 + q], sm.r[tt][pj0 + q]),
                          sm.k[tt][pj0 + q]);
      }
      float sa = tree_sum<0, kVals>(pa), sb = tree_sum<0, kVals>(pb);
#pragma unroll
      for (int x = 1; x < Sh::kLanes; x <<= 1) {
        sa = __fadd_rn(sa, __shfl_xor_sync(0xffffffffu, sa, x));
        sb = __fadd_rn(sb, __shfl_xor_sync(0xffffffffu, sb, x));
      }
      if (sub == 0 && tt < len) {
        sm.a[tt] = sa;
        sm.b[tt] = sb;
        if (split == 0)
          b_sum[(static_cast<size_t>(b) * s + t0 + tt) * h + head] = sb;
      }
    }
    // the chunk's states, by the forward's operations
    for (int tt = 0; tt < len; ++tt) {
      const float wi = sm.w[tt][pi];
      const float ki = sm.k[tt][pi];
      float vv[kVals];
      load_vals(vv, &sm.v[tt][pj0]);
#pragma unroll
      for (int q = 0; q < kVals; ++q) {
        sm.hist[tt][q][tid] = p[q];
        p[q] = __fadd_rn(__fmul_rn(p[q], wi), __fmul_rn(ki, vv[q]));
      }
    }
    __syncthreads();  // a_t and b_t are in
    for (int tt = len - 1; tt >= 0; --tt) {
      const float ri = sm.r[tt][pi];
      const float ki = sm.k[tt][pi];
      const float wi = sm.w[tt][pi];
      float vv[kVals], dd[kVals], xk[kVals], xr[kVals], xw[kVals], y[kVals];
      load_vals(vv, &sm.v[tt][pj0]);
      load_vals(dd, &sm.dout[tt][pj0]);
#pragma unroll
      for (int q = 0; q < kVals; ++q) {
        const float pq = sm.hist[tt][q][tid];
        xk[q] = __fmul_rn(vv[q], g[q]);
        xr[q] = __fmul_rn(dd[q], pq);
        xw[q] = __fmul_rn(g[q], pq);
        y[q] = __fmul_rn(ki, g[q]);
        g[q] = __fadd_rn(__fmul_rn(wi, g[q]), __fmul_rn(ri, dd[q]));
      }
      float sk = tree_sum<0, kVals>(xk), sr = tree_sum<0, kVals>(xr),
            sw = tree_sum<0, kVals>(xw);
#pragma unroll
      for (int x = 1; x < Sh::kLanes; x <<= 1) {
        sk = __fadd_rn(sk, __shfl_xor_sync(0xffffffffu, sk, x));
        sr = __fadd_rn(sr, __shfl_xor_sync(0xffffffffu, sr, x));
        sw = __fadd_rn(sw, __shfl_xor_sync(0xffffffffu, sw, x));
      }
      // dv over the warp's rows
      int off = 0;
      scatter_sum<kVals, Sh::kLanes>(y, lane, off);
      constexpr int kKept = scattered(kVals, Sh::kLanes);
#pragma unroll
      for (int q = 0; q < kKept; ++q) sm.dvp[tt][warp][j0 + off + q] = y[q];
      if (sub == 0) {
        const float a = sm.a[tt];
        const size_t o = base + (t0 + tt) * step + i;
        dk[o] = __fadd_rn(sk, __fmul_rn(__fmul_rn(ui, ri), a));
        dr[o] = __fadd_rn(sr, __fmul_rn(__fmul_rn(ui, ki), a));
        dw[o] = sw;
        du_acc = __fadd_rn(du_acc, __fmul_rn(__fmul_rn(ri, ki), a));
      }
    }
    __syncthreads();  // every warp's dv sums are in
    // the block's dv partial: its warps' sums in the pairwise tree
    float* part = dv_part + split * total + base + t0 * step;
    for (int e = tid; e < len * HD; e += Sh::kThreads) {
      const int tt = e / HD;
      const int j = e - tt * HD;
      float ws[Sh::kWarps];
#pragma unroll
      for (int x = 0; x < Sh::kWarps; ++x) ws[x] = sm.dvp[tt][x][j];
      part[tt * step + j] = tree_sum<0, Sh::kWarps>(ws);
    }
  }
#pragma unroll
  for (int q = 0; q < kVals; ++q) dstate0[row_off + q] = g[q];
  if (sub == 0)
    du_part[(static_cast<size_t>(b) * h + head) * HD + i] = du_acc;
}

// dv: the blocks' partials in the pairwise tree, plus do_t[j] b_t; du: the
// batch rows' partials in order
template <int HD>
__global__ void wkv6_bwd_finish(const float* __restrict__ dv_part,
                                const float* __restrict__ b_sum,
                                const float* __restrict__ dout,
                                const float* __restrict__ du_part,
                                float* __restrict__ dv, float* __restrict__ du,
                                size_t total, int h, int batch) {
  constexpr int kSplit = Shape<HD>::kSplit;
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e < total) {
    float p[kSplit];
#pragma unroll
    for (int x = 0; x < kSplit; ++x) p[x] = dv_part[x * total + e];
    dv[e] = __fadd_rn(tree_sum<0, kSplit>(p), __fmul_rn(dout[e],
                                                        b_sum[e / HD]));
  }
  const size_t hh = static_cast<size_t>(h) * HD;
  if (e < hh) {
    float acc = 0.f;
    for (int b = 0; b < batch; ++b) acc = __fadd_rn(acc, du_part[b * hh + e]);
    du[e] = acc;
  }
}

template <int HD>
size_t workspace_floats(int batch, int s, int h) {
  const size_t total = static_cast<size_t>(batch) * s * h * HD;
  return Shape<HD>::kSplit * total + static_cast<size_t>(batch) * s * h +
         static_cast<size_t>(batch) * h * HD;
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* ckpt, const float* dout,
           const float* dstate, float* dr, float* dk, float* dv, float* dw,
           float* du, float* dstate0, float* work, int batch, int s, int h,
           cudaStream_t stream) {
  using Sh = Shape<HD>;
  const size_t total = static_cast<size_t>(batch) * s * h * HD;
  float* dv_part = work;
  float* b_sum = dv_part + Sh::kSplit * total;
  float* du_part = b_sum + static_cast<size_t>(batch) * s * h;
  const bool aligned = ((reinterpret_cast<uintptr_t>(r) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(dout)) & 15) == 0;
  auto kernel =
      aligned ? &wkv6_bwd_kernel<HD, 4> : &wkv6_bwd_kernel<HD, 1>;
  const int smem = static_cast<int>(sizeof(Smem<HD>));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch * h * Sh::kSplit, Sh::kThreads, smem, stream>>>(
      r, k, v, w, u, ckpt, dout, dstate, dr, dk, dw, dv_part, b_sum, du_part,
      dstate0, s, h, batch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = total > static_cast<size_t>(h) * HD
                       ? total : static_cast<size_t>(h) * HD;
  constexpr int kFinish = 256;
  wkv6_bwd_finish<HD><<<static_cast<unsigned>((n + kFinish - 1) / kFinish),
                        kFinish, 0, stream>>>(dv_part, b_sum, dout, du_part,
                                              dv, du, total, h, batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of the scratch `work` that wkv6_bwd_launch needs (0: refused).
extern "C" long long wkv6_bwd_workspace(int batch, int s, int h, int hd) {
  switch (hd) {
    case 16:
      return 4LL * static_cast<long long>(workspace_floats<16>(batch, s, h));
    case 64:
      return 4LL * static_cast<long long>(workspace_floats<64>(batch, s, h));
    default:
      return 0;
  }
}

// r, k, v, w, dout, dr, dk, dv, dw [batch, s, h, hd]; u, du [h, hd]; ckpt
// [batch, h, s / 16 + 1, hd, hd] as wkv6_launch wrote it; dstate, dstate0
// [batch, h, hd, hd]; work of wkv6_bwd_workspace bytes; all float32,
// contiguous, on the device of `stream`.  hd is 16 or 64.  Two launches
// (the scan, then the sums over blocks and batch rows).  Returns the
// cudaError_t of the launches (0: launched).
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* ckpt,
                               const void* dout, const void* dstate, void* dr,
                               void* dk, void* dv, void* dw, void* du,
                               void* dstate0, void* work, int batch, int s,
                               int h, int hd, void* stream) {
  if (batch <= 0 || s <= 0 || h <= 0 ||
      static_cast<long long>(batch) * h * (hd / kRows) > 2147483647LL)
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
      return launch<16>(rp, kp, vp, wp, up, cp, op, sp, o_r, o_k, o_v, o_w,
                        o_u, o_s, wk, batch, s, h, st);
    case 64:
      return launch<64>(rp, kp, vp, wp, up, cp, op, sp, o_r, o_k, o_v, o_w,
                        o_u, o_s, wk, batch, s, h, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* wkv6_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
