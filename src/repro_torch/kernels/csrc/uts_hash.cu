// UTS on the card: the SHA-1 child digest (`uts_hash`) and the fused,
// persistent traversal of a whole task (`uts_expand`).
//
// Replaces the Pallas kernel `_uts_hash_kernel` (src/repro/kernels/uts_hash/
// kernel.py, wrapped by `uts_hash_pallas`, registered as op `uts_hash`).
//
// What both compute per node: for parent digest p and child index k,
// SHA1(p || be32(k)).  The 24-byte message fits one 64-byte block after
// padding, so the digest is one 80-round compression of the block
//   w0..w4 = parent words, w5 = child index, w6 = 0x80000000 (pad bit),
//   w7..w14 = 0, w15 = 192 (message length in bits).
//
// Layout: digests [5, N] word-major (row i holds word i of every node),
// depths and indices [N].  The tensors are int32 on the PyTorch side
// (PyTorch has no usable uint32 arithmetic); the kernels read the same bits
// as uint32_t.
//
// -- uts_hash_kernel ---------------------------------------------------------
//
// One thread per message: lanes never communicate, every load and store of a
// row is coalesced.  What bounds it: integer ALU work, 640 SASS instructions
// a lane for sm_90a (577 of them on the INT32 pipe, which has half the
// float32 pipe's lanes) against 44 bytes of traffic.  The message schedule is
// a 16-word window and all 80 rounds are unrolled, so every index into the
// window is a compile-time constant and the window lives in registers;
// rotates are `__funnelshift_l`, one instruction each.
//
// -- uts_expand_kernel -------------------------------------------------------
//
// The whole `expand_bag` loop of one task (the plain version is
// `uts_expand_ref` in kernels/uts_hash/ref.py), bit for bit, in one
// cooperative launch.  A work buffer holds the LIFO stack, digests
// [5, cap] and depths [cap], with the bag at [0, S).  Each generation:
//   take = min(S, iters - count, chunk) head nodes [cut, S), cut = S - take;
//   their child counts (the threshold table: count = #{t : u31 < t}, 0 at
//   max_depth); an exclusive scan of the counts -> offsets and total;
//   if cut + total > cap, stop with this generation undone (the host grows
//   the buffer and relaunches; the result cannot tell);
//   child j of parent p = the last p with off[p] <= j, index k = j - off[p],
//   written at cut + j: parent-major, child index minor;
//   count += take, S = cut + total.
//
// Design:
// * The grid stays resident (one block of 1024 threads per SM) and walks
//   the generations with one grid barrier (`cooperative_groups`) each.
// * The head of the current generation is staged in a scratch `head`
//   buffer [7, chunk] (5 digest words, depth, child count), two of them in
//   turn.  The children overwrite the parents' slots of the stack, so the
//   parents are read from the head buffer only; the threads that write a
//   child that falls in the next generation's head, and the threads that
//   copy the older nodes below `cut` that fall in it, fill the other head
//   buffer in the same pass.  So reading every parent before any child is
//   written costs no barrier of its own.
// * A node's child count is computed once, by the thread that puts it in a
//   head buffer, and stored there.
// * Every block computes the scan of the take counts redundantly into its
//   own shared memory (chunk * 4 bytes, 32 KB at the main path's chunk of
//   8192), so all blocks know total, the next S and the next head without
//   a second barrier, and each finds its children's parents by a binary
//   search in shared memory.  The threshold table sits in shared memory too.
// * Blocks take contiguous ranges of the children, so a generation of some
//   32,000 children spreads over every SM and each warp's writes coalesce.
//
// What bounds it on the H100: the serial chain of generations (a depth-14
// tree of 117,669,204 nodes is 14,373 generations of at most 8,192
// parents, each a scan, a hash pass and a grid barrier), far above the 48
// bytes a node of memory traffic (24 B written as a child, 24 B read as a
// parent) and SHA-1's integer instructions over the whole tree.  Within a
// generation the fixed part sets the time: on an H100 at 700 W a
// generation of leaves, which hashes nothing, takes 5.8 us, one of 8,192
// parents and their some 32,000 children 5.9 us.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kH0 = 0x67452301u;
constexpr uint32_t kH1 = 0xEFCDAB89u;
constexpr uint32_t kH2 = 0x98BADCFEu;
constexpr uint32_t kH3 = 0x10325476u;
constexpr uint32_t kH4 = 0xC3D2E1F0u;

constexpr int kThreads = 128;

// uts_expand: block size, blocks per SM, largest threshold table
constexpr int kExpandThreads = 1024;
constexpr int kExpandBlocksPerSm = 1;
constexpr int kMaxTable = 256;
// head buffer rows: digest words 0..4, depth, child count
constexpr int kHeadRows = 7;
// state words written at the end of a launch
enum { kCount = 0, kSize = 1, kGenerations = 2, kStatus = 3 };
enum { kDone = 0, kCapacity = 1 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

// out = SHA1(parent[0..4] || be32(ix))
__device__ __forceinline__ void sha1_child(const uint32_t parent[5],
                                           uint32_t ix, uint32_t out[5]) {
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 5; ++i) w[i] = parent[i];
  w[5] = ix;
  w[6] = 0x80000000u;
#pragma unroll
  for (int i = 7; i < 15; ++i) w[i] = 0u;
  w[15] = 24u * 8u;

  uint32_t a = kH0, b = kH1, c = kH2, d = kH3, e = kH4;
#pragma unroll
  for (int i = 0; i < 80; ++i) {
    uint32_t wi;
    if (i < 16) {
      wi = w[i];
    } else {
      wi = rotl(w[(i - 3) & 15] ^ w[(i - 8) & 15] ^ w[(i - 14) & 15] ^
                    w[i & 15], 1);
      w[i & 15] = wi;
    }
    uint32_t f, k;
    if (i < 20) {
      f = (b & c) | (~b & d);
      k = 0x5A827999u;
    } else if (i < 40) {
      f = b ^ c ^ d;
      k = 0x6ED9EBA1u;
    } else if (i < 60) {
      f = (b & c) | (b & d) | (c & d);
      k = 0x8F1BBCDCu;
    } else {
      f = b ^ c ^ d;
      k = 0xCA62C1D6u;
    }
    const uint32_t t = rotl(a, 5) + f + e + k + wi;
    e = d;
    d = c;
    c = rotl(b, 30);
    b = a;
    a = t;
  }
  out[0] = a + kH0;
  out[1] = b + kH1;
  out[2] = c + kH2;
  out[3] = d + kH3;
  out[4] = e + kH4;
}

__global__ void __launch_bounds__(kThreads)
uts_hash_kernel(const uint32_t* __restrict__ parent,
                const uint32_t* __restrict__ child_ix,
                uint32_t* __restrict__ out, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const size_t stride = static_cast<size_t>(n);
  uint32_t p[5], h[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) p[i] = parent[i * stride + j];
  sha1_child(p, child_ix[j], h);
#pragma unroll
  for (int i = 0; i < 5; ++i) out[i * stride + j] = h[i];
}

// -- uts_expand --------------------------------------------------------------

// Children of a node: #{t in table : u31 < t} (the table ascends), 0 at or
// past max_depth; u31 = (word0 >> 1) & 0x7fffffff.
__device__ __forceinline__ int child_count(uint32_t w0, int depth,
                                           const int* table, int n_table,
                                           int max_depth) {
  if (depth >= max_depth) return 0;
  const int u31 = static_cast<int>((w0 >> 1) & 0x7fffffffu);
  int lo = 0, hi = n_table;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (table[mid] <= u31) lo = mid + 1; else hi = mid;
  }
  return n_table - lo;
}

__device__ __forceinline__ void put_head(uint32_t* head, int chunk, int i,
                                         const uint32_t dig[5], int depth,
                                         int count) {
#pragma unroll
  for (int w = 0; w < 5; ++w) head[w * chunk + i] = dig[w];
  head[5 * chunk + i] = static_cast<uint32_t>(depth);
  head[6 * chunk + i] = static_cast<uint32_t>(count);
}

// Exclusive scan of cnt[0..n) into s_off (shared), by this block alone;
// returns the sum.  Each warp scans a contiguous segment 32 values at a
// time (shuffles, a running carry), then every value gets its warp's base.
// s_warp holds 33 ints.
__device__ int block_exclusive_scan(const uint32_t* cnt, int n, int* s_off,
                                    int* s_warp) {
  constexpr int kUnroll = 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int seg = ((n + nwarps - 1) / nwarps + 31) & ~31;
  const int lo = warp * seg, hi = min(n, lo + seg);
  int carry = 0;
  for (int base = lo; base < hi; base += 32 * kUnroll) {
    int c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + 32 * u + lane;
      c[u] = i < hi ? static_cast<int>(cnt[i]) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int x = c[u];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      const int i = base + 32 * u + lane;
      if (i < hi) s_off[i] = carry + x - c[u];
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
  }
  if (lane == 0) s_warp[warp] = carry;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < nwarps ? s_warp[lane] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane < nwarps) s_warp[lane] = x - v;
    if (lane == 31) s_warp[32] = x;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s_off[i] += s_warp[i / seg];
  const int total = s_warp[32];
  __syncthreads();
  return total;
}

// Nodes the generation after (count, S) takes: 0 when the budget is spent
// or the stack is empty.
__device__ __forceinline__ long long take_of(long long s, long long count,
                                             long long iters, int chunk) {
  if (count >= iters || s == 0) return 0;
  return min(min(s, iters - count), static_cast<long long>(chunk));
}

// dig [5, cap] and dep [cap] hold the bag at [0, s); head0 and head1 are
// [7, chunk] scratch; state receives count, S, generations and status.
// Launched cooperatively with kExpandThreads threads a block and chunk * 4
// bytes of dynamic shared memory.
__global__ void __launch_bounds__(kExpandThreads)
uts_expand_kernel(uint32_t* dig, int* dep, long long cap, long long s,
                  long long iters, int chunk, int max_depth,
                  const int* __restrict__ table, int n_table,
                  uint32_t* head0, uint32_t* head1, long long* state) {
  extern __shared__ int s_off[];
  __shared__ int s_table[kMaxTable];
  __shared__ int s_warp[33];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const long long gid = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
  const long long gthreads = static_cast<long long>(gridDim.x) * blockDim.x;
  for (int i = tid; i < n_table; i += blockDim.x) s_table[i] = table[i];
  __syncthreads();

  // the first generation's head, from the stack
  long long count = 0, gens = 0;
  int status = kDone;
  long long take = take_of(s, count, iters, chunk);
  for (long long pos = s - take + gid; pos < s; pos += gthreads) {
    uint32_t d[5];
#pragma unroll
    for (int w = 0; w < 5; ++w) d[w] = dig[w * cap + pos];
    const int depth = dep[pos];
    put_head(head0, chunk, static_cast<int>(pos - (s - take)), d, depth,
             child_count(d[0], depth, s_table, n_table, max_depth));
  }
  grid.sync();

  uint32_t* cur = head0;
  uint32_t* nxt = head1;
  while (take > 0) {
    const long long cut = s - take;
    const int n = static_cast<int>(take);
    const int total = block_exclusive_scan(cur + 6 * chunk, n, s_off, s_warp);
    if (cut + total > cap) {
      status = kCapacity;
      break;
    }
    const long long count_n = count + take, s_n = cut + total;
    const long long take_n = take_of(s_n, count_n, iters, chunk);
    const long long cut_n = s_n - take_n;

    // children, a contiguous range per block
    const int per_block = (total + gridDim.x - 1) / gridDim.x;
    const int j0 = blockIdx.x * per_block;
    const int j1 = min(total, j0 + per_block);
    for (int j = j0 + tid; j < j1; j += blockDim.x) {
      int lo = 0, hi = n;  // the last p with s_off[p] <= j
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_off[mid] <= j) lo = mid + 1; else hi = mid;
      }
      const int p = lo - 1;
      uint32_t par[5], c[5];
#pragma unroll
      for (int w = 0; w < 5; ++w) par[w] = cur[w * chunk + p];
      const int depth = static_cast<int>(cur[5 * chunk + p]) + 1;
      sha1_child(par, static_cast<uint32_t>(j - s_off[p]), c);
      const long long pos = cut + j;
#pragma unroll
      for (int w = 0; w < 5; ++w) dig[w * cap + pos] = c[w];
      dep[pos] = depth;
      if (pos >= cut_n)
        put_head(nxt, chunk, static_cast<int>(pos - cut_n), c, depth,
                 child_count(c[0], depth, s_table, n_table, max_depth));
    }
    // older nodes below cut that the next head reaches
    for (long long pos = cut_n + gid; pos < cut; pos += gthreads) {
      uint32_t d[5];
#pragma unroll
      for (int w = 0; w < 5; ++w) d[w] = dig[w * cap + pos];
      const int depth = dep[pos];
      put_head(nxt, chunk, static_cast<int>(pos - cut_n), d, depth,
               child_count(d[0], depth, s_table, n_table, max_depth));
    }
    count = count_n;
    s = s_n;
    take = take_n;
    ++gens;
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
    grid.sync();
  }
  if (blockIdx.x == 0 && tid == 0) {
    state[kCount] = count;
    state[kSize] = s;
    state[kGenerations] = gens;
    state[kStatus] = status;
  }
}

}  // namespace

// parent, out: [5, n] int32 (uint32 bits), child_ix: [n] int32; all on the
// device, contiguous.  Launches on `stream`; returns cudaGetLastError().
extern "C" int uts_hash_launch(const void* parent, const void* child_ix,
                               void* out, int n, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  uts_hash_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(parent),
      static_cast<const uint32_t*>(child_ix), static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// One cooperative launch of uts_expand_kernel on `stream`, one block per SM
// of the current device.  dig: [5, cap] int32, dep: [cap] int32 (the bag at
// [0, s)); table: [n_table] int32 ascending (n_table <= 256); head: [2, 7,
// chunk] int32 scratch; state: [4] int64 out.  Returns a cudaError_t: the
// launch's own, or cudaErrorInvalidValue for arguments the kernel does not
// take, or cudaErrorCooperativeLaunchTooLarge if a block does not fit on an
// SM.  Nothing else is tried.
extern "C" int uts_expand_launch(void* dig, void* dep, long long cap,
                                 long long s, long long iters, int chunk,
                                 int max_depth, const void* table,
                                 int n_table, void* head, void* state,
                                 void* stream) {
  if (s <= 0 || s > cap || iters <= 0 || chunk <= 0 || n_table < 0 ||
      n_table > kMaxTable)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0, per_sm = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(chunk) * sizeof(int);
  if (smem + sizeof(int) * (kMaxTable + 33) > static_cast<size_t>(smem_max))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(uts_expand_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, uts_expand_kernel, kExpandThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < kExpandBlocksPerSm)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  uint32_t* dig_p = static_cast<uint32_t*>(dig);
  int* dep_p = static_cast<int*>(dep);
  const int* table_p = static_cast<const int*>(table);
  uint32_t* head0 = static_cast<uint32_t*>(head);
  uint32_t* head1 = head0 + static_cast<size_t>(kHeadRows) * chunk;
  long long* state_p = static_cast<long long*>(state);
  void* args[] = {&dig_p, &dep_p, &cap, &s, &iters, &chunk, &max_depth,
                  &table_p, &n_table, &head0, &head1, &state_p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(uts_expand_kernel),
      dim3(sms * kExpandBlocksPerSm), dim3(kExpandThreads), args, smem,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int uts_expand_max_table() { return kMaxTable; }

extern "C" const char* uts_hash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
