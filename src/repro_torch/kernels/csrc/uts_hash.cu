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
// `uts_expand_ref` in kernels/uts_hash/ref.py), bit for bit, in one launch
// of one thread block cluster.  A work buffer in device memory holds the
// LIFO stack, digests [5, cap] and depths [cap], with the bag at [0, S).
// Each generation:
//   take = min(S, iters - count, chunk) head nodes [cut, S), cut = S - take;
//   their child counts (the threshold table: count = #{t : u31 < t}, 0 at
//   max_depth); an exclusive scan of the counts -> offsets and total;
//   if cut + total > cap, stop with this generation undone (the host grows
//   the buffer and relaunches; the result cannot tell);
//   child k of head node p is child j = off[p] + k, written at cut + j:
//   parent-major, child index minor;
//   count += take, S = cut + total.
//
// Design:
// * One task, one cluster: a launch is kCluster blocks of 1024 threads, one
//   an SM, so it takes kCluster SMs and not the card.  The pool's tasks,
//   each launched on its worker's own stream, run side by side.  A
//   generation ends at the cluster's barrier.
// * The head lives in the cluster's shared memory, never in device memory.
//   Its nodes are dealt to the blocks in groups of 32 (group q to block
//   q % kCluster), and a block keeps its slots' digest words, depth and
//   child count, in two buffers in turn.  Small groups dealt in turn keep
//   the blocks' children even: summed over a depth-11 tree's generations,
//   the busiest block's children come to 1.15 times the mean, where
//   contiguous slices of the head gave 1.98.
// * A block hashes the children of its own head nodes, so every parent is
//   read from the block's own shared memory, found by a binary search over
//   the block's exclusive offsets.  A child's index in the generation comes
//   from its group's base, an exclusive scan of every group's total (some
//   256 values at chunk 8192) that one warp of each block makes.  Every
//   block keeps every group's total, summed before the generation starts
//   by whoever writes a head node: one shared-memory atomic a warp, group
//   and block, through the cluster's distributed shared memory.  So a
//   generation reads nothing of another block, and has one block barrier
//   and one cluster barrier.  Two buffers of totals in turn: a block clears
//   the one it has read while the others add into the other.
// * The threads that write a child that falls in the next generation's
//   head also write it, with its child count, into its slot's block's other
//   head buffer; each block copies into its own slots the older stack
//   nodes that the next head reaches below the children.  The stack in
//   device memory is written once a child, and read (`ld.cg`, past L1) only
//   for the bag and for those older nodes.
//
// What bounds it on the H100: a generation of the main path (8,192 parents,
// some 8,192 children on average) hashes its children on the cluster's
// INT32 pipes, 64 lanes an SM, 577 INT32 instructions a child: some 4,600
// cycles at kCluster = 16, 2.3 us at 1.98 GHz; the rest is the fixed part
// (the totals' scan, the busiest block's tail, the cluster barrier).  On an
// H100 at 700 W the depth-14 tree alone takes 89.3 ms, 6.2 us a generation
// (the whole-card cooperative kernel this replaced: 85.4 ms, 5.9 us), and a
// generation of leaves, which hashes nothing, 3.6-4.0 us.  kCluster is 16
// (a non-portable size; 7 clusters fit on the card at once): with clusters
// of 8 (15 fit) the lone tree took 126 ms, 8.8 us a generation, while the
// elastic pool's UTS ran as fast with either.

#include <cooperative_groups.h>
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kH0 = 0x67452301u;
constexpr uint32_t kH1 = 0xEFCDAB89u;
constexpr uint32_t kH2 = 0x98BADCFEu;
constexpr uint32_t kH3 = 0x10325476u;
constexpr uint32_t kH4 = 0xC3D2E1F0u;

constexpr int kThreads = 128;

// uts_expand: blocks a cluster (one task), threads a block, largest
// threshold table, head nodes a group (a warp's)
constexpr int kCluster = 16;
constexpr int kExpandThreads = 1024;
constexpr int kMaxTable = 256;
constexpr int kGroup = 32;
// head rows: digest words 0..4, depth, child count
constexpr int kHeadRows = 7;
// buffers of group totals, in turn
constexpr int kTotals = 2;
// devices whose launch set-up is kept
constexpr int kMaxDevices = 64;
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

// Nodes the generation after (count, S) takes: 0 when the budget is spent
// or the stack is empty.
__device__ __forceinline__ long long take_of(long long s, long long count,
                                             long long iters, int chunk) {
  if (count >= iters || s == 0) return 0;
  return min(min(s, iters - count), static_cast<long long>(chunk));
}

// A block's shared memory at `chunk`: the groups of the largest head, the
// groups a block owns, its head slots.
struct Layout {
  int groups, own, slots;
  __host__ __device__ explicit Layout(int chunk)
      : groups((chunk + kGroup - 1) / kGroup),
        own((groups + kCluster - 1) / kCluster),
        slots(own * kGroup) {}
  // 32-bit words: two heads [kHeadRows, slots], offsets [slots], every
  // group's base [groups], every group's total [kTotals, groups]
  __host__ __device__ size_t words() const {
    return static_cast<size_t>(2 * kHeadRows + 1) * slots +
           static_cast<size_t>(1 + kTotals) * groups;
  }
};

// Head index i lives in block (i / 32) % kCluster, at slot
// (i / 32 / kCluster) * 32 + i % 32; own group r of block b is group
// r * kCluster + b.
__device__ __forceinline__ int owner_of(int i) {
  return (i / kGroup) % kCluster;
}
__device__ __forceinline__ int slot_of(int i) {
  return (i / kGroup / kCluster) * kGroup + i % kGroup;
}

__device__ __forceinline__ void put_head(uint32_t* head, int slots, int at,
                                         const uint32_t dig[5], int depth,
                                         int count) {
#pragma unroll
  for (int w = 0; w < 5; ++w) head[w * slots + at] = dig[w];
  head[5 * slots + at] = static_cast<uint32_t>(depth);
  head[6 * slots + at] = static_cast<uint32_t>(count);
}

// Adds `sum` to group q's total in every block's copy (`totals` is this
// block's); lanes 0..kCluster-1 of a warp each send one, the others none.
__device__ __forceinline__ void add_total(cg::cluster_group& cluster,
                                          int* totals, int q, int sum) {
  const int lane = threadIdx.x & 31;
  if (sum && lane < kCluster)
    atomicAdd(cluster.map_shared_rank(totals + q, lane), sum);
}

// This block's slots of head indices [0, n), from the stack at [base,
// base + n): digest, depth and child count into `head`, the counts added
// to the groups' totals in `totals`.  One warp a group.
__device__ void head_from_stack(cg::cluster_group& cluster,
                                const uint32_t* dig, const int* dep,
                                long long cap, long long base, int n,
                                uint32_t* head, int* totals, const Layout& L,
                                int rank, const int* table, int n_table,
                                int max_depth) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < L.own; r += blockDim.x >> 5) {
    const int q = r * kCluster + rank;
    const int i = q * kGroup + lane;
    int c = 0;
    if (i < n) {
      const long long pos = base + i;
      uint32_t d[5];
#pragma unroll
      for (int w = 0; w < 5; ++w) d[w] = __ldcg(dig + w * cap + pos);
      const int depth = __ldcg(dep + pos);
      c = child_count(d[0], depth, table, n_table, max_depth);
      put_head(head, L.slots, r * kGroup + lane, d, depth, c);
    }
    add_total(cluster, totals, q, __reduce_add_sync(0xffffffffu, c));
  }
}

// dig [5, cap] and dep [cap] hold the bag at [0, s); state receives count,
// S, generations and status.  Launched as one cluster of kCluster blocks of
// kExpandThreads threads, with Layout(chunk).words() * 4 bytes of dynamic
// shared memory.
__global__ void __launch_bounds__(kExpandThreads, 1)
uts_expand_kernel(uint32_t* dig, int* dep, long long cap, long long s,
                  long long iters, int chunk, int max_depth,
                  const int* __restrict__ table, int n_table,
                  long long* state) {
  extern __shared__ uint32_t smem[];
  __shared__ int s_table[kMaxTable];
  __shared__ int s_total;
  constexpr unsigned kAll = 0xffffffffu;
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L(chunk);
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  uint32_t* heads = smem;                                    // [2][7][slots]
  int* off = reinterpret_cast<int*>(smem + 2 * kHeadRows * L.slots);
  int* gbase = off + L.slots;                                // [groups]
  int* totals = gbase + L.groups;                            // [2][groups]
  for (int i = tid; i < n_table; i += blockDim.x) s_table[i] = table[i];
  for (int i = tid; i < kTotals * L.groups; i += blockDim.x) totals[i] = 0;
  cluster.sync();  // every block has started, its totals cleared

  // the first generation's head, from the stack
  long long count = 0, gens = 0;
  int status = kDone, cur = 0;
  long long take = take_of(s, count, iters, chunk);
  head_from_stack(cluster, dig, dep, cap, s - take, static_cast<int>(take),
                  heads, totals, L, rank, s_table, n_table, max_depth);
  cluster.sync();

  while (take > 0) {
    const long long cut = s - take;
    const int n = static_cast<int>(take);
    const int ng = (n + kGroup - 1) / kGroup;
    const uint32_t* head = heads + cur * kHeadRows * L.slots;
    uint32_t* next = heads + (cur ^ 1) * kHeadRows * L.slots;
    int* tot = totals + cur * L.groups;
    int* tot_next = totals + (cur ^ 1) * L.groups;
    // warp 0: the groups' bases, an exclusive scan of their totals, a
    // contiguous run of them a lane
    if (warp == 0) {
      const int per = (ng + 31) / 32;
      const int lo = min(ng, lane * per), hi = min(ng, lo + per);
      int sum = 0;
      for (int q = lo; q < hi; ++q) sum += tot[q];
      int x = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kAll, x, o);
        if (lane >= o) x += y;
      }
      for (int q = lo, b = x - sum; q < hi; ++q) {
        gbase[q] = b;
        b += tot[q];
      }
      if (lane == 31) s_total = x;
    }
    // this block's offsets: its slots in order (its groups in order), an
    // exclusive scan of their child counts; mine = its children
    int mine = 0;
    for (int r0 = 0; r0 < L.own; r0 += 32) {
      const int q = (r0 + lane) * kCluster + rank;
      mine += __reduce_add_sync(kAll, r0 + lane < L.own && q < ng ? tot[q]
                                                                  : 0);
    }
    for (int r = warp; r < L.own; r += nwarps) {
      int below = 0;  // children of this block's groups before r
      for (int r0 = 0; r0 < r; r0 += 32) {
        const int q = (r0 + lane) * kCluster + rank;
        below += __reduce_add_sync(kAll, r0 + lane < r && q < ng ? tot[q]
                                                                 : 0);
      }
      const int i = (r * kCluster + rank) * kGroup + lane;
      const int c =
          i < n ? static_cast<int>(head[6 * L.slots + r * kGroup + lane]) : 0;
      int x = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kAll, x, o);
        if (lane >= o) x += y;
      }
      off[r * kGroup + lane] = below + x - c;
    }
    __syncthreads();
    const int total = s_total;
    if (cut + total > cap) {
      status = kCapacity;
      break;
    }
    // read by this block alone: cleared for the generation after next
    for (int q = tid; q < ng; q += blockDim.x) tot[q] = 0;
    const long long count_n = count + take, s_n = cut + total;
    const long long take_n = take_of(s_n, count_n, iters, chunk);
    const long long cut_n = s_n - take_n;

    // the children of this block's head nodes, a warp's 32 at a time
    for (int t0 = warp * 32; t0 < mine; t0 += blockDim.x) {
      const int t = t0 + lane;
      int q_next = 0, c_next = 0;
      if (t < mine) {
        int lo = 0, hi = L.slots;  // the last slot with off <= t
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (off[mid] <= t) lo = mid + 1; else hi = mid;
        }
        const int p = lo - 1;
        const int r = p / kGroup;
        const int j = t - off[r * kGroup] + gbase[r * kCluster + rank];
        uint32_t par[5], c[5];
#pragma unroll
        for (int w = 0; w < 5; ++w) par[w] = head[w * L.slots + p];
        const int depth = static_cast<int>(head[5 * L.slots + p]) + 1;
        sha1_child(par, static_cast<uint32_t>(t - off[p]), c);
        const long long pos = cut + j;
#pragma unroll
        for (int w = 0; w < 5; ++w) dig[w * cap + pos] = c[w];
        dep[pos] = depth;
        if (pos >= cut_n) {
          const int i = static_cast<int>(pos - cut_n);
          c_next = child_count(c[0], depth, s_table, n_table, max_depth);
          put_head(cluster.map_shared_rank(next, owner_of(i)), L.slots,
                   slot_of(i), c, depth, c_next);
          q_next = i / kGroup;
        }
      }
      // the counts into their groups' totals: a warp's sum a group, sent
      // to every block
      unsigned todo = __ballot_sync(kAll, c_next > 0);
      while (todo) {
        const int q = __shfl_sync(kAll, q_next, __ffs(todo) - 1);
        const bool here = c_next > 0 && q_next == q;
        add_total(cluster, tot_next, q,
                  __reduce_add_sync(kAll, here ? c_next : 0));
        todo &= ~__ballot_sync(kAll, here);
      }
    }
    // the older nodes below cut that the next head reaches
    if (cut_n < cut)
      head_from_stack(cluster, dig, dep, cap, cut_n,
                      static_cast<int>(cut - cut_n), next, tot_next, L, rank,
                      s_table, n_table, max_depth);
    count = count_n;
    s = s_n;
    take = take_n;
    ++gens;
    cur ^= 1;
    cluster.sync();
  }
  cluster.sync();  // no block leaves while another may write its memory
  if (rank == 0 && tid == 0) {
    state[kCount] = count;
    state[kSize] = s;
    state[kGenerations] = gens;
    state[kStatus] = status;
  }
}

cudaLaunchConfig_t expand_config(cudaLaunchAttribute& attr, size_t smem,
                                 cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kExpandThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cfg;
}

// What a device allows the kernel, found once a process and device: the
// dynamic shared bytes a block may take (the kernel is allowed them all),
// and the clusters resident at once.
struct Setup {
  cudaError_t err;
  int smem_max;
  int clusters;
};

std::mutex g_setup_lock;
Setup g_setup[kMaxDevices];
bool g_setup_done[kMaxDevices];

const Setup& expand_setup(int device) {
  std::lock_guard<std::mutex> hold(g_setup_lock);
  Setup& st = g_setup[device];
  if (g_setup_done[device]) return st;
  g_setup_done[device] = true;
  st = Setup{cudaSuccess, 0, 0};
  int optin = 0;
  cudaFuncAttributes fa;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, uts_expand_kernel);
  if (err == cudaSuccess) {
    st.smem_max = optin - static_cast<int>(fa.sharedSizeBytes);
    err = cudaFuncSetAttribute(uts_expand_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               st.smem_max);
  }
  if (err == cudaSuccess && kCluster > 8)
    err = cudaFuncSetAttribute(uts_expand_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = expand_config(attr, st.smem_max, nullptr);
    err = cudaOccupancyMaxActiveClusters(&st.clusters, uts_expand_kernel,
                                         &cfg);
  }
  if (err == cudaSuccess && st.clusters < 1) err = cudaErrorLaunchOutOfResources;
  st.err = err;
  return st;
}

// The current device's set-up, and the dynamic shared bytes at `chunk`;
// cudaErrorInvalidValue for a chunk the kernel does not take.
cudaError_t expand_smem(int chunk, size_t* smem) {
  if (chunk <= 0 || chunk > (1 << 24)) return cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidValue;
  const Setup& st = expand_setup(device);
  if (st.err != cudaSuccess) return st.err;
  *smem = Layout(chunk).words() * sizeof(uint32_t);
  if (*smem > static_cast<size_t>(st.smem_max)) return cudaErrorInvalidValue;
  return cudaSuccess;
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

// One launch of uts_expand_kernel on `stream`: one cluster of kCluster
// blocks.  dig: [5, cap] int32, dep: [cap] int32 (the bag at [0, s));
// table: [n_table] int32 ascending (n_table <= 256); state: [4] int64 out.
// Returns a cudaError_t: the launch's own, cudaErrorInvalidValue for
// arguments the kernel does not take (a chunk whose head does not fit in
// the cluster's shared memory), or cudaErrorLaunchOutOfResources if no
// cluster fits on the card.  Nothing else is tried.
extern "C" int uts_expand_launch(void* dig, void* dep, long long cap,
                                 long long s, long long iters, int chunk,
                                 int max_depth, const void* table,
                                 int n_table, void* state, void* stream) {
  if (s <= 0 || s > cap || iters <= 0 || n_table < 0 || n_table > kMaxTable)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  cudaError_t err = expand_smem(chunk, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      expand_config(attr, smem, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, uts_expand_kernel, static_cast<uint32_t*>(dig),
                           static_cast<int*>(dep), cap, s, iters, chunk,
                           max_depth, static_cast<const int*>(table), n_table,
                           static_cast<long long*>(state));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The launch uts_expand_launch makes at `chunk`, into out[7]: blocks a
// cluster, threads a block, dynamic shared bytes a block, clusters resident
// on the card at once, registers a thread, local (spill) bytes a thread,
// static shared bytes a block.  Returns a cudaError_t (0: filled).
extern "C" int uts_expand_plan(int chunk, int* out) {
  size_t smem = 0;
  cudaError_t err = expand_smem(chunk, &smem);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, uts_expand_kernel);
  int clusters = 0;
  if (err == cudaSuccess) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = expand_config(attr, smem, nullptr);
    err = cudaOccupancyMaxActiveClusters(&clusters, uts_expand_kernel, &cfg);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[] = {kCluster, kExpandThreads, static_cast<int>(smem),
                      clusters, fa.numRegs, static_cast<int>(fa.localSizeBytes),
                      static_cast<int>(fa.sharedSizeBytes)};
  for (int x = 0; x < 7; ++x) out[x] = vals[x];
  return 0;
}

extern "C" int uts_expand_max_table() { return kMaxTable; }

extern "C" const char* uts_hash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
