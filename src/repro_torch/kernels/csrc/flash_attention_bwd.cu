// Fused flash attention, backward, for Hopper's tensor cores: dQ, dK and dV
// from q, k, v, the forward's output o, the output's gradient dO and the
// forward's row log-sum-exp, every product on wgmma, the streamed tiles
// brought in by TMA, deterministic (no atomics).
//
// Replaces no Pallas kernel.  The Pallas forward (`_flash_fwd_kernel`,
// src/repro/kernels/flash_attention/kernel.py) has no custom_vjp; the JAX
// package trains through XLA's autodiff of its chunked flash attention
// (`attention_train`, src/repro/models/attention.py:191).  The port's
// training forward runs the hand-written forward kernel, so its gradient is
// this kernel, called by the `FlashAttention` autograd function
// (kernels/flash_attention/ops.py).
//
// What it computes, for every live (query row i, key j) pair of a head, with
// q already scaled, s = q_i . k_j, x = s or softcap * tanh(s / softcap), the
// forward's masks (i < Sq, j < Skv, causal i >= j, window i - j < window),
// p = exp(x - lse_i) (0 on a masked pair) and Delta_i = sum_d dO_id O_id:
//     dV_j += p dO_i,   dP = dO_i . v_j,   dX = p (dP - Delta_i),
//     dS = dX (1 - (x / softcap)^2) with a softcap, else dX,
//     dQ_i += dS k_j,   dK_j += dS q_i,
// summed over the G query heads of a KV head for dK and dV; each output in
// its input's dtype (bf16 rounded to nearest even).
//
// Precision: rounding only where the plain version (autograd over
// `flash_attention_ref`) rounds.  A float32 product runs as three TF32
// passes (x = hi + lo, hi = rna_tf32(x), lo = rna_tf32(x - hi); hi.lo +
// lo.hi + hi.hi, the small terms first); bf16 operands go in as they are.
// In the model's build (float32 q and k, bf16 v, float32 dO) the plain
// version forms dV = p^T dO and dP = dO v^T in bf16 (its p.to(v.dtype) and
// the bf16 product's gradient), so those two take p and dO rounded to bf16;
// s = q k^T, dQ = dS k and dK = dS^T q stay float32-accurate (3xTF32), and
// dS and p never go to bf16 for them.  A long float32 sum over tiles takes
// each tile's product in a fresh accumulator, added in registers (wgmma's
// own accumulation is not round-to-nearest).
//
// What bounds it on the H100, at gemma3-1b's training shapes (B 1, S 4,096,
// 4 query heads on 1 KV head, D 256, causal global layers and window-512
// local ones): the products over the live pairs, 33.6e6 a global layer.
// At the bf16 rate (989 TFLOP/s) its five products (q.k^T, dP, dV, dQ, dK:
// 2 * (3 * 256 + 2 * 256) flops a pair) take 0.087 ms; priced in the types
// they must keep (q.k^T, dQ and dK as three TF32 passes at 495 TFLOP/s, dP
// and dV in bf16), 0.35 ms; with the dQ pass's recomputation of q.k^T and
// dP, 0.47 ms.  Its bytes (q, k, v, o, dO, lse in, dq, dk, dv out) move in
// 0.03 ms at 3.35 TB/s.
//
// The design:
// - Two passes, each recomputing s and dP: one block a (KV head, 64-key
//   tile, query head) for dK and dV, walking that head's live query tiles;
//   one block a (query head, 64-row query tile) for dQ, walking its live key
//   tiles.  Each block's 64 rows are the fixed side F (K and V, or Q and dO,
//   loaded once by TMA); the other side's tiles T of kBt rows (Q and dO, or
//   K and V) stream through a ring of stages by TMA with an mbarrier each
//   (in the dK/dV pass the block reads each tile's rows' lse and Delta into
//   shared memory beside it).  Under a causal mask the
//   longest blocks start first.  With G > 1 the dK/dV blocks write float32
//   partials, [BHG, Skv, D] each, to the wrapper's workspace, and a small
//   pass sums them over h = 0 .. G - 1 in that order; with G = 1 they write
//   dK and dV directly.  A first pass writes Delta (and, in the model's
//   build, dO rounded to bf16, so that the main passes move half its
//   bytes).  No sum depends on scheduling, so two launches give the same
//   bits.
// - The score products X1 = F1 T1^T (s, or s^T in the dK/dV pass) and X2 =
//   F2 T2^T (dP) put the fixed side's 64 rows on wgmma's M: A is F, B the
//   streamed tile as loaded (K-major).  A float32 F tile stays raw in
//   shared memory and is read at each k8 step into A fragment registers
//   (one ldmatrix) and split there; a float32 T tile is split in place once
//   it lands (tf32 hi over the raw tile, lo beside it).  bf16 tiles are
//   wgmma's shared-memory operands as they are.
// - From X1 and X2 the block forms p and dS in registers and writes them to
//   shared memory as Z = [64 F rows][kBt T rows] (T contiguous): bf16 where
//   the product that reads them is bf16, tf32 hi and lo where it is float32.
// - The gradient products Out[F, D] += Z T:
//   * bf16 T: wgmma with A = Z (K-major) and B = T read MN-major (the
//     transpose bit), Out in natural layout;
//   * float32 T: tf32 wgmma takes only K-major operands and T is D-major, so
//     the product is taken transposed, Out^T[D, F] += T^T Z^T: A = T^T,
//     read from the split tile into fragment registers (four loads a k8
//     step), B = Z (K-major as written).  No transposed copy of T is stored.
// - At D = 256 two warpgroups a block, each owning half of D: of the score
//   products' sums over D (each warpgroup's half-D partial sums meet
//   through shared memory, thread for thread, and are added, X = X_0 + X_1,
//   the same bits in both) and of the outputs' columns, so a thread holds
//   64 + 64 float32 accumulators for dK and dV.  At D = 128 with bf16 v one
//   warpgroup a block and two blocks an SM (each block's waits are the
//   other's time on the tensor cores: 3.03 ms a deepseek-moe-16b layer
//   against 3.61 with two warpgroups in one block, PERF.md); below, one
//   warpgroup a block.
// - Key tiles (query tiles) wholly above the diagonal or wholly outside the
//   window are never visited; rows past Sq and keys past Skv arrive as
//   zeros (TMA's bounds fill) and are masked; a tile whose every pair is
//   live skips the mask.
// - The plan of each build (kBt, stages) is
//   computed at compile time from the shared memory a block may have
//   (232,448 bytes, or half an SM's 233,472 less 1 KB with two blocks): the
//   largest kBt in {32, 16} (float32 q and k) or {64, 32, 16} (bf16) that
//   fits one stage, then as many stages as fit, at most 4.  Larger score
//   tiles beat deeper rings: at D = 256 one stage of 32 rows took 1.86 ms
//   a gemma3-1b global layer where two stages of 16 took 2.33.  At D = 256
//   in the model's build: K 64 KB raw, V 32 KB, a stage Q hi and lo 64 KB
//   and dO 16 KB, Z 20 KB, the partial sums' exchange 16 KB (dK/dV pass,
//   218 KB); Q 64 KB, dO 32 KB, a stage K hi and lo 64 KB and V 16 KB, Z
//   16 KB, exchange 16 KB (dQ pass, 214 KB).  Registers and spills per
//   build: PERF.md.

#include <cstdint>
#include <type_traits>
#include <cuda.h>  // CUtensorMap; its encoder is fetched at run time
#include <cuda_runtime.h>

namespace {

constexpr int kBlockF = 64;   // rows of the fixed side: the M of every wgmma
constexpr int kInFlight = 2;  // float32 score products: k8 steps in flight
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100
constexpr int kSmemSM = 233472;     // an SM's, of which 1 KB per block is
                                    // the system's
constexpr int kBarBytes = 128;
constexpr int kThreadsAux = 256;  // the Delta and head-sum passes

// dtype codes of the C interface (as the forward's)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int round1k(int b) { return (b + 1023) / 1024 * 1024; }

struct F32 {
  using T = float;
  static constexpr int kBytes = 4;
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  static __device__ __forceinline__ float load(const T* p, size_t i) {
    return p[i];
  }
};

struct BF16 {
  using T = uint16_t;  // bf16 bits
  static constexpr int kBytes = 2;
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static __device__ __forceinline__ float load(const T* p, size_t i) {
    return __uint_as_float(static_cast<uint32_t>(p[i]) << 16);
  }
};

// -- the shared-memory plan ---------------------------------------------------
//
// qb, vb: bytes of an element of q/k and of v/dO (as the main passes read
// dO); kv: the dK/dV pass (else the dQ pass); bt: rows of a streamed tile.

// D = 128 runs two blocks of one warpgroup on an SM, D = 256 one block of
// two warpgroups (a thread's accumulators, 2 x D / 2 / groups floats, must
// stay under 255 registers), smaller D one block of one warpgroup
constexpr int blocks_for(int d, int vb) {
  return d == 128 && vb == 2 ? 2 : 1;
}
constexpr int groups_for(int d, int vb) {
  return d >= 128 && blocks_for(d, vb) == 1 ? 2 : 1;
}
constexpr int smem_budget(int d, int vb) {
  return blocks_for(d, vb) == 1 ? kSmemLimit
                                : kSmemSM / blocks_for(d, vb) - 1024;
}

// a stage: side 1's tile (tf32 hi over the raw tile, then lo), side 2's
constexpr int stage_bytes(int qb, int vb, int d, int bt) {
  return round1k(bt * d * qb) * (qb == 4 ? 2 : 1) +
         round1k(bt * d * vb) * (vb == 4 ? 2 : 1);
}

// Z: dS in side 1's type and, in the dK/dV pass, p in side 2's
constexpr int z_bytes(int qb, int vb, bool kv, int bt) {
  return round1k(kBlockF * bt * qb) * (qb == 4 ? 2 : 1) +
         (kv ? round1k(kBlockF * bt * vb) * (vb == 4 ? 2 : 1) : 0);
}

// the two warpgroups' half-D partial sums of X1 and X2
constexpr int x_bytes(int d, int vb, int bt) {
  return groups_for(d, vb) == 2 ? 2 * kBlockF * bt * 4 : 0;
}

// the dK/dV pass's lse and Delta of a tile's query rows (64 at most)
constexpr int rows_bytes(bool kv) { return kv ? 2 * 64 * 4 : 0; }

// the fixed side's tiles as loaded, Z, the exchange, the barriers, the rows
// and the 1024 bytes of slack that align the base to the swizzle's period
constexpr int fixed_bytes(int qb, int vb, int d, bool kv, int bt) {
  return round1k(kBlockF * d * qb) + round1k(kBlockF * d * vb) +
         z_bytes(qb, vb, kv, bt) + x_bytes(d, vb, bt) + kBarBytes +
         rows_bytes(kv) + 1024;
}

constexpr int stages_fit(int qb, int vb, int d, bool kv, int bt) {
  return (smem_budget(d, vb) - fixed_bytes(qb, vb, d, kv, bt)) /
         stage_bytes(qb, vb, d, bt);
}

// The largest streamed tile that fits one stage: the score products'
// wgmmas are 64 x kBt, and at D = 256 one stage of 32 rows beat two of 16
// (PERF.md).  At most 32 rows with float32 q and k: the three accumulators
// of a 3xTF32 score tile take 3 x kBt / 2 registers a thread.
constexpr int pick_bt(int qb, int vb, int d, bool kv) {
  for (int bt = qb == 4 ? 32 : 64; bt >= 16; bt /= 2)
    if (stages_fit(qb, vb, d, kv, bt) >= 1) return bt;
  return 0;
}

// Every tile is stored as TMA's swizzle lays it out: rows of W bytes (W = the
// row's bytes, at most 128), a tile wider than W as column blocks of rows x W
// bytes one after another.  Region offsets are multiples of 1024 bytes from a
// 1024-aligned base.
template <typename EQK, typename EV, int D, bool kKV>
struct Plan {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256, "D");
  static constexpr int kQB = EQK::kBytes, kVB = EV::kBytes;
  static constexpr bool kSplit1 = kQB == 4;  // side 1 (q, k) in 3xTF32
  static constexpr bool kSplit2 = kVB == 4;  // side 2 (v, dO) in 3xTF32
  static constexpr int kGroups = groups_for(D, kVB);
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kBt = pick_bt(kQB, kVB, D, kKV);
  static_assert(kBt >= 16, "shared memory budget");
  static constexpr int kStages =
      cmin(kMaxStages, stages_fit(kQB, kVB, D, kKV, kBt));
  static constexpr int kW1 = cmin(128, D * kQB);  // rows of q, k tiles
  static constexpr int kW2 = cmin(128, D * kVB);  // rows of v, dO tiles
  static constexpr int kWz1 = cmin(128, kBt * kQB);  // rows of Z's dS
  static constexpr int kWz2 = cmin(128, kBt * kVB);  // rows of Z's p
  static constexpr int kF1Box = kBlockF * D * kQB;  // TMA bytes
  static constexpr int kF2Box = kBlockF * D * kVB;
  static constexpr int kT1Box = kBt * D * kQB;
  static constexpr int kT2Box = kBt * D * kVB;
  // regions
  static constexpr int kF1 = 0;
  static constexpr int kF2 = round1k(kF1Box);
  static constexpr int kZ1 = kF2 + round1k(kF2Box);
  static constexpr int kZ1Lo = round1k(kBlockF * kBt * kQB);  // from kZ1
  static constexpr int kZ2 = kZ1 + kZ1Lo * (kSplit1 ? 2 : 1);
  static constexpr int kZ2Lo = round1k(kBlockF * kBt * kVB);  // from kZ2
  static constexpr int kX = kZ1 + z_bytes(kQB, kVB, kKV, kBt);
  static constexpr int kRing = kX + x_bytes(D, kVB, kBt);
  static constexpr int kStageBytes = stage_bytes(kQB, kVB, D, kBt);
  // within a stage
  static constexpr int kT1Lo = round1k(kT1Box);
  static constexpr int kT2 = kT1Lo * (kSplit1 ? 2 : 1);
  static constexpr int kT2Lo = kT2 + round1k(kT2Box);
  static constexpr int kBars = kRing + kStages * kStageBytes;
  static constexpr int kRows = kBars + kBarBytes;  // lse, then Delta
  static constexpr int kSmem = kRows + rows_bytes(kKV) + 1024;
  static_assert(kSmem <= smem_budget(D, kVB), "shared memory budget");
  static constexpr int kBlocksPerSM = blocks_for(D, kVB);
  static_assert(kSmem == fixed_bytes(kQB, kVB, D, kKV, kBt) +
                             kStages * kStageBytes, "plan");
  // the gradient products: each warpgroup's D columns; a transposed
  // (float32) output in 64-row chunks of D (one chunk, zero-padded, below
  // D = 64), a natural (bf16) one as kDPart columns
  static constexpr int kDPart = D / kGroups;
  static constexpr int kChunks = cmax(1, kDPart / 64);
  static constexpr int kAcc1 = kSplit1 ? kChunks * 32 : kDPart / 2;
  static constexpr int kAcc2 = kSplit2 ? kChunks * 32 : kDPart / 2;
  static_assert(kGroups == 1 || kDPart * 2 % 128 == 0, "column blocks");
};

// -- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of this parity.  A wait
// that outlasts some 10 s of the SM's clock traps: a fault in the pipeline
// then ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > 20000000000LL) __trap();
}

// a tile of a [heads, rows, D] tensor (see make_map): rows row .. of head
// `head`, all its column blocks at once
__device__ __forceinline__ void tma_load_tile(uint32_t dst,
                                              const CUtensorMap* map, int row,
                                              int head, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row), "r"(0),
      "r"(head), "r"(bar)
      : "memory");
}

// generic-proxy writes to shared memory, made visible to wgmma and TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both tf32 (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ uint32_t float_to_bf16_bits(float x) {
  // round to nearest even; NaN stays NaN
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40u;
  return (u + 0x7fffu + ((u >> 16) & 1u)) >> 16;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return float_to_bf16_bits(lo) | (float_to_bf16_bits(hi) << 16);
}

// byte offset of TMA's W-byte swizzle within a 1024-aligned region
template <int W>
__device__ __forceinline__ uint32_t swz(uint32_t off) {
  return off ^ (((off >> 7) & (W / 16 - 1)) << 4);
}

template <int W>
__device__ constexpr uint64_t swizzle_layout() {
  return W == 128 ? 1 : W == 64 ? 2 : 3;
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout
template <int W>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fffu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fffu) << 32) |
         (swizzle_layout<W>() << 62);
}

// k-step j (32 bytes of K each) of a K-major tile of `rows` rows stored in
// column blocks of W bytes
template <int W>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int j) {
  return desc<W>(tile + (j * 32 / W) * rows * W + (j * 32) % W, 16, 8 * W);
}


// wgmma.mma_async wrappers, D = A * B + (scale_d ? D : 0), float32 D of
// m64nN: thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4
// (+ 8) and columns 8 j + 2 (t % 4) (+ 1), d[4 j + 2 h + e].
//   mma_tf32_rs: A from registers, B K-major.
//   mma_bf16_ss: A and B from shared memory, both K-major.
//   mma_bf16_ss_mn: A from shared memory K-major, B MN-major.
template <int N>
__device__ __forceinline__ void mma_tf32_rs(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d);
template <int N>
__device__ __forceinline__ void mma_bf16_ss(float (&d)[N / 2], uint64_t a,
                                            uint64_t b, int scale_d);
template <int N>
__device__ __forceinline__ void mma_bf16_ss_mn(float (&d)[N / 2],
                                               uint64_t a, uint64_t b,
                                               int scale_d);

#define ACC8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <>
__device__ __forceinline__ void mma_tf32_rs<16>(
    float (&d)[8], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : ACC8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_tf32_rs<32>(
    float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_tf32_rs<64>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_bf16_ss<16>(
    float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_bf16_ss<32>(
    float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_bf16_ss<64>(
    float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_bf16_ss_mn<16>(
    float (&d)[8], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 1;\n}\n"
      : ACC8(0)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_bf16_ss_mn<32>(
    float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : ACC8(0), ACC8(8)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_bf16_ss_mn<64>(
    float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_bf16_ss_mn<128>(
    float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40),
        ACC8(48), ACC8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}


#undef ACC8

// -- the kernels ------------------------------------------------------------

struct Smem {
  uint8_t* ptr;   // generic pointer of the aligned base
  uint32_t addr;  // its shared-memory address
  __device__ uint32_t at(int off) const { return addr + off; }
  template <typename T>
  __device__ T* p(int off) const {
    return reinterpret_cast<T*>(ptr + off);
  }
};

__device__ __forceinline__ bool live(int qp, int kp, int sq, int skv,
                                     int causal, int window) {
  return qp < sq && kp < skv && (!causal || qp >= kp) &&
         (window <= 0 || qp - kp < window);
}

// byte offset of (row, byte col) in a tile of `rows` rows stored as TMA lays
// it out with rows of W bytes
template <int W>
__device__ __forceinline__ uint32_t tile_off(int rows, int row, int col) {
  return (col / W) * rows * W + swz<W>(row * W + col % W);
}

// Split a loaded float32 tile in place: tf32 hi over it, lo at `lo`;
// elementwise, so the swizzle is kept.
template <int kBytes, int kThreads>
__device__ __forceinline__ void split_tile(const Smem& sm, int hi_off,
                                           int lo_off) {
  float4* hi = sm.p<float4>(hi_off);
  float4* lo = sm.p<float4>(lo_off);
#pragma unroll 4
  for (int i = threadIdx.x; i < kBytes / 16; i += kThreads) {
    const float4 x = hi[i];
    uint4 h, l;
    split_tf32(x.x, h.x, l.x);
    split_tf32(x.y, h.y, l.y);
    split_tf32(x.z, h.z, l.z);
    split_tf32(x.w, h.w, l.w);
    hi[i] = make_float4(__uint_as_float(h.x), __uint_as_float(h.y),
                        __uint_as_float(h.z), __uint_as_float(h.w));
    lo[i] = make_float4(__uint_as_float(l.x), __uint_as_float(l.y),
                        __uint_as_float(l.z), __uint_as_float(l.w));
  }
}

// x = F . T^T over k8 steps j0 .. j0 + kSteps - 1 of D, float32 F and T in
// three tf32 passes: F (64 raw rows at f) read at each step into A fragment
// registers and split there, T split in shared memory (hi at t, lo at
// t_lo).  Each pass has its own accumulator, so the three chains of wgmmas
// run side by side; x = hi.hi + (hi.lo + lo.hi).
template <int W, int N, int kSteps>
__device__ __forceinline__ void score_tf32x3(const Smem& sm, int f, int t,
                                             int t_lo, int j0,
                                             float (&x)[N / 2]) {
  float hl[N / 2], lh[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) x[i] = hl[i] = lh[i] = 0.f;
  fence_regs(x);
  fence_regs(hl);
  fence_regs(lh);
  // The A fragment of k8 step j, (r, 8j + t), (r + 8, 8j + t), (r, 8j + t +
  // 4), (r + 8, 8j + t + 4) with r = 16 warp + lane / 4 and t = lane % 4, is
  // what ldmatrix.x4 gives as four 8 x 8 b16 matrices, each row one 16-byte
  // run of 4 floats: lane l names row (l & 7) + 8 ((l >> 3) & 1), columns
  // + 4 (l >> 4) of the tile.
  const int lane = threadIdx.x % 32;
  const int ld_row = 16 * (threadIdx.x % 128 / 32) + (lane & 7) +
                     8 * ((lane >> 3) & 1);
  const int ld_col = 16 * (lane >> 4);  // bytes
#pragma unroll
  for (int jj = 0; jj < kSteps; ++jj) {
    const int j = j0 + jj;
    const int cb = 32 * j + ld_col;
    uint32_t hi[4], lo[4];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(hi[0]), "=r"(hi[1]), "=r"(hi[2]), "=r"(hi[3])
        : "r"(sm.at(f + tile_off<W>(kBlockF, ld_row, cb))));
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_tf32(__uint_as_float(hi[i]), hi[i], lo[i]);
    const uint64_t b_hi = desc_k<W>(sm.at(t), N, j);
    const uint64_t b_lo = desc_k<W>(sm.at(t_lo), N, j);
    wgmma_fence();
    mma_tf32_rs<N>(hl, hi, b_lo, 1);
    mma_tf32_rs<N>(lh, lo, b_hi, 1);
    mma_tf32_rs<N>(x, hi, b_hi, 1);
    wgmma_commit();
    // at most kInFlight steps in flight: the registers of older steps'
    // fragments are free again
    wgmma_wait<kInFlight - 1>();
  }
  wgmma_wait<0>();
  fence_regs(x);
  fence_regs(hl);
  fence_regs(lh);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) x[i] += hl[i] + lh[i];
}

// x = F . T^T over k16 steps j0 .. j0 + kSteps - 1, bf16 F and T both from
// shared memory; issued and committed, not waited for.
template <int W, int N, int kSteps>
__device__ __forceinline__ void score_bf16(const Smem& sm, int f, int t,
                                           int j0, float (&x)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) x[i] = 0.f;
  fence_regs(x);
  wgmma_fence();
#pragma unroll
  for (int jj = 0; jj < kSteps; ++jj)
    mma_bf16_ss<N>(x, desc_k<W>(sm.at(f), kBlockF, j0 + jj),
                   desc_k<W>(sm.at(t), N, j0 + jj), 1);
  wgmma_commit();
}

// Out[F, part] += Z T[:, part] with bf16 Z (64 rows of Bt, K-major, at z)
// and T (Bt rows, read MN-major from t, the part's first column block);
// issued and committed, not waited for.
template <int N, int Wz, int Wt, int Bt>
__device__ __forceinline__ void grad_bf16(const Smem& sm, int z, int t,
                                          float (&acc)[N / 2]) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Bt / 16; ++kk)
    mma_bf16_ss_mn<N>(acc, desc_k<Wz>(sm.at(z), kBlockF, kk),
                      desc<Wt>(sm.at(t + kk * 16 * Wt), Bt * Wt, 8 * Wt), 1);
  wgmma_commit();
}

// Out^T[part, F] += T^T Z^T with float32 T (Bt rows, split at t_hi and t_lo,
// rows of Wt bytes) and Z (64 rows of Bt, tf32 hi and lo, K-major), in
// 64-row chunks of the part's D columns from d_base: A = T^T read into
// fragment registers, B = Z; each chunk's product in a fresh accumulator,
// added to acc in registers.  Rows past D (D < 64) take zeros.
template <int D, int kChunks, int Bt, int Wt, int Wz>
__device__ __forceinline__ void grad_tf32x3(const Smem& sm, int t_hi,
                                            int t_lo, int z_hi, int z_lo,
                                            int d_base,
                                            float (&acc)[kChunks * 32]) {
  const int wtid = threadIdx.x % 128;
  const int lane = wtid % 32;
  const int r0 = 16 * (wtid / 32) + lane / 4;
  const int tq = lane % 4;
  const uint32_t* th = sm.p<uint32_t>(t_hi);
  const uint32_t* tl = sm.p<uint32_t>(t_lo);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    // fragment (r, t), (r + 8, t), (r, t + 4), (r + 8, t + 4) of k8 step j:
    // element (d, key or query) of T^T is T's (row, d)
    uint32_t ah[Bt / 8][4], al[Bt / 8][4];
#pragma unroll
    for (int j = 0; j < Bt / 8; ++j)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int d = d_base + 64 * c + r0 + 8 * (a & 1);
        const int row = 8 * j + tq + 4 * (a >> 1);
        if (D >= 64 || d < D) {
          const uint32_t off = tile_off<Wt>(Bt, row, d * 4) / 4;
          ah[j][a] = th[off];
          al[j][a] = tl[off];
        } else {
          ah[j][a] = al[j][a] = 0u;
        }
      }
    float part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) part[i] = 0.f;
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < Bt / 8; ++j) {
      const uint64_t b_hi = desc_k<Wz>(sm.at(z_hi), kBlockF, j);
      const uint64_t b_lo = desc_k<Wz>(sm.at(z_lo), kBlockF, j);
      mma_tf32_rs<64>(part, al[j], b_hi, 1);
      mma_tf32_rs<64>(part, ah[j], b_lo, 1);
      mma_tf32_rs<64>(part, ah[j], b_hi, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c * 32 + i] += part[i];
  }
}

// a pair of values at (row, col) of a Z tile (64 rows of Bt, T contiguous)
template <int W>
__device__ __forceinline__ void z_store_bf16(const Smem& sm, int z, int row,
                                             int col, float a, float b) {
  *sm.p<uint32_t>(z + tile_off<W>(kBlockF, row, col * 2)) = pack_bf16(a, b);
}

template <int W>
__device__ __forceinline__ void z_store_tf32(const Smem& sm, int z_hi,
                                             int z_lo, int row, int col,
                                             float a, float b) {
  uint32_t ha, la, hb, lb;
  split_tf32(a, ha, la);
  split_tf32(b, hb, lb);
  const uint32_t off = tile_off<W>(kBlockF, row, col * 4);
  *sm.p<float2>(z_hi + off) =
      make_float2(__uint_as_float(ha), __uint_as_float(hb));
  *sm.p<float2>(z_lo + off) =
      make_float2(__uint_as_float(la), __uint_as_float(lb));
}

// Write a natural accumulator (64 F rows by N columns from d0) to rows
// f_lo .. of a [rows, D] matrix: float32, or bf16 when `bf16`.
template <int D, int N>
__device__ __forceinline__ void store_natural(const float (&acc)[N / 2],
                                              void* out, bool bf16,
                                              int f_lo, int rows, int d0) {
  const int wtid = threadIdx.x % 128;
  const int lane = wtid % 32;
  const int r0 = 16 * (wtid / 32) + lane / 4;
  const int tq = lane % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = f_lo + r0 + 8 * h;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const size_t at = static_cast<size_t>(row) * D + d0 + 8 * j + 2 * tq;
      const float a = acc[4 * j + 2 * h], b = acc[4 * j + 2 * h + 1];
      if (bf16)
        *reinterpret_cast<uint32_t*>(static_cast<uint16_t*>(out) + at) =
            pack_bf16(a, b);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(out) + at) =
            make_float2(a, b);
    }
  }
}

// Write a transposed accumulator (kChunks chunks of 64 D rows from d0, by 64
// F columns) to rows f_lo .. of a float32 [rows, D] matrix.
template <int D, int kChunks>
__device__ __forceinline__ void store_transposed(
    const float (&acc)[kChunks * 32], float* out, int f_lo, int rows,
    int d0) {
  const int wtid = threadIdx.x % 128;
  const int lane = wtid % 32;
  const int r0 = 16 * (wtid / 32) + lane / 4;
  const int tq = lane % 4;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = d0 + 64 * c + r0 + 8 * h;
      if (D < 64 && d >= D) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = f_lo + 8 * j + 2 * tq + e;
          if (row < rows)
            out[static_cast<size_t>(row) * D + d] =
                acc[c * 32 + 4 * j + 2 * h + e];
        }
    }
}

// the full barrier of stage s, after the F barrier
template <typename P>
__device__ __forceinline__ uint32_t bar_full(const Smem& sm, int s) {
  return sm.at(P::kBars + 8 * (1 + s));
}

// TMA copies of streamed tile `it` (rows t_lo ..) of both sides into its
// stage, issued by one thread; the stage's barrier completes when they land
template <typename P>
__device__ __forceinline__ void load_t(const Smem& sm, const CUtensorMap* t1,
                                       const CUtensorMap* t2, int it,
                                       int t_lo, int t_head) {
  const int s = it % P::kStages;
  const int stage = P::kRing + s * P::kStageBytes;
  // the block's generic writes to this stage come before the copy's
  fence_proxy_async();
  mbar_expect_tx(bar_full<P>(sm, s), P::kT1Box + P::kT2Box);
  tma_load_tile(sm.at(stage), t1, t_lo, t_head, bar_full<P>(sm, s));
  tma_load_tile(sm.at(stage + P::kT2), t2, t_lo, t_head, bar_full<P>(sm, s));
}

// The main passes.  kKV: the dK/dV pass (F = keys of a KV head, T = the
// query rows of one of its query heads); else the dQ pass (F = query rows of
// a head, T = its KV head's keys).  Block b: head b % bhg, the (b / bhg)-th
// longest F tile.  f1/f2 map F's side-1 and side-2 tensors (k, v or q, dO),
// t1/t2 the streamed ones.  out1/out2: the kernel's outputs (dK, dV or dQ)
// in their dtypes, or with `partial` float32 [BHG, Skv, D] partial sums.
template <typename EQK, typename EV, int D, bool kKV>
__global__ void __launch_bounds__((Plan<EQK, EV, D, kKV>::kThreads),
                                  (Plan<EQK, EV, D, kKV>::kBlocksPerSM))
flash_bwd_kernel(const __grid_constant__ CUtensorMap f1_map,
                 const __grid_constant__ CUtensorMap f2_map,
                 const __grid_constant__ CUtensorMap t1_map,
                 const __grid_constant__ CUtensorMap t2_map,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, void* __restrict__ out1,
                 void* __restrict__ out2, int partial, int bhg, int g,
                 int sq, int skv, int causal, int window, float softcap) {
  using P = Plan<EQK, EV, D, kKV>;
  constexpr int kBt = P::kBt;
  constexpr int kJ = kBt / 8;  // 8-column groups of a score tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  const Smem sm{smem_raw + (base - raw_addr), base};

  const int head = blockIdx.x % bhg;
  const int rank = blockIdx.x / bhg;
  const int kv_head = head / g;
  int f_lo, t_begin, t_end, f_rows;
  if constexpr (kKV) {
    // key tiles: the first have the most live query tiles under a causal
    // mask; live query tiles are none wholly above the diagonal (i >= j)
    // nor wholly past the window (i - j < window)
    f_lo = rank * kBlockF;
    f_rows = skv;
    const int f_hi = min(f_lo + kBlockF, skv) - 1;
    const int nt = (sq + kBt - 1) / kBt;
    t_begin = causal ? f_lo / kBt : 0;
    t_end = nt;
    if (window > 0) t_end = min(nt, (f_hi + window - 1) / kBt + 1);
  } else {
    const int nf = (sq + kBlockF - 1) / kBlockF;
    f_lo = (nf - 1 - rank) * kBlockF;
    f_rows = sq;
    const int f_hi = min(f_lo + kBlockF, sq) - 1;
    const int nt = (skv + kBt - 1) / kBt;
    t_begin = 0;
    if (window > 0 && f_lo - window + 1 > 0)
      t_begin = (f_lo - window + 1) / kBt;
    t_end = causal ? min(nt, f_hi / kBt + 1) : nt;
  }
  const int n_tiles = max(0, t_end - t_begin);
  const int f_head = kKV ? kv_head : head;
  const int t_head = kKV ? head : kv_head;

  const uint32_t bar_f = sm.at(P::kBars);
  if (threadIdx.x == 0) {
    mbar_init(bar_f, 1);
    for (int s = 0; s < P::kStages; ++s)
      mbar_init(bar_full<P>(sm, s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) {
    mbar_expect_tx(bar_f, P::kF1Box + P::kF2Box);
    tma_load_tile(sm.at(P::kF1), &f1_map, f_lo, f_head, bar_f);
    tma_load_tile(sm.at(P::kF2), &f2_map, f_lo, f_head, bar_f);
    for (int it = 0; it < min(n_tiles, P::kStages); ++it)
      load_t<P>(sm, &t1_map, &t2_map, it, (t_begin + it) * kBt, t_head);
  }

  const int wg = threadIdx.x / 128;
  const int wtid = threadIdx.x % 128;
  const int lane = wtid % 32;
  const int tq = lane % 4;
  const int r0 = 16 * (wtid / 32) + lane / 4;  // rows r0 and r0 + 8 of F
  // the 8-column groups of the score tile whose p and dS this warpgroup
  // forms (both with one warpgroup)
  auto own = [&](int j) {
    return P::kGroups == 1 || j / (kJ / 2) == wg;
  };
  float acc1[P::kAcc1], acc2[P::kAcc2];
#pragma unroll
  for (int i = 0; i < P::kAcc1; ++i) acc1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < P::kAcc2; ++i) acc2[i] = 0.f;
  // the dQ pass: lse and Delta of this thread's two query rows
  float f_lse[2] = {0.f, 0.f}, f_delta[2] = {0.f, 0.f};
  if constexpr (!kKV) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = f_lo + r0 + 8 * h;
      if (r < sq) {
        f_lse[h] = lse[static_cast<size_t>(head) * sq + r];
        f_delta[h] = delta[static_cast<size_t>(head) * sq + r];
      }
    }
  }
  if (n_tiles > 0) mbar_wait(bar_f, 0);

#pragma unroll 1
  for (int it = 0; it < n_tiles; ++it) {
    const int s_ix = it % P::kStages;
    const int stage = P::kRing + s_ix * P::kStageBytes;
    const int t_lo = (t_begin + it) * kBt;
    // the dK/dV pass: lse and Delta of the tile's query rows, read after
    // the next barrier (the last tile's reads came before its Z barrier)
    float* t_rows = sm.p<float>(P::kRows);
    if constexpr (kKV) {
      if (threadIdx.x < kBt) {
        const int qp = t_lo + threadIdx.x;
        const size_t at = static_cast<size_t>(head) * sq + qp;
        t_rows[threadIdx.x] = qp < sq ? lse[at] : 0.f;
        t_rows[64 + threadIdx.x] = qp < sq ? delta[at] : 0.f;
      }
    }
    mbar_wait(bar_full<P>(sm, s_ix), (it / P::kStages) & 1);
    if constexpr (P::kSplit1 || P::kSplit2) {
      if constexpr (P::kSplit1)
        split_tile<P::kT1Box, P::kThreads>(sm, stage, stage + P::kT1Lo);
      if constexpr (P::kSplit2)
        split_tile<P::kT2Box, P::kThreads>(sm, stage + P::kT2,
                                           stage + P::kT2Lo);
      fence_proxy_async();
      __syncthreads();
    }

    // X1 = F1 T1^T and X2 = F2 T2^T over this warpgroup's half of D
    float x1[kBt / 2], x2[kBt / 2];
    if constexpr (!P::kSplit2)
      score_bf16<P::kW2, kBt, D / 16 / P::kGroups>(
          sm, P::kF2, stage + P::kT2, wg * (D / 16 / P::kGroups), x2);
    if constexpr (P::kSplit1)
      score_tf32x3<P::kW1, kBt, D / 8 / P::kGroups>(
          sm, P::kF1, stage, stage + P::kT1Lo, wg * (D / 8 / P::kGroups),
          x1);
    else
      score_bf16<P::kW1, kBt, D / 16 / P::kGroups>(
          sm, P::kF1, stage, wg * (D / 16 / P::kGroups), x1);
    if constexpr (P::kSplit2)
      score_tf32x3<P::kW2, kBt, D / 8 / P::kGroups>(
          sm, P::kF2, stage + P::kT2, stage + P::kT2Lo,
          wg * (D / 8 / P::kGroups), x2);
    wgmma_wait<0>();
    fence_regs(x1);
    fence_regs(x2);

    // two warpgroups: each hands the other its partial sums of the other's
    // columns, thread for thread (a thread's fragment positions depend only
    // on its place in its warpgroup), and adds the other's to its own
    if constexpr (P::kGroups == 2) {
      float* xf = sm.p<float>(P::kX);
      constexpr int kHalf = kJ / 2 * 4;  // values a thread a matrix a half
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int at = (j / (kJ / 2) * 2 * kHalf + j % (kJ / 2) * 4 + i) *
                         128 + wtid;
          if (!own(j)) {
            xf[at] = x1[4 * j + i];
            xf[at + kHalf * 128] = x2[4 * j + i];
          }
        }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int at = (j / (kJ / 2) * 2 * kHalf + j % (kJ / 2) * 4 + i) *
                         128 + wtid;
          if (own(j)) {
            x1[4 * j + i] += xf[at];
            x2[4 * j + i] += xf[at + kHalf * 128];
          }
        }
    }

    // (the rows' lse and Delta written above are visible after a barrier:
    // the split's or the exchange's, else this one)
    if constexpr (kKV && !P::kSplit1 && !P::kSplit2 && P::kGroups == 1)
      __syncthreads();

    // p and dS of this warpgroup's columns, into Z.  F row r0 + 8h, T row
    // 8j + 2tq + e: element 4j + 2h + e.
    int qa, qb, ka, kb;  // the tile pair's query and key ranges
    if constexpr (kKV) {
      ka = f_lo; kb = f_lo + kBlockF - 1; qa = t_lo; qb = t_lo + kBt - 1;
    } else {
      qa = f_lo; qb = f_lo + kBlockF - 1; ka = t_lo; kb = t_lo + kBt - 1;
    }
    const bool all_live = qb < sq && kb < skv && (!causal || qa >= kb) &&
                          (window <= 0 || qb - ka < window);
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      if (!own(j)) continue;
      float pv[2][2], dsv[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const int fr = f_lo + r0 + 8 * h;
          const int tr = t_lo + 8 * j + 2 * tq + e;
          const int qp = kKV ? tr : fr;
          const int kp = kKV ? fr : tr;
          float l_i, d_i;
          if constexpr (kKV) {
            l_i = t_rows[tr - t_lo];
            d_i = t_rows[64 + tr - t_lo];
          } else {
            l_i = f_lse[h];
            d_i = f_delta[h];
          }
          float x = x1[i], th = 0.f;
          if (softcap > 0.f) {
            th = tanhf(x / softcap);
            x = softcap * th;
          }
          float p = 0.f, ds = 0.f;
          if (all_live || live(qp, kp, sq, skv, causal, window)) {
            p = expf(x - l_i);
            ds = p * (x2[i] - d_i);
            if (softcap > 0.f) ds *= 1.f - th * th;
          }
          pv[h][e] = p;
          dsv[h][e] = ds;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        const int col = 8 * j + 2 * tq;
        if constexpr (P::kSplit1)
          z_store_tf32<P::kWz1>(sm, P::kZ1, P::kZ1 + P::kZ1Lo, row, col,
                                dsv[h][0], dsv[h][1]);
        else
          z_store_bf16<P::kWz1>(sm, P::kZ1, row, col, dsv[h][0], dsv[h][1]);
        if constexpr (kKV) {
          if constexpr (P::kSplit2)
            z_store_tf32<P::kWz2>(sm, P::kZ2, P::kZ2 + P::kZ2Lo, row, col,
                                  pv[h][0], pv[h][1]);
          else
            z_store_bf16<P::kWz2>(sm, P::kZ2, row, col, pv[h][0], pv[h][1]);
        }
      }
    }
    fence_proxy_async();
    __syncthreads();

    // the gradient products over this warpgroup's D columns: dK (dQ) from
    // dS and T1, dV from p and T2.  The bf16 ones are issued first and
    // overlap the float32 ones' fragment loads.
    const int d0 = wg * P::kDPart;
    if constexpr (kKV && !P::kSplit2)
      grad_bf16<P::kDPart, P::kWz2, P::kW2, kBt>(
          sm, P::kZ2, stage + P::kT2 + d0 * 2 / P::kW2 * kBt * P::kW2,
          acc2);
    if constexpr (!P::kSplit1)
      grad_bf16<P::kDPart, P::kWz1, P::kW1, kBt>(
          sm, P::kZ1, stage + d0 * 2 / P::kW1 * kBt * P::kW1, acc1);
    else
      grad_tf32x3<D, P::kChunks, kBt, P::kW1, P::kWz1>(
          sm, stage, stage + P::kT1Lo, P::kZ1, P::kZ1 + P::kZ1Lo, d0, acc1);
    if constexpr (kKV && P::kSplit2)
      grad_tf32x3<D, P::kChunks, kBt, P::kW2, P::kWz2>(
          sm, stage + P::kT2, stage + P::kT2Lo, P::kZ2, P::kZ2 + P::kZ2Lo,
          d0, acc2);
    wgmma_wait<0>();
    fence_regs(acc1);
    if constexpr (kKV) fence_regs(acc2);
    // every thread is done with the stage, Z and the exchange
    __syncthreads();
    if (threadIdx.x == 0 && it + P::kStages < n_tiles)
      load_t<P>(sm, &t1_map, &t2_map, it + P::kStages,
                (t_begin + it + P::kStages) * kBt, t_head);
  }

  // write out: the dQ pass dQ [BHG, Sq, D]; the dK/dV pass dK and dV
  // [BHkv, Skv, D], or float32 partials [BHG, Skv, D]
  const int d0 = wg * P::kDPart;
  const int o_head = kKV && !partial ? kv_head : head;
  const size_t o_at = static_cast<size_t>(o_head) * f_rows * D;
  if constexpr (P::kSplit1)
    store_transposed<D, P::kChunks>(acc1, static_cast<float*>(out1) + o_at,
                                    f_lo, f_rows, d0);
  else if (partial)
    store_natural<D, P::kDPart>(acc1, static_cast<float*>(out1) + o_at,
                                false, f_lo, f_rows, d0);
  else
    store_natural<D, P::kDPart>(acc1, static_cast<uint16_t*>(out1) + o_at,
                                true, f_lo, f_rows, d0);
  if constexpr (kKV) {
    if constexpr (P::kSplit2)
      store_transposed<D, P::kChunks>(acc2, static_cast<float*>(out2) + o_at,
                                      f_lo, f_rows, d0);
    else if (partial)
      store_natural<D, P::kDPart>(acc2, static_cast<float*>(out2) + o_at,
                                  false, f_lo, f_rows, d0);
    else
      store_natural<D, P::kDPart>(acc2, static_cast<uint16_t*>(out2) + o_at,
                                  true, f_lo, f_rows, d0);
  }
}

// Delta_i = sum_d dO_id O_id, one warp a row.  With `dout_v` (the model's
// build: float32 dO, bf16 v) it also writes dO rounded to bf16 there, and
// Delta is taken over the rounded dO, as the main passes' dP is.
template <typename EQK>
__global__ void __launch_bounds__(kThreadsAux)
flash_bwd_delta_kernel(const typename EQK::T* __restrict__ o,
                       const typename EQK::T* __restrict__ dout,
                       float* __restrict__ delta,
                       uint16_t* __restrict__ dout_v, long long n_rows,
                       int d) {
  const long long row = static_cast<long long>(blockIdx.x) *
                            (kThreadsAux / 32) + threadIdx.x / 32;
  if (row >= n_rows) return;
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  for (int i = lane; i < d; i += 32) {
    const size_t at = static_cast<size_t>(row) * d + i;
    float x = EQK::load(dout, at);
    if (dout_v != nullptr) {
      const uint32_t b = float_to_bf16_bits(x);
      dout_v[at] = static_cast<uint16_t>(b);
      x = __uint_as_float(b << 16);
    }
    acc = fmaf(x, EQK::load(o, at), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// out[kv, r] = sum over h = 0 .. g - 1, in that order, of part[kv g + h, r]
// (r over a KV head's Skv x D values), in out's dtype; four values a thread
template <typename E>
__global__ void __launch_bounds__(kThreadsAux)
flash_bwd_sum_heads_kernel(const float4* __restrict__ part,
                           typename E::T* __restrict__ out, long long n4,
                           long long total4, int g) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreadsAux + threadIdx.x;
  if (i >= total4) return;
  const long long kv = i / n4, r = i % n4;
  float4 a = part[kv * g * n4 + r];
  for (int h = 1; h < g; ++h) {
    const float4 b = part[(kv * g + h) * n4 + r];
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  if constexpr (E::kBytes == 4) {
    reinterpret_cast<float4*>(out)[i] = a;
  } else {
    reinterpret_cast<uint2*>(out)[i] =
        make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
  }
}

// -- host side -------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (the library
// links no libcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [heads, rows, d] tensor seen as [heads, d / w blocks, rows, w bytes],
// so that one copy brings box_rows rows as column blocks of box_rows x w
// bytes one after another, each swizzled by w bytes; rows past `rows` read
// as zeros.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int bytes,
              const void* ptr, int d, int rows, int heads, int box_rows,
              int w) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(d) * bytes;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(w / bytes),
                              static_cast<cuuint64_t>(rows),
                              row_bytes / w, static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[3] = {row_bytes, static_cast<cuuint64_t>(w),
                                 row_bytes * rows};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(w / bytes),
                             static_cast<cuuint32_t>(box_rows),
                             static_cast<cuuint32_t>(row_bytes / w), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      w == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
               : (w == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// The workspace: Delta (float32 [bhg, sq]); dO rounded to bf16 ([bhg, sq, d],
// the model's build only); float32 dK and dV partials ([bhg, skv, d] each,
// G > 1 only).
struct Work {
  size_t delta = 0, dout_v = 0, part_k = 0, part_v = 0, total = 0;
  Work(int bhg, int g, int sq, int skv, int d, bool mixed) {
    total = align256(static_cast<size_t>(bhg) * sq * 4);
    if (mixed) {
      dout_v = total;
      total += align256(static_cast<size_t>(bhg) * sq * d * 2);
    }
    if (g > 1) {
      part_k = total;
      total += align256(static_cast<size_t>(bhg) * skv * d * 4);
      part_v = total;
      total += align256(static_cast<size_t>(bhg) * skv * d * 4);
    }
  }
};

template <typename EQK, typename EV, int D, bool kKV>
cudaError_t launch_pass(const CUtensorMap& f1, const CUtensorMap& f2,
                        const CUtensorMap& t1, const CUtensorMap& t2,
                        const float* lse, const float* delta, void* out1,
                        void* out2, int partial, int bhg, int g, int sq,
                        int skv, int causal, int window, float softcap,
                        cudaStream_t stream) {
  using P = Plan<EQK, EV, D, kKV>;
  // once a process (and device: the port runs on one)
  static const cudaError_t set = cudaFuncSetAttribute(
      flash_bwd_kernel<EQK, EV, D, kKV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (set != cudaSuccess) return set;
  const long long n_f = ((kKV ? skv : sq) + kBlockF - 1) / kBlockF;
  const long long blocks = n_f * bhg;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_kernel<EQK, EV, D, kKV>
      <<<static_cast<unsigned>(blocks), P::kThreads, P::kSmem, stream>>>(
          f1, f2, t1, t2, lse, delta, out1, out2, partial, bhg, g, sq, skv,
          causal, window, softcap);
  return cudaGetLastError();
}

template <typename EQK, typename EV, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, void* work, void* dq,
           void* dk, void* dv, int bhg, int g, int sq, int skv, int causal,
           int window, float softcap, cudaStream_t stream) {
  using TQ = typename EQK::T;
  using PK = Plan<EQK, EV, D, true>;
  using PQ = Plan<EQK, EV, D, false>;
  constexpr bool kMixed = EQK::kBytes != EV::kBytes;
  const int bhkv = bhg / g;
  const Work w(bhg, g, sq, skv, D, kMixed);
  uint8_t* ws = static_cast<uint8_t*>(work);
  float* delta = reinterpret_cast<float*>(ws + w.delta);
  // dO as the main passes read it: v's dtype
  const void* dout_v = kMixed ? static_cast<const void*>(ws + w.dout_v) : dout;

  const long long rows = static_cast<long long>(bhg) * sq;
  const long long delta_blocks =
      (rows + kThreadsAux / 32 - 1) / (kThreadsAux / 32);
  if (delta_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_delta_kernel<EQK>
      <<<static_cast<unsigned>(delta_blocks), kThreadsAux, 0, stream>>>(
      static_cast<const TQ*>(o), static_cast<const TQ*>(dout), delta,
      kMixed ? reinterpret_cast<uint16_t*>(ws + w.dout_v) : nullptr, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // the dK/dV pass: F = k, v (64-key tiles), T = q, dO (PK::kBt rows)
  CUtensorMap f1, f2, t1, t2;
  if (!make_map(&f1, EQK::kMapType, EQK::kBytes, k, D, skv, bhkv, kBlockF,
                PK::kW1) ||
      !make_map(&f2, EV::kMapType, EV::kBytes, v, D, skv, bhkv, kBlockF,
                PK::kW2) ||
      !make_map(&t1, EQK::kMapType, EQK::kBytes, q, D, sq, bhg, PK::kBt,
                PK::kW1) ||
      !make_map(&t2, EV::kMapType, EV::kBytes, dout_v, D, sq, bhg, PK::kBt,
                PK::kW2))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool partial = g > 1;
  err = launch_pass<EQK, EV, D, true>(
      f1, f2, t1, t2, lse, delta, partial ? ws + w.part_k : dk,
      partial ? ws + w.part_v : dv, partial, bhg, g, sq, skv, causal, window,
      softcap, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (partial) {
    const long long n4 = static_cast<long long>(skv) * D / 4;
    const long long total4 = n4 * bhkv;
    const long long blocks = (total4 + kThreadsAux - 1) / kThreadsAux;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    flash_bwd_sum_heads_kernel<EQK>
        <<<static_cast<unsigned>(blocks), kThreadsAux, 0, stream>>>(
        reinterpret_cast<const float4*>(ws + w.part_k),
        static_cast<typename EQK::T*>(dk), n4, total4, g);
    flash_bwd_sum_heads_kernel<EV>
        <<<static_cast<unsigned>(blocks), kThreadsAux, 0, stream>>>(
        reinterpret_cast<const float4*>(ws + w.part_v),
        static_cast<typename EV::T*>(dv), n4, total4, g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  // the dQ pass: F = q, dO (64-row tiles), T = k, v (PQ::kBt keys)
  if (!make_map(&f1, EQK::kMapType, EQK::kBytes, q, D, sq, bhg, kBlockF,
                PQ::kW1) ||
      !make_map(&f2, EV::kMapType, EV::kBytes, dout_v, D, sq, bhg, kBlockF,
                PQ::kW2) ||
      !make_map(&t1, EQK::kMapType, EQK::kBytes, k, D, skv, bhkv, PQ::kBt,
                PQ::kW1) ||
      !make_map(&t2, EV::kMapType, EV::kBytes, v, D, skv, bhkv, PQ::kBt,
                PQ::kW2))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_pass<EQK, EV, D, false>(
      f1, f2, t1, t2, lse, delta, dq, nullptr, 0, bhg, g, sq, skv, causal,
      window, softcap, stream));
}

template <typename EQK, typename EV>
int launch_d(int d, const void* q, const void* k, const void* v,
             const void* o, const void* dout, const float* lse, void* work,
             void* dq, void* dk, void* dv, int bhg, int g, int sq, int skv,
             int causal, int window, float softcap, cudaStream_t stream) {
#define FLASH_BWD_CASE(D)                                                   \
  case D:                                                                   \
    return launch<EQK, EV, D>(q, k, v, o, dout, lse, work, dq, dk, dv, bhg, \
                              g, sq, skv, causal, window, softcap, stream);
  switch (d) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(128)
    FLASH_BWD_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_BWD_CASE
}

bool valid(int bhg, int g, int sq, int skv, int d, int qk_dtype,
           int v_dtype) {
  return bhg > 0 && sq > 0 && skv > 0 && g > 0 && bhg % g == 0 &&
         (d == 16 || d == 32 || d == 64 || d == 128 || d == 256) &&
         (qk_dtype == kFloat32 || qk_dtype == kBFloat16) &&
         (v_dtype == kFloat32 || v_dtype == kBFloat16) &&
         !(qk_dtype == kBFloat16 && v_dtype == kFloat32);
}

}  // namespace

// Bytes of the workspace `flash_attention_bwd_launch` takes for these
// operands (-1 for operands it does not take).
extern "C" long long flash_attention_bwd_workspace(int bhg, int g, int sq,
                                                   int skv, int d,
                                                   int qk_dtype,
                                                   int v_dtype) {
  if (!valid(bhg, g, sq, skv, d, qk_dtype, v_dtype)) return -1;
  return static_cast<long long>(
      Work(bhg, g, sq, skv, d, qk_dtype != v_dtype).total);
}

// q, o, dout, dq: [bhg, sq, d] of `qk_dtype`; k, dk: [bhg / g, skv, d] of
// `qk_dtype`; v, dv: [bhg / g, skv, d] of `v_dtype` (0 float32, 1 bfloat16:
// both float32, both bfloat16, or float32 q and k with bfloat16 v); lse (the
// forward's): float32 [bhg, sq]; work: scratch of
// flash_attention_bwd_workspace(...) bytes, 256-byte aligned.  All
// contiguous on the device, 16-byte aligned.  d in {16, 32, 64, 128, 256};
// sq, skv >= 1.  window <= 0 means none, softcap <= 0 means none.  Launches
// three kernels (four with g > 1) on `stream`; returns the first
// cudaGetLastError() that is not success (cudaErrorInvalidValue for an
// unsupported dtype pair or d, or a tensor map the driver refuses).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* work, void* dq, void* dk,
    void* dv, int bhg, int g, int sq, int skv, int d, int qk_dtype,
    int v_dtype, int causal, int window, float softcap, void* stream) {
  if (!valid(bhg, g, sq, skv, d, qk_dtype, v_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  if (qk_dtype == kFloat32 && v_dtype == kFloat32)
    return launch_d<F32, F32>(d, q, k, v, o, dout, l, work, dq, dk, dv, bhg,
                              g, sq, skv, causal, window, softcap, s);
  if (qk_dtype == kBFloat16 && v_dtype == kBFloat16)
    return launch_d<BF16, BF16>(d, q, k, v, o, dout, l, work, dq, dk, dv,
                                bhg, g, sq, skv, causal, window, softcap, s);
  return launch_d<F32, BF16>(d, q, k, v, o, dout, l, work, dq, dk, dv, bhg,
                             g, sq, skv, causal, window, softcap, s);
}

// The plan of one build's pass (kv: the dK/dV pass, else the dQ pass):
// out[0..4] = streamed tile rows, stages, warpgroups a block, blocks an SM,
// shared memory bytes a block.  Returns 0, or -1 for a build there is not.
extern "C" int flash_attention_bwd_plan(int d, int qk_dtype, int v_dtype,
                                        int kv, int* out) {
  if (!valid(1, 1, 1, 1, d, qk_dtype, v_dtype)) return -1;
  int r = -1;
  auto put = [&](auto plan) {
    using P = decltype(plan);
    const int v[5] = {P::kBt, P::kStages, P::kGroups, P::kBlocksPerSM,
                      P::kSmem};
    for (int i = 0; i < 5; ++i) out[i] = v[i];
    r = 0;
  };
  auto by_d = [&](auto e_qk, auto e_v, auto kv_tag) {
    using EQK = decltype(e_qk);
    using EV = decltype(e_v);
    constexpr bool KV = decltype(kv_tag)::value;
    switch (d) {
      case 16: put(Plan<EQK, EV, 16, KV>{}); break;
      case 32: put(Plan<EQK, EV, 32, KV>{}); break;
      case 64: put(Plan<EQK, EV, 64, KV>{}); break;
      case 128: put(Plan<EQK, EV, 128, KV>{}); break;
      case 256: put(Plan<EQK, EV, 256, KV>{}); break;
    }
  };
  auto by_pass = [&](auto e_qk, auto e_v) {
    if (kv)
      by_d(e_qk, e_v, std::true_type{});
    else
      by_d(e_qk, e_v, std::false_type{});
  };
  if (qk_dtype == kFloat32 && v_dtype == kFloat32)
    by_pass(F32{}, F32{});
  else if (qk_dtype == kBFloat16)
    by_pass(BF16{}, BF16{});
  else
    by_pass(F32{}, BF16{});
  return r;
}

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
