// Fused flash attention, forward, for Hopper's tensor cores: one CUDA block
// per (query head, 64-row query tile), online softmax over 32-key tiles, both
// products on wgmma, the K and V tiles brought in by TMA.
//
// Replaces the Pallas kernel `_flash_fwd_kernel` (src/repro/kernels/
// flash_attention/kernel.py, wrapped by `flash_attention_fwd_pallas`,
// registered as op `flash_attention_fwd`).
//
// What it computes, as the Pallas kernel does: q [BHG, Sq, D] (already scaled
// by 1/sqrt(D)), k and v [BHkv, Skv, D], query head h reading KV head h / G.
// q and k share one dtype and v may have another: in a bf16 model q and k
// come out of RoPE in float32 (its float32 tables promote them) and v stays
// bf16.  s = q.k^T in float32, an optional softcap * tanh(s / softcap), the
// mask (q_pos < Sq, k_pos < Skv, causal q_pos >= k_pos, window q_pos - k_pos
// < window), online softmax with float32 running max m and sum l, p rounded
// to v's dtype before the PV product, float32 accumulation, and acc / max(l,
// 1e-30) written in q's dtype.  The Pallas kernel writes -1e30 on a masked
// score and lets exp() of it vanish once a later block raises m; a row whose
// every score in a block is masked while m is still -1e30 then takes p = 1
// for every key of that block, and only a later block's alpha = 0 wipes it
// out.  Here a masked score gets p = 0 outright, so the result does not hang
// on the order of the key tiles; on every row that has a key it is the same.
//
// What bounds it on the H100, at gemma3-1b's prefill shapes (G = 4 query
// heads on one KV head, D = 256; S = 32,768, causal global layers and
// window-512 local layers; float32 q and k, bf16 v): the products.  A global
// layer's live (q, k) pairs are about 4 * S^2 / 2 = 2.1e9, each 2 * D = 512
// flops for q.k^T and 512 for p.v: 1.1e12 flops each.  p.v in bf16 takes
// 1.1 ms at the tensor cores' 989 TFLOP/s.  q.k^T must keep float32's
// accuracy: one TF32 pass (10-bit mantissa) misses the float32 check by 17x,
// so it is three TF32 passes at 495 TFLOP/s, 6.7 ms.  q/k/v/o move 0.02 ms
// at 3.35 TB/s.  So the bound is operations, about 7.8 ms.
//
// The design:
// - Both products on wgmma.  bf16 operands go in as they are (float32
//   accumulation).  A float32 operand x is split as hi = rna_tf32(x), lo =
//   rna_tf32(x - hi), and a product is hi*lo + lo*hi + hi*hi (lo*lo
//   dropped), all in float32: q.k^T keeps the three passes in three
//   accumulators and adds the small ones first, p.v (float32 v) takes
//   hi*lo and lo*hi before hi*hi at each k8 step, into a fresh accumulator
//   per tile that is added to the output in registers (wgmma's own
//   accumulation is not round-to-nearest; over a 32k row it missed
//   float32's tolerance).
// - Two warpgroups of 128 threads share the block's 64 query rows and take
//   alternate key tiles, each with its own m, l and output; at the end the
//   second hands its partial sums to the first through shared memory, which
//   merges them as the online softmax merges two key ranges.  While one
//   warpgroup runs its softmax, the other's wgmmas keep the tensor cores
//   busy.
// - K and V tiles arrive by TMA (cp.async.bulk.tensor, swizzled) into a ring
//   of stages, with an mbarrier each for K and for V.  Each warpgroup owns
//   every other stage and its first thread issues that stage's copies: K
//   again as soon as q.k^T is done (the copy overlaps the softmax and p.v),
//   V after p.v.  There is no producer warpgroup: with a third warpgroup in
//   the block, ptxas (CUDA 12.8) gave every thread 168 registers whether or
//   not setmaxnreg moved them at run time, and the D = 256 builds spilled
//   (the output alone is D / 2 = 128 float32 registers a thread); with two
//   warpgroups a thread may have 255.
// - A float32 K tile is split in place by its warpgroup once it lands, tf32
//   hi over the raw tile and lo beside it; a float32 V tile is transposed
//   into V^T hi and lo, since tf32 wgmma takes only K-major operands.
// - Q stays in shared memory as loaded.  bf16 Q is wgmma's shared-memory A
//   operand; float32 Q is read back at each k8 step into A fragment
//   registers (one ldmatrix) and split there (8 registers a step, kInFlight
//   steps in flight).
// - The softmax works in base 2 (p = 2^(s log2 e - m)), skips the mask on
//   tiles whose every pair is live, and rescales the output only when some
//   row's max moved.
// - p never leaves registers: the q.k^T accumulator is laid out as wgmma's
//   A fragment, so p is rounded to bf16 (bf16 v) or split (float32 v) in
//   place.  For tf32 the fragment takes keys 2t and 2t + 1 where it names
//   t and t + 4, so V^T's key columns are written in that order.
// - The budget at D = 256 with float32 q and k and bf16 v (the model's): Q
//   64 KB resident and two stages of K hi and lo (2 x 32 KB) and V (16 KB),
//   224 KB of the 227 KB (232,448 bytes) a block can have; one block per
//   SM.  The stage count is computed per build from that budget (at most 4,
//   a multiple of the warpgroups).  All-float32 at D = 256 has room for one
//   stage (K hi and lo, V^T hi and lo, the raw V tile: 160 KB), so it runs
//   one warpgroup.
// - Key tiles wholly above the diagonal or wholly outside the window are
//   never visited (the dead-block skip of the Pallas kernel, as loop
//   bounds); under a causal mask the longest query tiles start first.
//   Rows past Sq and keys past Skv arrive as zeros (TMA's bounds fill) and
//   are masked.

#include <cstdint>
#include <cuda.h>  // CUtensorMap; its encoder is fetched at run time
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;    // query rows: the M of one warpgroup's wgmma
constexpr int kBlockK = 32;    // keys per tile
constexpr int kInFlight = 4;   // float32 q.k^T: k8 steps in flight
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;  // a block's shared memory on the H100
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// dtype codes of the C interface
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

struct F32 {
  using T = float;
  static constexpr int kBytes = 4;
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

struct BF16 {
  using T = uint16_t;  // bf16 bits
  static constexpr int kBytes = 2;
  static constexpr CUtensorMapDataType kMapType =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

// Shared-memory plan of one build.  Every tile is stored as TMA's swizzle
// lays it out: rows of W bytes (W = the row's bytes, at most 128), a tile of
// R rows wider than W as column blocks of R x W bytes one after another.
template <typename EQK, typename EV, int D>
struct Plan {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256, "D");
  static constexpr bool kSplitQK = EQK::kBytes == 4;  // 3xTF32 q.k^T
  static constexpr bool kSplitV = EV::kBytes == 4;    // 3xTF32 p.v
  static constexpr int kWq = cmin(128, D * EQK::kBytes);  // Q and K rows
  static constexpr int kWv = cmin(128, D * EV::kBytes);   // V rows as loaded
  static constexpr int kQBytes = kBlockQ * D * EQK::kBytes;
  static constexpr int kKBytes = kBlockK * D * EQK::kBytes;
  static constexpr int kVBytes = kBlockK * D * EV::kBytes;
  // a stage: K (tf32 hi, then lo, when split); V as loaded, or V^T's tf32 hi
  // and lo (D rows of 32 keys, 128 bytes) and the raw V tile they come from
  static constexpr int kKLo = kKBytes;
  static constexpr int kV = kKBytes * (kSplitQK ? 2 : 1);
  static constexpr int kVLo = kV + kVBytes;
  static constexpr int kVRaw = kV + 2 * kVBytes;
  static constexpr int kStageBytes = kV + kVBytes * (kSplitV ? 3 : 1);
  static constexpr int kBarBytes = 128;
  // 1024 bytes of slack to align the base to the 128-byte swizzle's period
  static constexpr int kFit =
      (kSmemLimit - 1024 - kQBytes - kBarBytes) / kStageBytes;
  static_assert(kFit >= 1, "shared memory budget");
  // two warpgroups where two stages fit, each owning every other stage (so
  // no mbarrier is ever waited on a phase ahead); else one
  static constexpr int kGroups = kFit >= 2 ? 2 : 1;
  static constexpr int kStages =
      cmin(kMaxStages, kFit) / kGroups * kGroups;
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kRing = kQBytes;
  static constexpr int kBars = kRing + kStages * kStageBytes;
  static constexpr int kSmem = kBars + kBarBytes + 1024;
  // the warpgroups' merge reuses Q and the ring: acc, m, l of 128 threads
  static_assert(kGroups == 1 || kBars >= (D / 2 + 4) * 128 * 4, "merge");
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
//   mma_bf16_ss: A and B from shared memory, both K-major.
//   mma_tf32_rs: A from registers, B K-major.
//   mma_bf16_rs_mn: A from registers, B MN-major.
template <int N>
__device__ __forceinline__ void mma_bf16_ss(float (&d)[N / 2], uint64_t a,
                                            uint64_t b, int scale_d);
template <int N>
__device__ __forceinline__ void mma_tf32_rs(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d);
template <int N>
__device__ __forceinline__ void mma_bf16_rs_mn(float (&d)[N / 2],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d);

#define ACC8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

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
__device__ __forceinline__ void mma_bf16_rs_mn<16>(
    float (&d)[8], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : ACC8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_bf16_rs_mn<32>(
    float (&d)[16], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_bf16_rs_mn<64>(
    float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_bf16_rs_mn<128>(
    float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40),
        ACC8(48), ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_bf16_rs_mn<256>(
    float (&d)[128], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, "
      "%11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, "
      "%33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, "
      "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
      "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, "
      "%99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, "
      "%121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40),
        ACC8(48), ACC8(56), ACC8(64), ACC8(72), ACC8(80), ACC8(88),
        ACC8(96), ACC8(104), ACC8(112), ACC8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}


#undef ACC8

// -- the kernel ------------------------------------------------------------

struct Smem {
  uint8_t* ptr;   // generic pointer of the aligned base
  uint32_t addr;  // its shared-memory address
  __device__ uint32_t at(int off) const { return addr + off; }
  template <typename T>
  __device__ T* p(int off) const {
    return reinterpret_cast<T*>(ptr + off);
  }
};

// barriers after the ring: q_full, k_loaded[kMaxStages], v_loaded[..]
__device__ __forceinline__ uint32_t bar_q(const Smem& sm, int bars) {
  return sm.at(bars);
}
__device__ __forceinline__ uint32_t bar_k(const Smem& sm, int bars, int s) {
  return sm.at(bars + 8 * (1 + s));
}
__device__ __forceinline__ uint32_t bar_v(const Smem& sm, int bars, int s) {
  return sm.at(bars + 8 * (1 + kMaxStages + s));
}

// TMA copies of the K (or V) tile of keys k_lo .. k_lo + 31 into stage s,
// issued by one thread; the stage's k (v) barrier completes when they land.
template <typename EQK, typename EV, int D>
__device__ __forceinline__ void load_k(const Smem& sm, const CUtensorMap* map,
                                       int s, int k_lo, int kv_head) {
  using P = Plan<EQK, EV, D>;
  const int dst = P::kRing + s * P::kStageBytes;
  const uint32_t bar = bar_k(sm, P::kBars, s);
  // the warpgroup's generic writes to this stage come before the copy's
  fence_proxy_async();
  mbar_expect_tx(bar, P::kKBytes);
  tma_load_tile(sm.at(dst), map, k_lo, kv_head, bar);
}

template <typename EQK, typename EV, int D>
__device__ __forceinline__ void load_v(const Smem& sm, const CUtensorMap* map,
                                       int s, int k_lo, int kv_head) {
  using P = Plan<EQK, EV, D>;
  const int dst =
      P::kRing + s * P::kStageBytes + (P::kSplitV ? P::kVRaw : P::kV);
  const uint32_t bar = bar_v(sm, P::kBars, s);
  fence_proxy_async();
  mbar_expect_tx(bar, P::kVBytes);
  tma_load_tile(sm.at(dst), map, k_lo, kv_head, bar);
}

// the 128 threads of warpgroup wg, on a named barrier of their own
__device__ __forceinline__ void warpgroup_sync(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 3, 128;\n" ::: "memory");
}

// A warpgroup readies a loaded float32 K tile for tf32 wgmma, split in
// place into hi and lo; then every thread's writes are fenced for the async
// proxy and the warpgroup synchronises on its own named barrier.
template <typename EQK, typename EV, int D>
__device__ __forceinline__ void prepare_k(const Smem& sm, int stage, int wg,
                                          int wtid) {
  using P = Plan<EQK, EV, D>;
  if constexpr (P::kSplitQK) {
    // elementwise, so the swizzle is kept
    float4* hi = sm.p<float4>(stage);
    float4* lo = sm.p<float4>(stage + P::kKLo);
#pragma unroll 4
    for (int i = wtid; i < P::kKBytes / 16; i += 128) {
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
    fence_proxy_async();
    warpgroup_sync(wg);
  }
}

// The same for a float32 V tile, transposed into V^T hi and lo.
template <typename EQK, typename EV, int D>
__device__ __forceinline__ void prepare_v(const Smem& sm, int stage, int wg,
                                          int wtid) {
  using P = Plan<EQK, EV, D>;
  if constexpr (P::kSplitV) {
    // V [32 keys][D] -> V^T [D][32 keys], K-major for tf32 wgmma, each group
    // of 8 keys in the order the A fragment of p reads them: column c holds
    // key 2c (c < 4) or 2(c - 4) + 1
    const float* raw = sm.p<float>(stage + P::kVRaw);
    float* hi = sm.p<float>(stage + P::kV);
    float* lo = sm.p<float>(stage + P::kVLo);
#pragma unroll 4
    for (int e = wtid; e < kBlockK * D; e += 128) {
      const int key = e % kBlockK;
      const int d = e / kBlockK;
      const uint32_t src = (d * 4 / P::kWv) * kBlockK * P::kWv +
                           swz<P::kWv>(key * P::kWv + (d * 4) % P::kWv);
      const int col = (key & ~7) + ((key & 7) >> 1) + 4 * (key & 1);
      const uint32_t dst = swz<128>(d * 128 + col * 4);
      uint32_t h, l;
      split_tf32(raw[src / 4], h, l);
      hi[dst / 4] = __uint_as_float(h);
      lo[dst / 4] = __uint_as_float(l);
    }
    fence_proxy_async();
    warpgroup_sync(wg);
  }
}

// s = q.k^T for this warpgroup's 64 rows and the stage's 32 keys, float32
// q and k in three tf32 passes.  Each pass has its own accumulator, so the
// three chains of wgmmas run side by side; s = hi.hi + (hi.lo + lo.hi).
template <int D, int W>
__device__ __forceinline__ void scores_tf32x3(const Smem& sm, int stage,
                                              int k_lo_off, float (&s)[16]) {
  float hl[16], lh[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = hl[i] = lh[i] = 0.f;
  fence_regs(s);
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
  for (int j = 0; j < D / 8; ++j) {
    const int cb = 32 * j + ld_col;
    uint32_t x[4];
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(x[0]), "=r"(x[1]), "=r"(x[2]), "=r"(x[3])
        : "r"(sm.at((cb / W) * kBlockQ * W + swz<W>(ld_row * W + cb % W))));
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) split_tf32(__uint_as_float(x[a]), hi[a], lo[a]);
    const uint64_t k_hi = desc_k<W>(sm.at(stage), kBlockK, j);
    const uint64_t k_lo = desc_k<W>(sm.at(stage + k_lo_off), kBlockK, j);
    wgmma_fence();
    mma_tf32_rs<32>(hl, hi, k_lo, 1);
    mma_tf32_rs<32>(lh, lo, k_hi, 1);
    mma_tf32_rs<32>(s, hi, k_hi, 1);
    wgmma_commit();
    // at most kInFlight steps in flight: the registers of older steps'
    // fragments are free again
    wgmma_wait<kInFlight - 1>();
  }
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(hl);
  fence_regs(lh);
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] += hl[i] + lh[i];
}

// s = q.k^T, bf16 q and k, both from shared memory; the even and odd k16
// steps in two accumulators, two chains of wgmmas side by side
template <int D, int W>
__device__ __forceinline__ void scores_bf16(const Smem& sm, int stage,
                                            float (&s)[16]) {
  float odd[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = odd[i] = 0.f;
  fence_regs(s);
  fence_regs(odd);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    const uint64_t a = desc_k<W>(sm.at(0), kBlockQ, j);
    const uint64_t b = desc_k<W>(sm.at(stage), kBlockK, j);
    if (j % 2 == 0)
      mma_bf16_ss<32>(s, a, b, 1);
    else
      mma_bf16_ss<32>(odd, a, b, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(odd);
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] += odd[i];
}

template <typename EQK, typename EV, int D>
__global__ void __launch_bounds__((Plan<EQK, EV, D>::kThreads), 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 typename EQK::T* __restrict__ o, float* __restrict__ lse,
                 int g, int sq, int skv, int causal, int window,
                 float softcap) {
  using P = Plan<EQK, EV, D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  const Smem sm{smem_raw + (base - raw_addr), base};

  const int head = blockIdx.y;
  const int kv_head = head / g;
  // the last query tiles have the most live key tiles under a causal mask:
  // hand them out first
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  // live key tiles: none wholly outside the window, none wholly above the
  // diagonal of this tile's last real row
  const int q_hi = min(q_lo + kBlockQ, sq) - 1;
  int kt_begin = 0;
  if (window > 0 && q_lo - window + 1 > 0)
    kt_begin = (q_lo - window + 1) / kBlockK;
  int kt_end = (skv + kBlockK - 1) / kBlockK;
  if (causal) kt_end = min(kt_end, q_hi / kBlockK + 1);
  const int n_tiles = max(0, kt_end - kt_begin);

  if (threadIdx.x == 0) {
    mbar_init(bar_q(sm, P::kBars), 1);
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(bar_k(sm, P::kBars, s), 1);
      mbar_init(bar_v(sm, P::kBars, s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;  // key tiles wg, wg + kGroups, ...
  const int wtid = threadIdx.x % 128;
  const int lane = wtid % 32;
  const int tq = lane % 4;
  // this thread's rows within the tile: row and row + 8
  const int row = 16 * (wtid / 32) + lane / 4;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q(sm, P::kBars), P::kQBytes);
    tma_load_tile(sm.at(0), &q_map, q_lo, head, bar_q(sm, P::kBars));
  }
  // each warpgroup fills its own stages (s = it % kStages) ahead
  if (wtid == 0) {
#pragma unroll 1
    for (int it = wg; it < min(n_tiles, P::kStages); it += P::kGroups) {
      load_k<EQK, EV, D>(sm, &k_map, it, (kt_begin + it) * kBlockK, kv_head);
      load_v<EQK, EV, D>(sm, &v_map, it, (kt_begin + it) * kBlockK, kv_head);
    }
  }
  mbar_wait(bar_q(sm, P::kBars), 0);

#pragma unroll 1
  for (int it = wg; it < n_tiles; it += P::kGroups) {
    const int s_ix = it % P::kStages;
    const int k_lo = (kt_begin + it) * kBlockK;
    const int stage = P::kRing + s_ix * P::kStageBytes;
    const uint32_t round = (it / P::kStages) & 1;
    // this stage's next tile: this warpgroup's tile after next
    const int next = it + P::kStages;
    mbar_wait(bar_k(sm, P::kBars, s_ix), round);
    prepare_k<EQK, EV, D>(sm, stage, wg, wtid);

    float s[16];
    if constexpr (P::kSplitQK)
      scores_tf32x3<D, P::kWq>(sm, stage, P::kKLo, s);
    else
      scores_bf16<D, P::kWq>(sm, stage, s);
    // K is done with: its refill overlaps the softmax and p v
    if (next < n_tiles) {
      warpgroup_sync(wg);
      if (wtid == 0)
        load_k<EQK, EV, D>(sm, &k_map, s_ix, (kt_begin + next) * kBlockK,
                           kv_head);
    }

    // soft-cap, mask, online softmax, in the base-2 domain: x = s log2(e),
    // m the running max of x, p = 2^(x - m).  A tile whose every (row, key)
    // pair is live skips the mask.  The 4 lanes of a row (a quad) reduce its
    // max and sum with butterflies, which leave every lane with the same
    // bits.  The output is rescaled only where some row's max moved.
    const bool all_live =
        k_lo + kBlockK <= skv && q_lo + kBlockQ <= sq &&
        (!causal || k_lo + kBlockK - 1 <= q_lo) &&
        (window <= 0 || q_lo + kBlockQ - 1 - k_lo < window);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float x = s[i];
      if (softcap > 0.f) x = softcap * tanhf(x / softcap);
      s[i] = x * kLog2e;
    }
    if (!all_live) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int qp = q_lo + row + 8 * ((i >> 1) & 1);
        const int kp = k_lo + 8 * (i >> 2) + 2 * tq + (i & 1);
        const bool live = qp < sq && kp < skv && (!causal || qp >= kp) &&
                          (window <= 0 || qp - kp < window);
        if (!live) s[i] = kNegInf;
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float rmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rmax = fmaxf(rmax, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      const float m_new = fmaxf(m[h], rmax);
      alpha[h] = exp2f(m[h] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          s[i] = s[i] == kNegInf ? 0.f : exp2f(s[i] - m_new);
          rsum += s[i];
        }
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
      l[h] = l[h] * alpha[h] + rsum;
      m[h] = m_new;
    }
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[4 * j + i] *= alpha[i >> 1];
    }

    // acc += p v, p straight from the score registers.  wgmma's own
    // accumulation is not round-to-nearest: with float32 v, where the check
    // is float32's, the tile's product goes into a fresh accumulator, kChunk
    // output columns at a time, and is added to acc in registers (across
    // the 1,024 key tiles of a 32k row, accumulating in wgmma missed
    // float32's tolerance 3x).  With bf16 v, p is rounded to bf16 (2^-8)
    // and the products accumulate in acc directly.
    mbar_wait(bar_v(sm, P::kBars, s_ix), round);
    prepare_v<EQK, EV, D>(sm, stage, wg, wtid);
    if constexpr (P::kSplitV) {
      constexpr int kChunk = D < 64 ? D : 64;
      // k8 step j: the fragment (row, t), (row + 8, t), (row, t + 4),
      // (row + 8, t + 4) takes keys 8j + 2t, 8j + 2t, 8j + 2t + 1,
      // 8j + 2t + 1 (V^T's columns are in that order)
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_tf32(s[4 * j + 0], hi[j][0], lo[j][0]);
        split_tf32(s[4 * j + 2], hi[j][1], lo[j][1]);
        split_tf32(s[4 * j + 1], hi[j][2], lo[j][2]);
        split_tf32(s[4 * j + 3], hi[j][3], lo[j][3]);
      }
#pragma unroll
      for (int c = 0; c < D / kChunk; ++c) {
        float part[kChunk / 2];
#pragma unroll
        for (int i = 0; i < kChunk / 2; ++i) part[i] = 0.f;
        fence_regs(part);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // V^T rows 64c .. of 128 bytes, k8 step j 32 bytes in
          const int off = stage + c * kChunk * 128 + 32 * j;
          const uint64_t v_hi = desc<128>(sm.at(off + P::kV), 16, 1024);
          const uint64_t v_lo = desc<128>(sm.at(off + P::kVLo), 16, 1024);
          mma_tf32_rs<kChunk>(part, lo[j], v_hi, 1);
          mma_tf32_rs<kChunk>(part, hi[j], v_lo, 1);
          mma_tf32_rs<kChunk>(part, hi[j], v_hi, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < kChunk / 2; ++i) acc[c * kChunk / 2 + i] += part[i];
      }
    } else {
      // k16 step kk: columns 16kk .. 16kk + 15 of p, rounded to bf16
      fence_regs(acc);
      uint32_t pa[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        mma_bf16_rs_mn<D>(
            acc, pa[kk],
            desc<P::kWv>(sm.at(stage + P::kV + kk * 16 * P::kWv),
                         kBlockK * P::kWv, 8 * P::kWv),
            1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    if (next < n_tiles) {
      warpgroup_sync(wg);
      if (wtid == 0)
        load_v<EQK, EV, D>(sm, &v_map, s_ix, (kt_begin + next) * kBlockK,
                           kv_head);
    }
  }

  // merge the two warpgroups' partial softmax sums: warpgroup 1 hands
  // acc, m and l to warpgroup 0 through shared memory (every tile has been
  // consumed, so Q and the ring are free), thread for thread, since a
  // thread's fragment positions depend only on its place in its warpgroup
  if constexpr (P::kGroups == 2) {
    float* xfer = sm.p<float>(0);
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) xfer[i * 128 + wtid] = acc[i];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xfer[(D / 2 + h) * 128 + wtid] = m[h];
        xfer[(D / 2 + 2 + h) * 128 + wtid] = l[h];
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (wg == 1) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m1 = xfer[(D / 2 + h) * 128 + wtid];
      const float l1 = xfer[(D / 2 + 2 + h) * 128 + wtid];
      const float m_new = fmaxf(m[h], m1);
      const float a0 = exp2f(m[h] - m_new);
      const float a1 = exp2f(m1 - m_new);
      l[h] = l[h] * a0 + l1 * a1;
      m[h] = m_new;  // for the log-sum-exp; the output needs only l
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          acc[i] = acc[i] * a0 + xfer[i * 128 + wtid] * a1;
        }
    }
  }

  // acc / max(l, 1e-30) in q's dtype; where asked, the row's log-sum-exp
  // of its live scores in the natural base, m ln 2 + ln l (+inf for a row
  // with no live key), which the backward kernel recomputes p from
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q_lo + row + 8 * h;
    if (r >= sq) continue;
    if (lse != nullptr && tq == 0)
      lse[static_cast<size_t>(head) * sq + r] =
          l[h] > 0.f ? m[h] * kLn2 + logf(l[h]) : __int_as_float(0x7f800000);
    const float den = fmaxf(l[h], 1e-30f);
    typename EQK::T* orow = o + (static_cast<size_t>(head) * sq + r) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float x0 = acc[4 * j + 2 * h] / den;
      const float x1 = acc[4 * j + 2 * h + 1] / den;
      if constexpr (P::kSplitQK)
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * tq) =
            make_float2(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * tq) =
            pack_bf16(x0, x1);
    }
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

template <typename EQK, typename EV, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bhg, int g, int sq, int skv, int causal, int window,
           float softcap, cudaStream_t stream) {
  using P = Plan<EQK, EV, D>;
  if (skv <= 0)  // no key: every output row is 0 / max(0, 1e-30) = 0
    return static_cast<int>(cudaMemsetAsync(
        o, 0, static_cast<size_t>(bhg) * sq * D * EQK::kBytes, stream));
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, EQK::kMapType, EQK::kBytes, q, D, sq, bhg, kBlockQ,
                P::kWq) ||
      !make_map(&k_map, EQK::kMapType, EQK::kBytes, k, D, skv, bhg / g,
                kBlockK, P::kWq) ||
      !make_map(&v_map, EV::kMapType, EV::kBytes, v, D, skv, bhg / g, kBlockK,
                P::kWv))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<EQK, EV, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, bhg);
  flash_fwd_kernel<EQK, EV, D><<<grid, P::kThreads, P::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<typename EQK::T*>(o), lse, g, sq,
      skv, causal, window, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename EQK, typename EV>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             float* lse, int bhg, int g, int sq, int skv, int causal,
             int window, float softcap, cudaStream_t stream) {
#define FLASH_CASE(D)                                                      \
  case D:                                                                  \
    return launch<EQK, EV, D>(q, k, v, o, lse, bhg, g, sq, skv, causal,    \
                              window, softcap, stream);
  switch (d) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_CASE
}

}  // namespace

// q, o: [bhg, sq, d]; k, v: [bhg / g, skv, d]; all contiguous on the device,
// 16-byte aligned.  lse: null, or float32 [bhg, sq], which gets each row's
// log-sum-exp (o does not change with it: the same code writes it).  q, k and o have dtype `qk_dtype`, v has `v_dtype` (0
// float32, 1 bfloat16): both float32, both bfloat16, or float32 q and k with
// bfloat16 v.  d in {16, 32, 64, 128, 256}; bhg <= 65535 (grid y).
// window <= 0 means none, softcap <= 0 means none.  Launches on `stream`;
// returns cudaGetLastError() (cudaErrorInvalidValue for an unsupported
// dtype pair or d, or a tensor map the driver refuses).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int bhg, int g, int sq, int skv, int d,
                                      int qk_dtype, int v_dtype, int causal,
                                      int window, float softcap,
                                      void* stream) {
  if (bhg <= 0 || sq <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (qk_dtype == kFloat32 && v_dtype == kFloat32)
    return launch_d<F32, F32>(d, q, k, v, o, l, bhg, g, sq, skv, causal,
                              window, softcap, s);
  if (qk_dtype == kBFloat16 && v_dtype == kBFloat16)
    return launch_d<BF16, BF16>(d, q, k, v, o, l, bhg, g, sq, skv, causal,
                                window, softcap, s);
  if (qk_dtype == kFloat32 && v_dtype == kBFloat16)
    return launch_d<F32, BF16>(d, q, k, v, o, l, bhg, g, sq, skv, causal,
                               window, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The kernel's tile sizes, so that a caller can find the rows whose first
// live key tile is wholly masked.
extern "C" int flash_attention_block_q() { return kBlockQ; }
extern "C" int flash_attention_block_k() { return kBlockK; }
