// UTS child digests: one SHA-1 compression per (parent digest, child index).
//
// Replaces the Pallas kernel `_uts_hash_kernel` (src/repro/kernels/uts_hash/
// kernel.py, wrapped by `uts_hash_pallas`, registered as op `uts_hash`).
//
// What it computes: for lane j, SHA1(parent[:, j] || be32(child_ix[j])).  The
// 24-byte message fits one 64-byte block after padding, so the digest is one
// 80-round compression of the block
//   w0..w4 = parent words, w5 = child index, w6 = 0x80000000 (pad bit),
//   w7..w14 = 0, w15 = 192 (message length in bits).
//
// Layout: parent [5, N] and out [5, N] word-major (row i holds word i of every
// lane), child_ix [N].  The tensors are int32 on the PyTorch side (PyTorch has
// no usable uint32 arithmetic); the kernel reads the same bits as uint32_t.
//
// What bounds it on the H100: integer ALU work.  Each lane does 64 message
// schedule words (3 xor + 1 rotate) and 80 rounds (a rotate, a boolean
// function, 4 adds, a second rotate), about 1,000 32-bit operations, against
// 44 bytes of memory traffic (20 B in, 4 B index, 20 B out): some 23 operations
// per byte, far above the card's ratio of ALU rate to memory rate.
//
// What the design does about it: one thread per message, so lanes never
// communicate.  Row i of the [5, N] buffer is read by consecutive threads at
// consecutive addresses, so every load and store is coalesced.  The message
// schedule is a 16-word window and all 80 rounds are unrolled, so every index
// into the window is a compile-time constant and the window lives in registers.
// Rotates are `__funnelshift_l`, one instruction each.  No shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kH0 = 0x67452301u;
constexpr uint32_t kH1 = 0xEFCDAB89u;
constexpr uint32_t kH2 = 0x98BADCFEu;
constexpr uint32_t kH3 = 0x10325476u;
constexpr uint32_t kH4 = 0xC3D2E1F0u;

constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

__global__ void __launch_bounds__(kThreads)
uts_hash_kernel(const uint32_t* __restrict__ parent,
                const uint32_t* __restrict__ child_ix,
                uint32_t* __restrict__ out, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const size_t stride = static_cast<size_t>(n);

  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 5; ++i) w[i] = parent[i * stride + j];
  w[5] = child_ix[j];
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

  out[0 * stride + j] = a + kH0;
  out[1 * stride + j] = b + kH1;
  out[2 * stride + j] = c + kH2;
  out[3 * stride + j] = d + kH3;
  out[4 * stride + j] = e + kH4;
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

extern "C" const char* uts_hash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
