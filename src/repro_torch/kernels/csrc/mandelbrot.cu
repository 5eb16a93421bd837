// Mandelbrot escape-time dwell: one thread per point of an [H, W] plane.
//
// Replaces the Pallas kernel `_mandelbrot_kernel` (src/repro/kernels/
// mandelbrot/kernel.py, wrapped by `mandelbrot_pallas`, registered as op
// `mandelbrot`).
//
// What it computes: for each point c, iterate z <- z^2 + c from z = 0 and count
// the iterations that start with |z|^2 <= 4, capped at max_iter.  In the Pallas
// kernel an escaped lane's z is frozen and never counts again, so stopping a
// thread at its first escape gives the same count.
//
// Rounding: every operation is written as an intrinsic so that nvcc cannot
// contract it, except new_im, which is one fused multiply-add:
//   |z|^2  = __fadd_rn(__fmul_rn(zr, zr), __fmul_rn(zi, zi))
//   new_re = __fadd_rn(__fsub_rn(__fmul_rn(zr, zr), __fmul_rn(zi, zi)), cr)
//   new_im = __fmaf_rn(2 * zr, zi, ci)
// That is the rounding of the reference package's dwell as XLA compiles it for
// the CPU, so dwell maps are bit-equal to it, and to the plain PyTorch version,
// which emulates the one fused multiply-add exactly.
//
// What bounds it on the H100: FP32 ALU work, about 8 operations per iteration,
// summed over every point's dwell, against 12 bytes of memory traffic per
// point (two float coordinates in, one int32 dwell out).  Dwells run to
// max_iter inside the set, so the work per point varies by orders of
// magnitude from one point to its neighbour's region.
//
// What the design does about it: one thread per point and no shared state,
// so a thread stops the moment its point escapes and an escaped warp frees its
// scheduler slot; neighbouring points of a row sit in one warp, where dwells
// are alike and divergence is small.  The grid is 2-D, blockIdx.y = row, so a
// [1, n] border strip fills whole warps too.  Memory is touched once per
// point, coalesced.  Making interior-heavy planes faster (splitting the
// dwell loop into persistent work, or pruning the set's interior) is later
// work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
mandelbrot_kernel(const float* __restrict__ c_re,
                  const float* __restrict__ c_im,
                  int32_t* __restrict__ dwell, int w, int max_iter) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  const size_t idx = static_cast<size_t>(blockIdx.y) * w + x;
  const float cr = c_re[idx];
  const float ci = c_im[idx];
  float zr = 0.0f;
  float zi = 0.0f;
  int i = 0;
  for (; i < max_iter; ++i) {
    const float zr2 = __fmul_rn(zr, zr);
    const float zi2 = __fmul_rn(zi, zi);
    if (!(__fadd_rn(zr2, zi2) <= 4.0f)) break;
    const float new_re = __fadd_rn(__fsub_rn(zr2, zi2), cr);
    zi = __fmaf_rn(__fmul_rn(2.0f, zr), zi, ci);
    zr = new_re;
  }
  dwell[idx] = i;
}

}  // namespace

// c_re, c_im: [h, w] float32; dwell: [h, w] int32; all on the device,
// contiguous.  h <= 65535 (grid y).  Launches on `stream`; returns
// cudaGetLastError().
extern "C" int mandelbrot_launch(const void* c_re, const void* c_im,
                                 void* dwell, int h, int w, int max_iter,
                                 void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const dim3 grid((w + kThreads - 1) / kThreads, h);
  mandelbrot_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(c_re), static_cast<const float*>(c_im),
      static_cast<int32_t*>(dwell), w, max_iter);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mandelbrot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
