// Mandelbrot escape-time dwell of an [H, W] plane, with an exact exit for
// points whose orbit has closed into a cycle.
//
// Replaces the Pallas kernel `_mandelbrot_kernel` (src/repro/kernels/
// mandelbrot/kernel.py, its pallas_call in `mandelbrot_pallas`, registered
// as op `mandelbrot`).
//
// What it computes: for each point c, iterate z <- z^2 + c from z = 0 and
// count the iterations that start with |z|^2 <= 4, capped at max_iter.  In
// the Pallas kernel an escaped lane's z is frozen and never counts again, so
// stopping a thread at its first escape gives the same count.
//
// Rounding: every operation is written as an intrinsic so that nvcc cannot
// contract it, except new_im, which is one fused multiply-add:
//   |z|^2  = __fadd_rn(__fmul_rn(zr, zr), __fmul_rn(zi, zi))
//   new_re = __fadd_rn(__fsub_rn(__fmul_rn(zr, zr), __fmul_rn(zi, zi)), cr)
//   new_im = __fmaf_rn(2 * zr, zi, ci)
// That is the rounding of the reference package's dwell as XLA compiles it
// for the CPU, so dwell maps are bit-equal to it, and to the plain PyTorch
// version, which emulates the one fused multiply-add exactly.
//
// What bounds it at the main path's shapes: the serial chain of one point,
// not the ALU rate.  Mariani-Silver hands it border strips of at most a few
// hundred points (a few warps) with max_iter 5,000,000.  One iteration is a
// dependent chain (fmul -> fsub -> fadd into the next zr), so a point inside
// the set, which never escapes, held its launch for all 5,000,000 of them,
// tens of milliseconds, however the grid is shaped.  On a large plane (the
// naive render, the 1024^2 timing) the orbits that close late or never set
// the time, and below them the FP32 issue rate, about 10 instructions an
// iteration summed over every point.
//
// What the design does about it:
//
// 1. Exact orbit-cycle exit (template argument kDetect).  In float32 with
//    this fixed rounding, one iteration is a deterministic function of the
//    state (zr, zi) alone: c is fixed per thread, and the count does not
//    feed back into the arithmetic.  The state space is finite, so the orbit
//    of a point that never escapes is eventually periodic.  Each thread
//    keeps a saved state and compares it with the live one every
//    kCheckEvery iterations, re-saving at iterations kCheckEvery * 2^k
//    (Brent's power-of-two schedule on the subsequence z_0, z_8, z_16, ...).
//    Suppose the state after iteration n equals, bit for bit, the state
//    saved after iteration m < n.  Every state from z_m to z_{n-1} passed
//    the escape test, or the thread would have stopped there.  From z_n on
//    the orbit repeats z_m .. z_{n-1} forever, so no later state fails the
//    test either: the point never escapes and its dwell is exactly
//    max_iter, which the thread writes at once.  The comparison is of bit
//    patterns (__float_as_uint), not of floats: -0.0 and +0.0 compare equal
//    as floats but are different states (fmaf(+-0, zi, -0) differ in sign),
//    and a NaN state has already failed |z|^2 <= 4 and escaped.  The escape
//    test stays on every iteration, so an escaping point's count is
//    unchanged; spacing the checks delays a detection by at most
//    kCheckEvery periods and never makes it wrong.  Points inside the set
//    close their orbit within a few hundred iterations (median) to a few
//    hundred thousand (the slowest seen), against 5,000,000.
// 2. No branch inside a block of kCheckEvery iterations: each state's
//    escape test sets a bit, and the first set bit is the dwell.  The warp
//    then waits on no branch per iteration, only on the arithmetic, which
//    shortens the chain of every orbit that runs long (PERF.md).
// 3. One thread per point, as before.  A persistent grid whose warps
//    refill finished lanes from a shared chunk queue was built and timed:
//    it was slower at every timed shape (the refill's instructions share
//    the warp with the longest orbit's chain), so it is not kept.
//
// kDetect = false is the full iteration of the earlier kernel, kept as a
// separate instantiation for measurement and for checking the cycle exit
// bit for bit at max_iter values the plain version cannot reach.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
// iterations between two comparisons with the saved state
constexpr int kCheckEvery = 8;

// One iteration: returns |z|^2 of the z it starts from and sets
// z <- z^2 + c.  Whether that z had escaped is the caller's test of the
// returned value; past an escape z runs on, and its values are never used.
__device__ __forceinline__ float iterate(float& zr, float& zi, float cr,
                                         float ci) {
  const float zr2 = __fmul_rn(zr, zr);
  const float zi2 = __fmul_rn(zi, zi);
  const float new_re = __fadd_rn(__fsub_rn(zr2, zi2), cr);
  zi = __fmaf_rn(__fmul_rn(2.0f, zr), zi, ci);
  zr = new_re;
  return __fadd_rn(zr2, zi2);
}

// A point's orbit in flight: z after `i` iterations, and the state saved
// at iteration `next_save / 2` (z_0 until the first save).
struct Orbit {
  float zr, zi, sr, si;
  int i;
  unsigned next_save;
};

// Runs the orbit on by kCheckEvery iterations, or to max_iter if fewer are
// left.  Returns the dwell once it is known, else -1.  A full block has no
// branch inside: each state's escape test sets a bit, and the first set bit
// is the dwell, so one iteration's chain is its arithmetic alone and not a
// branch waiting on |z|^2.
template <bool kDetect>
__device__ __forceinline__ int advance(Orbit& o, float cr, float ci,
                                       int max_iter) {
  if (max_iter - o.i >= kCheckEvery) {
    unsigned escaped = 0;
#pragma unroll
    for (int k = 0; k < kCheckEvery; ++k) {
      const float mag = iterate(o.zr, o.zi, cr, ci);
      escaped |= static_cast<unsigned>(!(mag <= 4.0f)) << k;
    }
    if (escaped) return o.i + __ffs(escaped) - 1;
    o.i += kCheckEvery;
    if (kDetect) {
      if (__float_as_uint(o.zr) == __float_as_uint(o.sr) &&
          __float_as_uint(o.zi) == __float_as_uint(o.si)) {
        return max_iter;  // the orbit has closed: it never escapes
      }
      // next_save <= 2^31: it doubles only on reaching i < 2^31
      if (static_cast<unsigned>(o.i) == o.next_save) {
        o.sr = o.zr;
        o.si = o.zi;
        o.next_save <<= 1;
      }
    }
    return -1;
  }
  for (; o.i < max_iter; ++o.i) {
    if (!(iterate(o.zr, o.zi, cr, ci) <= 4.0f)) return o.i;
  }
  return max_iter;
}

// One thread per point; the grid is 2-D, blockIdx.y = row, so a [1, n]
// border strip fills whole warps.
template <bool kDetect>
__global__ void __launch_bounds__(kThreads)
dwell_per_point(const float* __restrict__ c_re, const float* __restrict__ c_im,
                int32_t* __restrict__ dwell, int w, int max_iter) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  const size_t idx = static_cast<size_t>(blockIdx.y) * w + x;
  const float cr = c_re[idx];
  const float ci = c_im[idx];
  Orbit o{0.0f, 0.0f, 0.0f, 0.0f, 0, kCheckEvery};
  int d;
  while ((d = advance<kDetect>(o, cr, ci, max_iter)) < 0) {
  }
  dwell[idx] = d;
}

template <bool kDetect>
int launch(const float* c_re, const float* c_im, int32_t* dwell, int h,
           int w, int max_iter, cudaStream_t stream) {
  const dim3 grid((w + kThreads - 1) / kThreads, h);
  dwell_per_point<kDetect><<<grid, kThreads, 0, stream>>>(c_re, c_im, dwell,
                                                          w, max_iter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// c_re, c_im: [h, w] float32; dwell: [h, w] int32; all on the device,
// contiguous.  h <= 65535 (grid y).  detect_cycles != 0 turns on the cycle
// exit.  Launches on `stream`; returns a cudaError_t as int, 0 on success.
extern "C" int mandelbrot_launch(const void* c_re, const void* c_im,
                                 void* dwell, int h, int w, int max_iter,
                                 int detect_cycles, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  const auto* re = static_cast<const float*>(c_re);
  const auto* im = static_cast<const float*>(c_im);
  auto* out = static_cast<int32_t*>(dwell);
  auto s = static_cast<cudaStream_t>(stream);
  return detect_cycles ? launch<true>(re, im, out, h, w, max_iter, s)
                       : launch<false>(re, im, out, h, w, max_iter, s);
}

// The iterations between two comparisons with the saved state, for a
// plain run of the same schedule.
extern "C" int mandelbrot_check_every() { return kCheckEvery; }

extern "C" const char* mandelbrot_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
