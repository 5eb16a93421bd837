"""Plain PyTorch Mandelbrot escape-time dwell.

The plain version of the ``mandelbrot`` kernel (``csrc/mandelbrot.cu``):
the CPU path of the port, and what the kernel is held against on the
card.  For each point c, iterate z <- z^2 + c from z = 0 and count the
iterations that start with |z|^2 <= 4, capped at ``max_iter``; an
escaped point's z is frozen.

Rounding follows the reference package's dwell as XLA compiles it for
the CPU: every operation rounds to float32 on its own, except the new
imaginary part, ``2*zr*zi + ci``, which is one fused multiply-add.
:func:`_fma_f32` computes that fused multiply-add exactly: the product of
two float32 values is exact in float64, the float64 sum is rounded to
odd (TwoSum finds the rounding error, ``nextafter`` fixes the last bit),
and rounding a round-to-odd float64 to float32 is the correctly rounded
result, with no double-rounding error.
"""
from __future__ import annotations

import math

import torch

from ...device import DeviceLike, resolve_device

__all__ = ["mandelbrot_ref", "coords"]

ESCAPE_RADIUS_SQ = 4.0


def _fma_f32(a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with a single rounding (IEEE fmaf)."""
    p = a.double() * b.double()            # exact: 24 + 24 bits <= 53
    cd = c.double()
    s = p + cd
    bp = s - p                             # TwoSum: s + err == p + cd
    err = (p - (s - bp)) + (cd - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def mandelbrot_ref(c_re: torch.Tensor, c_im: torch.Tensor,
                   max_iter: int) -> torch.Tensor:
    """Dwell map, int32, same shape as ``c_re``/``c_im``."""
    c_re = c_re.float()
    c_im = c_im.float()
    z_re = torch.zeros_like(c_re)
    z_im = torch.zeros_like(c_im)
    dwell = torch.zeros(c_re.shape, dtype=torch.int32, device=c_re.device)
    for _ in range(max_iter):
        zr2 = z_re * z_re
        zi2 = z_im * z_im
        active = zr2 + zi2 <= ESCAPE_RADIUS_SQ
        # an escaped point never counts again, so once none is active
        # the remaining iterations change nothing
        if not bool(active.any()):
            break
        new_re = (zr2 - zi2) + c_re
        new_im = _fma_f32(2.0 * z_re, z_im, c_im)
        z_re = torch.where(active, new_re, z_re)
        z_im = torch.where(active, new_im, z_im)
        dwell += active.to(torch.int32)
    return dwell


def coords(x0: float, y0: float, x1: float, y1: float,
           height: int, width: int, device: DeviceLike = None) -> tuple:
    """Pixel-center coordinates of a rectangle of the complex plane.

    Counterpart of the reference package's ``coords`` with the arithmetic
    of ``jnp.linspace`` written out per operation in float32
    (``x0 * (1 - t) + x1 * t``, t = i / (n - 1)).  XLA rewrites some of
    those operations on the CPU, so the two may differ in the last bit of
    some coordinates; tests that compare dwells hand both packages the
    same coordinate arrays.
    """
    def lin(a: float, b: float, n: int) -> torch.Tensor:
        a_ = torch.tensor(a, dtype=torch.float32)
        b_ = torch.tensor(b, dtype=torch.float32)
        if n == 1:
            return a_.reshape(1)
        t = torch.arange(n - 1, dtype=torch.float32) / float(n - 1)
        return torch.cat([a_ * (1.0 - t) + b_ * t, b_.reshape(1)])

    xs = lin(x0, x1, width)
    ys = lin(y0, y1, height)
    c_im, c_re = torch.meshgrid(ys, xs, indexing="ij")
    device = resolve_device(device)
    return c_re.contiguous().to(device), c_im.contiguous().to(device)
