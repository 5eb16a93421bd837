"""Public wrapper for the Mandelbrot escape-time kernel.

Counterpart of ``repro.kernels.mandelbrot.ops``: the ``mandelbrot``
registration with the port's dispatch registry (bucket floor 8, pad
points at 3.0, outside the escape radius, so padding costs one
iteration), whose CUDA body launches the hand-written kernel
``csrc/mandelbrot.cu`` (with its exact cycle exit for points inside the
set) and whose reference body is the plain PyTorch dwell of ``ref.py``.
``mandelbrot_cuda_full_iteration`` runs the same kernel with the cycle
exit off, for measurement and checks only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..dispatch import KernelOp, dispatch, record_launch, register_kernel
from .ref import coords, mandelbrot_ref

__all__ = ["mandelbrot", "mandelbrot_ref", "mandelbrot_cuda",
           "mandelbrot_cuda_full_iteration", "cycle_check_every", "coords"]

#: pad constant: outside the escape radius, so padding costs 1 iteration
_OUTSIDE = 3.0
#: the kernel's grid puts rows on blockIdx.y
_MAX_ROWS = 65535


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built and loaded on first use."""
    lib = _build.load("mandelbrot")
    fn = lib.mandelbrot_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mandelbrot_check_every.argtypes = []
    lib.mandelbrot_check_every.restype = ctypes.c_int
    lib.mandelbrot_error_string.argtypes = [ctypes.c_int]
    lib.mandelbrot_error_string.restype = ctypes.c_char_p
    return lib


def cycle_check_every() -> int:
    """Iterations between the kernel's comparisons with its saved state
    (``kCheckEvery`` of ``csrc/mandelbrot.cu``), for a plain run of its
    schedule."""
    return int(_lib().mandelbrot_check_every())


def _launch(c_re: torch.Tensor, c_im: torch.Tensor, max_iter: int, *,
            detect_cycles: bool) -> torch.Tensor:
    """Check the operands and launch the kernel."""
    if c_re.device.type != "cuda" or c_im.device != c_re.device:
        raise ValueError(
            f"mandelbrot_cuda: CUDA tensors on one device expected, got "
            f"{c_re.device} and {c_im.device}")
    if c_re.dtype != torch.float32 or c_im.dtype != torch.float32:
        raise TypeError(
            f"mandelbrot_cuda: float32 operands expected, got {c_re.dtype} "
            f"and {c_im.dtype}")
    if c_re.dim() != 2 or c_im.shape != c_re.shape:
        raise ValueError(
            f"mandelbrot_cuda: two [H, W] planes expected, got "
            f"{tuple(c_re.shape)} and {tuple(c_im.shape)}")
    if not (c_re.is_contiguous() and c_im.is_contiguous()):
        raise ValueError("mandelbrot_cuda: operands must be contiguous")
    h, w = c_re.shape
    if h > _MAX_ROWS or w >= 2**31 or not 0 <= max_iter < 2**31:
        raise ValueError(
            f"mandelbrot_cuda: plane {h}x{w} / max_iter {max_iter} out of "
            f"the kernel's range (H <= {_MAX_ROWS})")
    out = torch.empty(c_re.shape, dtype=torch.int32, device=c_re.device)
    lib = _lib()
    with torch.cuda.device(c_re.device):
        stream = torch.cuda.current_stream(c_re.device).cuda_stream
        err = lib.mandelbrot_launch(c_re.data_ptr(), c_im.data_ptr(),
                                    out.data_ptr(), h, w, max_iter,
                                    int(detect_cycles), stream)
    if err != 0:
        raise RuntimeError(
            f"mandelbrot kernel launch failed: "
            f"{lib.mandelbrot_error_string(err).decode()} (cudaError {err})")
    record_launch("mandelbrot")
    return out


def mandelbrot_cuda(c_re: torch.Tensor, c_im: torch.Tensor, *,
                    max_iter: int) -> torch.Tensor:
    """Launch the CUDA kernel on [H, W] float32 coordinate planes.

    Points inside the set stop as soon as their orbit is seen to repeat
    (the kernel's exact cycle exit); every dwell equals the full
    iteration's."""
    return _launch(c_re, c_im, max_iter, detect_cycles=True)


def mandelbrot_cuda_full_iteration(c_re: torch.Tensor, c_im: torch.Tensor,
                                   *, max_iter: int) -> torch.Tensor:
    """The kernel with the cycle exit off: every point inside the set runs
    all ``max_iter`` iterations.  For measurement and for checking the
    cycle exit bit for bit where the plain version cannot go; the main
    path never calls it."""
    return _launch(c_re, c_im, max_iter, detect_cycles=False)


def _ref_body(c_re: torch.Tensor, c_im: torch.Tensor, *,
              max_iter: int) -> torch.Tensor:
    return mandelbrot_ref(c_re, c_im, max_iter)


register_kernel(KernelOp(
    name="mandelbrot",
    cuda_body=mandelbrot_cuda,
    reference_body=_ref_body,
    # c_re and c_im are [H, W] planes sharing both elastic dims
    arg_dims=(((0, "h"), (1, "w")), ((0, "h"), (1, "w"))),
    pad_values=(_OUTSIDE, _OUTSIDE),
    out_dims=((0, "h"), (1, "w")),
    bucket_floor=8,
    cost_hint=lambda c_re, c_im: float(c_re.shape[0] * c_re.shape[1]),
))


def mandelbrot(c_re: torch.Tensor, c_im: torch.Tensor, max_iter: int, *,
               backend: str | None = None) -> torch.Tensor:
    """Dwell map for [H, W] float32 coordinate planes (auto-padded).

    backend: "cuda" (the hand kernel; CUDA tensors), "ref" (plain
    PyTorch, any device), or None = from the operands' device.
    """
    return dispatch("mandelbrot", c_re, c_im, backend=backend,
                    max_iter=int(max_iter))

