"""Public wrapper for Mamba's selective scan.

Registers op ``selective_scan`` with the port's dispatch registry.  Its
CUDA body launches the hand-written kernel of ``csrc/selective_scan.cu``
(one launch for the whole scan); its reference body is the plain PyTorch
version of ``ref.py``, which describes the operands.  The state is
updated in place, so dispatch must hand the bodies the caller's own
tensors: the op declares no elastic axis, and dispatch pads nothing.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..dispatch import (KernelOp, dispatch, record_launch, refuse_grad,
                        register_kernel)
from .ref import selective_scan_ref

__all__ = ["selective_scan", "selective_scan_cuda", "selective_scan_ref",
           "STATE_SIZES"]

#: state sizes N the kernel is built for
STATE_SIZES = (4, 8, 16)
#: the kernel's grid puts the batch on blockIdx.y
_MAX_BATCH = 65535


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built and loaded on first use."""
    lib = _build.load("selective_scan")
    lib.selective_scan_launch.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.selective_scan_launch.restype = ctypes.c_int
    lib.selective_scan_error_string.argtypes = [ctypes.c_int]
    lib.selective_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(xi, dt, bm, cm, a, state) -> tuple:
    """Device, dtype, shape and contiguity; returns ``(B, S, Di, N)``."""
    named = (("xi", xi), ("dt", dt), ("bm", bm), ("cm", cm), ("a", a),
             ("state", state))
    for what, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"selective_scan: {what} must be float32, got "
                            f"{t.dtype}")
    dev = xi.device
    if dev.type != "cuda":
        raise ValueError(f"selective_scan: CUDA tensors expected, got {dev}")
    for what, t in named:
        if t.device != dev:
            raise ValueError(f"selective_scan: {what} on {t.device}, xi on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"selective_scan: {what} must be contiguous")
    if xi.dim() != 3:
        raise ValueError(f"selective_scan: xi must be [B, S, Di], got "
                         f"{tuple(xi.shape)}")
    b, s, di = xi.shape
    n = a.shape[-1]
    want = {"xi": (b, s, di), "dt": (b, s, di), "bm": (b, s, n),
            "cm": (b, s, n), "a": (di, n), "state": (b, di, n)}
    for what, t in named:
        if tuple(t.shape) != want[what]:
            raise ValueError(f"selective_scan: {what} {tuple(t.shape)}, want "
                             f"{want[what]}")
    if n not in STATE_SIZES:
        raise ValueError(f"selective_scan: state size {n} not in "
                         f"{STATE_SIZES}")
    if not 0 < b <= _MAX_BATCH or s <= 0 or di <= 0:
        raise ValueError(f"selective_scan: batch {b}, steps {s}, channels "
                         f"{di} out of range")
    if b * s * di >= 2**62:
        raise ValueError("selective_scan: operands too large")
    return b, s, di, n


def selective_scan_cuda(xi: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                        cm: torch.Tensor, a: torch.Tensor,
                        state: torch.Tensor) -> tuple:
    """Launch the kernel: ``(y, state)``, ``state`` updated in place.
    Raises ``NotImplementedError`` when an operand requires grad: the
    kernel has no backward yet."""
    b, s, di, n = _check(xi, dt, bm, cm, a, state)
    refuse_grad("selective_scan", xi, dt, bm, cm, a, state)
    y = torch.empty((b, s, di), dtype=torch.float32, device=xi.device)
    lib = _lib()
    with torch.cuda.device(xi.device):
        stream = torch.cuda.current_stream(xi.device).cuda_stream
        err = lib.selective_scan_launch(
            xi.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            a.data_ptr(), state.data_ptr(), y.data_ptr(), b, s, di, n,
            stream)
    if err != 0:
        raise RuntimeError(
            f"selective_scan kernel launch failed: "
            f"{lib.selective_scan_error_string(err).decode()} "
            f"(cudaError {err})")
    record_launch("selective_scan")
    return y, state


def _cost(xi, dt, bm, cm, a, state) -> float:
    """State values updated over the scan, the cost hint."""
    return float(xi.numel() * a.shape[-1])


register_kernel(KernelOp(
    name="selective_scan",
    cuda_body=selective_scan_cuda,
    reference_body=selective_scan_ref,
    cost_hint=_cost,
))


def selective_scan(xi: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                   cm: torch.Tensor, a: torch.Tensor, state: torch.Tensor, *,
                   backend: str | None = None) -> tuple:
    """Mamba's selective scan over the S steps of ``xi`` from ``state``
    (updated in place); returns ``(y [B, S, Di] float32, state)``.

    backend: "cuda" (the hand kernel; CUDA tensors), "ref" (plain
    PyTorch, any device), or None = from the operands' device.
    """
    return dispatch("selective_scan", xi, dt, bm, cm, a, state,
                    backend=backend)
