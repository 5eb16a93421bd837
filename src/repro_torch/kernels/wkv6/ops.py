"""Public wrapper for RWKV-6's WKV recurrence.

Registers op ``wkv6`` with the port's dispatch registry.  Its CUDA body
launches the hand-written kernel of ``csrc/wkv6.cu`` (one launch for the
whole scan); its reference body is the plain PyTorch version of
``ref.py``, which describes the operands.  The state is updated in place,
so dispatch must hand the bodies the caller's own tensors: the op
declares no elastic axis, and dispatch pads nothing.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..dispatch import (KernelOp, dispatch, record_launch, refuse_grad,
                        register_kernel)
from .ref import wkv6_ref

__all__ = ["wkv6", "wkv6_cuda", "wkv6_ref", "HEAD_SIZES"]

#: head sizes the kernel is built for: rwkv6-1.6b's and its smoke config's
HEAD_SIZES = (16, 64)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built and loaded on first use."""
    lib = _build.load("wkv6")
    lib.wkv6_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.wkv6_launch.restype = ctypes.c_int
    lib.wkv6_error_string.argtypes = [ctypes.c_int]
    lib.wkv6_error_string.restype = ctypes.c_char_p
    return lib


def _check(r, k, v, w, u, state) -> tuple:
    """Device, dtype, shape and contiguity; returns ``(B, S, H, hd)``."""
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
             ("state", state))
    for what, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"wkv6: {what} must be float32, got "
                            f"{t.dtype}")
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"wkv6: CUDA tensors expected, got {dev}")
    for what, t in named:
        if t.device != dev:
            raise ValueError(f"wkv6: {what} on {t.device}, r on "
                             f"{dev}")
        if not t.is_contiguous():
            raise ValueError(f"wkv6: {what} must be contiguous")
    if r.dim() != 4:
        raise ValueError(f"wkv6: r must be [B, S, H, hd], got "
                         f"{tuple(r.shape)}")
    b, s, h, hd = r.shape
    want = {"r": (b, s, h, hd), "k": (b, s, h, hd), "v": (b, s, h, hd),
            "w": (b, s, h, hd), "u": (h, hd), "state": (b, h, hd, hd)}
    for what, t in named:
        if tuple(t.shape) != want[what]:
            raise ValueError(f"wkv6: {what} {tuple(t.shape)}, want "
                             f"{want[what]}")
    if hd not in HEAD_SIZES:
        raise ValueError(f"wkv6: head size {hd} not in {HEAD_SIZES}")
    if b <= 0 or s <= 0 or h <= 0 or b * h >= 2**31:
        raise ValueError(f"wkv6: batch {b}, steps {s}, heads {h} out of "
                         f"range")
    return b, s, h, hd


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, state: torch.Tensor) -> tuple:
    """Launch the kernel: ``(o, state)``, ``state`` updated in place.
    Raises ``NotImplementedError`` when an operand requires grad: the
    kernel has no backward yet."""
    b, s, h, hd = _check(r, k, v, w, u, state)
    refuse_grad("wkv6", r, k, v, w, u, state)
    o = torch.empty((b, s, h, hd), dtype=torch.float32, device=r.device)
    lib = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv6_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                              w.data_ptr(), u.data_ptr(), state.data_ptr(),
                              o.data_ptr(), b, s, h, hd, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: "
                           f"{lib.wkv6_error_string(err).decode()} "
                           f"(cudaError {err})")
    record_launch("wkv6")
    return o, state


def _cost(r, k, v, w, u, state) -> float:
    """State values updated over the scan, the cost hint."""
    return float(r.numel() * r.shape[-1])


register_kernel(KernelOp(
    name="wkv6",
    cuda_body=wkv6_cuda,
    reference_body=wkv6_ref,
    cost_hint=_cost,
))


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor, *,
         backend: str | None = None) -> tuple:
    """RWKV-6's WKV recurrence over the S steps of ``r`` from ``state``
    (updated in place); returns ``(o [B, S, H, hd] float32, state)``.

    backend: "cuda" (the hand kernel; CUDA tensors), "ref" (plain
    PyTorch, any device), or None = from the operands' device.
    """
    return dispatch("wkv6", r, k, v, w, u, state, backend=backend)
