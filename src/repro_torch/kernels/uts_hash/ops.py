"""Public wrapper for the UTS SHA-1 kernel + tree-shape helpers.

Counterpart of ``repro.kernels.uts_hash.ops``: the ``uts_hash``
registration with the port's dispatch registry, whose CUDA body launches
the hand-written kernel ``csrc/uts_hash.cu`` and whose reference body is
the plain PyTorch SHA-1 of ``ref.py``.

* ``uts_child_digests``   — registered-kernel dispatch;
* ``root_digest``, ``random_u31``, ``geometric_children`` — the tree
  shape, from ``ref.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..dispatch import KernelOp, dispatch, record_launch, register_kernel
from .ref import (geometric_children, random_u31, root_digest,
                  uts_child_digests_ref)

__all__ = [
    "uts_child_digests", "uts_child_digests_ref", "uts_hash_cuda",
    "root_digest", "random_u31", "geometric_children",
]


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built and loaded on first use."""
    lib = _build.load("uts_hash")
    fn = lib.uts_hash_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.uts_hash_error_string.argtypes = [ctypes.c_int]
    lib.uts_hash_error_string.restype = ctypes.c_char_p
    return lib


def uts_hash_cuda(parent: torch.Tensor,
                  child_ix: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on [5, N] int32 parents and [N] int32 indices."""
    if parent.device.type != "cuda" or child_ix.device != parent.device:
        raise ValueError(
            f"uts_hash_cuda: CUDA tensors on one device expected, got "
            f"{parent.device} and {child_ix.device}")
    if parent.dtype != torch.int32 or child_ix.dtype != torch.int32:
        raise TypeError(
            f"uts_hash_cuda: int32 operands expected, got {parent.dtype} "
            f"and {child_ix.dtype}")
    if parent.dim() != 2 or parent.shape[0] != 5 or \
            child_ix.shape != (parent.shape[1],):
        raise ValueError(
            f"uts_hash_cuda: shapes [5, N] and [N] expected, got "
            f"{tuple(parent.shape)} and {tuple(child_ix.shape)}")
    if not (parent.is_contiguous() and child_ix.is_contiguous()):
        raise ValueError("uts_hash_cuda: operands must be contiguous")
    n = parent.shape[1]
    if n >= 2**31:
        raise ValueError(f"uts_hash_cuda: N={n} exceeds the int range")
    out = torch.empty_like(parent)
    lib = _lib()
    with torch.cuda.device(parent.device):
        stream = torch.cuda.current_stream(parent.device).cuda_stream
        err = lib.uts_hash_launch(parent.data_ptr(), child_ix.data_ptr(),
                                  out.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(
            f"uts_hash kernel launch failed: "
            f"{lib.uts_hash_error_string(err).decode()} (cudaError {err})")
    record_launch("uts_hash")
    return out


register_kernel(KernelOp(
    name="uts_hash",
    cuda_body=uts_hash_cuda,
    reference_body=uts_child_digests_ref,
    # parent [5, N] and child_ix [N] share the elastic lane dim "n"
    arg_dims=(((1, "n"),), ((0, "n"),)),
    pad_values=(0, 0),
    out_dims=((1, "n"),),
    bucket_floor=128,
    cost_hint=lambda parent, child_ix: float(parent.shape[1]),
))


def uts_child_digests(parent: torch.Tensor, child_ix: torch.Tensor, *,
                      backend: str | None = None) -> torch.Tensor:
    """SHA1(parent || be32(ix)) for [5, N] int32 parents, [N] indices.

    backend: "cuda" (the hand kernel; CUDA tensors), "ref" (plain
    PyTorch, any device), or None = from the operands' device.
    """
    if parent.shape[1] == 0:
        return torch.zeros((5, 0), dtype=torch.int32, device=parent.device)
    return dispatch("uts_hash", parent, child_ix, backend=backend)
