"""Public wrappers for the betweenness-centrality level kernels.

Two registrations with the port's dispatch registry, both backed by
``csrc/bc_level.cu``, whose reference bodies are the plain PyTorch
versions of ``ref.py``:

* ``bc_forward_level`` (:func:`bc_forward_level`): one forward BFS level,
  the pull over the in-edges fused with the ``dist``/``sigma`` update;
  returns the next level's per-source ``live`` flags (1 for a source of
  which a pair joined);
* ``bc_backward_level`` (:func:`bc_backward_level`): one backward level,
  the coefficients and the pull over the out-edges fused with the
  ``delta`` update.

Both update their state in place, so dispatch must hand the bodies the
caller's own tensors: the ops declare no elastic axis, and dispatch pads
nothing.  The caller pads the source axis once, to a multiple of 32 (a
warp's strip), with ``dist = INF`` and ``sigma = 0`` in every padded
column and ``live = 0``, which then never joins and contributes exact
zeros.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..dispatch import KernelOp, dispatch, record_launch, register_kernel
from .ref import (INF, bc_backward_level_ref, bc_forward_level_ref,
                  sum_over_sources)

__all__ = ["INF", "bc_forward_level", "bc_backward_level",
           "bc_forward_level_cuda", "bc_backward_level_cuda",
           "bc_forward_level_ref", "bc_backward_level_ref",
           "sum_over_sources"]

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library, built and loaded on first use."""
    lib = _build.load("bc_level")
    lib.bc_forward_level_launch.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P,
                                            _P, _P]
    lib.bc_forward_level_launch.restype = _I
    lib.bc_backward_level_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I,
                                             _P]
    lib.bc_backward_level_launch.restype = _I
    lib.bc_level_inf.argtypes = []
    lib.bc_level_inf.restype = _I
    lib.bc_level_error_string.argtypes = [_I]
    lib.bc_level_error_string.restype = ctypes.c_char_p
    if lib.bc_level_inf() != INF:
        raise RuntimeError(f"bc_level: the kernel's INF {lib.bc_level_inf()} "
                           f"is not the plain version's {INF}")
    return lib


def _check(name: str, indptr: torch.Tensor, indices: torch.Tensor,
           state: dict) -> tuple:
    """Device, dtype, shape and contiguity of a level's operands; returns
    ``(n, s_pad)``."""
    dev = indptr.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: CUDA tensors expected, got {dev}")
    for what, t in (("indptr", indptr), ("indices", indices), *state.items()):
        if t.device != dev:
            raise ValueError(f"{name}: {what} on {t.device}, indptr on {dev}")
        want = torch.float32 if what in ("sigma", "delta") else torch.int32
        if t.dtype != want:
            raise TypeError(f"{name}: {what} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    n = indptr.shape[0] - 1
    dist = state["dist"]
    if indptr.dim() != 1 or indices.dim() != 1 or dist.dim() != 2 or \
            dist.shape[0] != n:
        raise ValueError(f"{name}: CSR of {n} rows and [N, S] state expected, "
                         f"got indptr {tuple(indptr.shape)}, indices "
                         f"{tuple(indices.shape)}, dist {tuple(dist.shape)}")
    s_pad = dist.shape[1]
    if s_pad % 32:
        raise ValueError(f"{name}: source axis {s_pad} is not a multiple of "
                         f"32; pad it with dist = INF, sigma = 0")
    for what, t in state.items():
        if what != "live" and t.shape != dist.shape:
            raise ValueError(f"{name}: {what} {tuple(t.shape)}, dist "
                             f"{tuple(dist.shape)}")
    if "live" in state and state["live"].shape != (s_pad,):
        raise ValueError(f"{name}: live {tuple(state['live'].shape)}, want "
                         f"({s_pad},)")
    if n >= 2**31 - 1 or indices.shape[0] >= 2**31:
        raise ValueError(f"{name}: graph too large for int32 CSR")
    return n, s_pad


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{_lib().bc_level_error_string(err).decode()} (cudaError {err})")


def bc_forward_level_cuda(in_indptr: torch.Tensor, in_indices: torch.Tensor,
                          dist: torch.Tensor, sigma: torch.Tensor,
                          live: torch.Tensor, *, level: int) -> torch.Tensor:
    """Launch the forward level kernel (in place); returns the next
    level's int32 [S] ``live`` flags on the device."""
    n, s_pad = _check("bc_forward_level", in_indptr, in_indices,
                      {"dist": dist, "sigma": sigma, "live": live})
    live_out = torch.zeros_like(live)
    lib = _lib()
    with torch.cuda.device(dist.device):
        stream = torch.cuda.current_stream(dist.device).cuda_stream
        err = lib.bc_forward_level_launch(
            in_indptr.data_ptr(), in_indices.data_ptr(), dist.data_ptr(),
            sigma.data_ptr(), n, s_pad, int(level), live.data_ptr(),
            live_out.data_ptr(), stream)
    _raise_on(err, "bc_forward_level")
    record_launch("bc_forward_level")
    return live_out


def bc_backward_level_cuda(out_indptr: torch.Tensor,
                           out_indices: torch.Tensor, dist: torch.Tensor,
                           sigma: torch.Tensor, delta: torch.Tensor, *,
                           level: int) -> torch.Tensor:
    """Launch the backward level kernel (``delta`` in place); returns
    ``delta``."""
    n, s_pad = _check("bc_backward_level", out_indptr, out_indices,
                      {"dist": dist, "sigma": sigma, "delta": delta})
    lib = _lib()
    with torch.cuda.device(dist.device):
        stream = torch.cuda.current_stream(dist.device).cuda_stream
        err = lib.bc_backward_level_launch(
            out_indptr.data_ptr(), out_indices.data_ptr(), dist.data_ptr(),
            sigma.data_ptr(), delta.data_ptr(), n, s_pad, int(level), stream)
    _raise_on(err, "bc_backward_level")
    record_launch("bc_backward_level")
    return delta


def _edge_pairs(indptr, indices, dist, *state) -> float:
    """(edge, source) pairs a level may pull over, the cost hint."""
    return float(indices.shape[0] * dist.shape[1])


register_kernel(KernelOp(
    name="bc_forward_level",
    cuda_body=bc_forward_level_cuda,
    reference_body=bc_forward_level_ref,
    cost_hint=_edge_pairs,
))

register_kernel(KernelOp(
    name="bc_backward_level",
    cuda_body=bc_backward_level_cuda,
    reference_body=bc_backward_level_ref,
    cost_hint=_edge_pairs,
))


def bc_forward_level(in_indptr: torch.Tensor, in_indices: torch.Tensor,
                     dist: torch.Tensor, sigma: torch.Tensor,
                     live: torch.Tensor, level: int, *,
                     backend: str | None = None) -> torch.Tensor:
    """Forward BFS level ``level`` over the in-edge CSR, in place, for the
    sources flagged in ``live``; returns the next level's ``live``.

    backend: "cuda" (the hand kernel; CUDA tensors), "ref" (plain
    PyTorch, any device), or None = from the operands' device.
    """
    return dispatch("bc_forward_level", in_indptr, in_indices, dist, sigma,
                    live, backend=backend, level=int(level))


def bc_backward_level(out_indptr: torch.Tensor, out_indices: torch.Tensor,
                      dist: torch.Tensor, sigma: torch.Tensor,
                      delta: torch.Tensor, level: int, *,
                      backend: str | None = None) -> torch.Tensor:
    """Backward level ``level`` over the out-edge CSR, ``delta`` in
    place; returns ``delta``.  ``backend`` as for :func:`bc_forward_level`.
    """
    return dispatch("bc_backward_level", out_indptr, out_indices, dist, sigma,
                    delta, backend=backend, level=int(level))
