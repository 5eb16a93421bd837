"""Public wrappers for the betweenness-centrality level kernels.

Two registrations with the port's dispatch registry, both backed by
``csrc/bc_level.cu``, whose reference bodies are the plain PyTorch
versions of ``ref.py`` (which describes the state):

* ``bc_forward_level`` (:func:`bc_forward_level`): one forward BFS level,
  the pull over the in-edges fused with the ``sigma``/``visited``
  update; returns the next level's bit-packed frontier
  ``on[L + 1]``, where its values start (``base[L + 1]``) and ``live``
  words;
* ``bc_backward_level`` (:func:`bc_backward_level`): one backward level,
  the pull of the level's coefficients over the out-edges fused with the
  ``delta`` and ``coeff`` update.

Both update their state in place, so dispatch must hand the bodies the
caller's own tensors: the ops declare no elastic axis, and dispatch pads
nothing.  The caller pads the source axis once, to a power of two from 32
to ``32 * MAX_WORDS``, with columns whose bits are clear in every mask,
so that they never join and contribute exact zeros.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..dispatch import KernelOp, dispatch, record_launch, register_kernel
from .ref import (PART, bc_backward_level_ref, bc_forward_level_ref,
                  level_values, pack_bits, put_level, sum_over_sources,
                  sweep_state, unpack_bits, wrap_int32)

__all__ = ["PART", "MAX_WORDS", "bc_forward_level", "bc_backward_level",
           "bc_forward_level_cuda", "bc_backward_level_cuda",
           "bc_forward_level_ref", "bc_backward_level_ref", "pack_bits",
           "unpack_bits", "wrap_int32", "level_values", "put_level",
           "sweep_state", "sum_over_sources"]

#: words of 32 sources a vertex that the kernels take at most
MAX_WORDS = 32

_P, _I = ctypes.c_void_p, ctypes.c_int
_VALUES = ("sigma", "delta", "coeff")             # float32 [N, S'] each
_WORDS = ("visited", "on", "on_below")            # [N, S' / 32] each
_PARTS = ("base", "base_below")                   # [N, parts] each


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library, built and loaded on first use."""
    lib = _build.load("bc_level")
    lib.bc_forward_level_launch.argtypes = [_P] * 10 + [_I, _I, _P]
    lib.bc_forward_level_launch.restype = _I
    lib.bc_backward_level_launch.argtypes = [_P] * 9 + [_I, _I, _P]
    lib.bc_backward_level_launch.restype = _I
    for fn in (lib.bc_level_max_sources, lib.bc_level_part_sources):
        fn.argtypes = []
        fn.restype = _I
    lib.bc_level_error_string.argtypes = [_I]
    lib.bc_level_error_string.restype = ctypes.c_char_p
    if lib.bc_level_part_sources() != PART:
        raise RuntimeError(f"bc_level: the kernels' parts are "
                           f"{lib.bc_level_part_sources()} sources, the "
                           f"plain version's {PART}")
    if lib.bc_level_max_sources() != 32 * MAX_WORDS:
        raise RuntimeError(f"bc_level: the kernels take "
                           f"{lib.bc_level_max_sources()} sources, the "
                           f"wrapper {32 * MAX_WORDS}")
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
        want = torch.float32 if what in _VALUES else torch.int32
        if t.dtype != want:
            raise TypeError(f"{name}: {what} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    n = indptr.shape[0] - 1
    sigma = state["sigma"]
    if indptr.dim() != 1 or indices.dim() != 1 or sigma.dim() != 2 or \
            sigma.shape[0] != n:
        raise ValueError(f"{name}: CSR of {n} rows and [N, S] state expected, "
                         f"got indptr {tuple(indptr.shape)}, indices "
                         f"{tuple(indices.shape)}, sigma "
                         f"{tuple(sigma.shape)}")
    s_pad = sigma.shape[1]
    if s_pad < 32 or s_pad & (s_pad - 1) or s_pad > 32 * MAX_WORDS:
        raise ValueError(f"{name}: source axis {s_pad} is not a power of two "
                         f"from 32 to {32 * MAX_WORDS}")
    parts = max(1, s_pad // PART)
    want = {**{k: (n, s_pad) for k in _VALUES},
            **{k: (n, s_pad // 32) for k in _WORDS},
            **{k: (n, parts) for k in _PARTS}, "live": (s_pad // 32,)}
    for what, t in state.items():
        if tuple(t.shape) != want[what]:
            raise ValueError(f"{name}: {what} {tuple(t.shape)}, want "
                             f"{want[what]}")
    if n >= 2**31 - 1 or indices.shape[0] >= 2**31:
        raise ValueError(f"{name}: graph too large for int32 CSR")
    return n, s_pad


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: "
            f"{_lib().bc_level_error_string(err).decode()} (cudaError {err})")


def bc_forward_level_cuda(in_indptr: torch.Tensor, in_indices: torch.Tensor,
                          sigma: torch.Tensor, visited: torch.Tensor,
                          on: torch.Tensor, base: torch.Tensor,
                          live: torch.Tensor, *, level: int) -> tuple:
    """Launch the forward level kernel (in place); returns the next
    level's ``(on, base, live)`` on the device."""
    n, s_pad = _check("bc_forward_level", in_indptr, in_indices,
                      {"sigma": sigma, "visited": visited, "on": on,
                       "base": base, "live": live})
    on_next = torch.empty_like(on)
    base_next = torch.empty_like(base)
    live_next = torch.zeros_like(live)
    lib = _lib()
    with torch.cuda.device(sigma.device):
        stream = torch.cuda.current_stream(sigma.device).cuda_stream
        err = lib.bc_forward_level_launch(
            in_indptr.data_ptr(), in_indices.data_ptr(), sigma.data_ptr(),
            visited.data_ptr(), on.data_ptr(), on_next.data_ptr(),
            base.data_ptr(), base_next.data_ptr(), live.data_ptr(),
            live_next.data_ptr(), n, s_pad, stream)
    _raise_on(err, "bc_forward_level")
    record_launch("bc_forward_level")
    return on_next, base_next, live_next


def bc_backward_level_cuda(out_indptr: torch.Tensor,
                           out_indices: torch.Tensor, sigma: torch.Tensor,
                           delta: torch.Tensor, coeff: torch.Tensor,
                           on: torch.Tensor, on_below: torch.Tensor,
                           base: torch.Tensor, base_below: torch.Tensor, *,
                           level: int) -> torch.Tensor:
    """Launch the backward level kernel (``delta`` and ``coeff`` in
    place; ``delta`` of the pairs on ``on_below`` is written, not read);
    returns ``delta``.  ``level`` (>= 1) is the level of ``on``,
    which the kernel reads from the masks."""
    if level < 1:
        raise ValueError(f"bc_backward_level: level {level} < 1")
    n, s_pad = _check("bc_backward_level", out_indptr, out_indices,
                      {"sigma": sigma, "delta": delta, "coeff": coeff,
                       "on": on, "on_below": on_below, "base": base,
                       "base_below": base_below})
    lib = _lib()
    with torch.cuda.device(sigma.device):
        stream = torch.cuda.current_stream(sigma.device).cuda_stream
        err = lib.bc_backward_level_launch(
            out_indptr.data_ptr(), out_indices.data_ptr(), sigma.data_ptr(),
            delta.data_ptr(), coeff.data_ptr(), on.data_ptr(),
            on_below.data_ptr(), base.data_ptr(), base_below.data_ptr(), n,
            s_pad, stream)
    _raise_on(err, "bc_backward_level")
    record_launch("bc_backward_level")
    return delta


def _edge_pairs(indptr, indices, sigma, *rest) -> float:
    """(edge, source) pairs a level may pull over, the cost hint."""
    return float(indices.shape[0] * sigma.shape[1])


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
                     sigma: torch.Tensor, visited: torch.Tensor,
                     on: torch.Tensor, base: torch.Tensor,
                     live: torch.Tensor, level: int, *,
                     backend: str | None = None) -> tuple:
    """Forward BFS level ``level`` over the in-edge CSR, in place, from
    the frontier ``on`` (``on[level]``, its values from ``base``) for the
    sources set in ``live``; returns the next level's ``(on, base,
    live)``.

    backend: "cuda" (the hand kernel; CUDA tensors), "ref" (plain
    PyTorch, any device), or None = from the operands' device.
    """
    return dispatch("bc_forward_level", in_indptr, in_indices, sigma,
                    visited, on, base, live, backend=backend,
                    level=int(level))


def bc_backward_level(out_indptr: torch.Tensor, out_indices: torch.Tensor,
                      sigma: torch.Tensor, delta: torch.Tensor,
                      coeff: torch.Tensor, on: torch.Tensor,
                      on_below: torch.Tensor, base: torch.Tensor,
                      base_below: torch.Tensor, level: int, *,
                      backend: str | None = None) -> torch.Tensor:
    """Backward level ``level`` over the out-edge CSR, ``delta`` and
    ``coeff`` in place, with ``on = on[level]``, ``on_below =
    on[level - 1]`` and their ``base``; returns ``delta``.  ``backend`` as
    for :func:`bc_forward_level`.
    """
    return dispatch("bc_backward_level", out_indptr, out_indices, sigma,
                    delta, coeff, on, on_below, base, base_below,
                    backend=backend, level=int(level))
