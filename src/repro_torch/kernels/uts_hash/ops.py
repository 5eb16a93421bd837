"""Public wrappers for the UTS kernels + tree-shape helpers.

Counterpart of ``repro.kernels.uts_hash.ops``, with two registrations in
the port's dispatch registry, both backed by ``csrc/uts_hash.cu``:

* ``uts_hash`` (``uts_child_digests``): SHA-1 child digests of a batch of
  (parent, child index) pairs; the reference body is the plain PyTorch
  SHA-1 of ``ref.py``.  The UTS path uses it for the root digest.
* ``uts_expand`` (``uts_expand``): a whole task's traversal, every
  generation of it, in one launch of one thread block cluster that keeps
  the LIFO stack on the card, on a stream of the task's own
  (``device.task_stream``), so concurrent tasks share the card; the host
  reads two integers per launch.  Its reference body is
  ``uts_expand_ref``.  The kernel stops when its work buffer is full;
  :func:`expand_relaunching` grows the buffer and launches again, the
  same loop over either body.

``root_digest``, ``random_u31`` and ``geometric_children`` give the tree
shape.
"""
from __future__ import annotations

import ctypes
import functools
import threading
import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...core import telemetry
from ...device import task_stream
from .. import _build
from ..dispatch import KernelOp, dispatch, record_launch, register_kernel
from .ref import (_thresholds_on, geometric_children, random_u31,
                  uts_child_digests_ref, uts_expand_ref)

__all__ = [
    "uts_child_digests", "uts_child_digests_ref", "uts_hash_cuda",
    "uts_expand", "uts_expand_ref", "uts_expand_cuda", "expand_relaunching",
    "expand_generations", "reset_expand_generations", "Overlap",
    "expand_overlap", "reset_expand_overlap", "expand_plan",
    "root_digest", "random_u31", "geometric_children",
]

#: uts_expand's status codes (``csrc/uts_hash.cu``): ran out, buffer full
_DONE, _CAPACITY = 0, 1

# generations run by uts_expand's kernel; pool workers launch
# concurrently, so the read-modify-write holds a lock
_GENS = [0]
_GENS_LOCK = threading.Lock()


class Overlap(NamedTuple):
    """``uts_expand`` launches since the last reset, each seen at its
    launch against the others of the process in flight (launched, their
    stream not yet synchronised)."""

    launches: int
    #: launches that found at least one other in flight
    overlapped: int
    #: the others in flight, summed over the launches
    others: int
    #: most launches in flight at once, the launching one included
    peak: int


# launches in flight now, and the Overlap counts; under _GENS_LOCK
_IN_FLIGHT = [0]
_OVERLAP = [0, 0, 0, 0]


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library, built and loaded on first use."""
    lib = _build.load("uts_hash")
    fn = lib.uts_hash_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.uts_expand_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.uts_expand_plan.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.uts_expand_plan.restype = ctypes.c_int
    lib.uts_expand_max_table.argtypes = []
    lib.uts_expand_max_table.restype = ctypes.c_int
    lib.uts_hash_error_string.argtypes = [ctypes.c_int]
    lib.uts_hash_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: "
            f"{_lib().uts_hash_error_string(err).decode()} (cudaError {err})")


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
    _raise_on(err, "uts_hash")
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


def root_digest(seed: int, device: torch.device) -> torch.Tensor:
    """Root node state: SHA1(zero_digest || be32(seed)), [5, 1] int32,
    through ``uts_hash`` (the kernel on a CUDA device)."""
    zero = torch.zeros((5, 1), dtype=torch.int32, device=device)
    ix = torch.from_numpy(np.array([seed], np.uint32).view(np.int32))
    return uts_child_digests(zero, ix.to(device))


# -- uts_expand -------------------------------------------------------------

def expand_relaunching(step: Callable[..., tuple], digests: torch.Tensor,
                       depths: torch.Tensor, iters: int, *, chunk: int,
                       capacity: Optional[int] = None,
                       **params) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Traverse up to ``iters`` nodes of the bag through ``step``, growing
    the stack's capacity and stepping again while a step stops short.

    ``step`` is ``uts_expand_ref`` or one kernel launch: it takes the bag,
    the remaining budget and a capacity, and returns (count, leftover
    digests, leftover depths), stopping early only where the next
    generation would overflow the capacity.  The capacity starts at
    ``capacity`` or ``max(2 S, S + 8 chunk)`` and doubles.  An empty bag
    or ``iters <= 0`` comes back untouched without a step.
    """
    size = depths.shape[0]
    if size == 0 or iters <= 0:
        return 0, digests, depths
    cap = max(capacity or max(2 * size, size + 8 * chunk), size)
    count = 0
    while True:
        done, digests, depths = step(digests, depths, iters - count,
                                     chunk=chunk, capacity=cap, **params)
        count += done
        size = depths.shape[0]
        if count >= iters or size == 0:
            return count, digests, depths
        cap = max(2 * cap, size)


def _launch_began() -> None:
    """Count a launch against the others in flight; it is in flight now."""
    with _GENS_LOCK:
        others = _IN_FLIGHT[0]
        _IN_FLIGHT[0] += 1
        _OVERLAP[0] += 1
        _OVERLAP[1] += others > 0
        _OVERLAP[2] += others
        _OVERLAP[3] = max(_OVERLAP[3], others + 1)


def _launch_ended() -> None:
    """A launch's stream is synchronised (or its launch failed)."""
    with _GENS_LOCK:
        _IN_FLIGHT[0] -= 1


def _expand_launch(digests: torch.Tensor, depths: torch.Tensor, iters: int,
                   *, b0: float, max_depth: int, chunk: int,
                   max_children: int, capacity: int
                   ) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """One launch of uts_expand_kernel on a stream of the task's own
    (``task_stream``): the bag copied into a work buffer of ``capacity``
    nodes, the state read back once through pinned memory, the leftover
    copied out to fresh tensors (the pool keeps split views of them,
    which must not pin a work buffer).  The work buffer comes from the
    caller's stream's memory, so that the allocator keeps one cache of
    them and not one on each of the pool's streams; the task's stream
    waits for the caller's (which may still use that memory, or be making
    the bag) and is synchronised before the leftover is returned, so it is
    whole on every stream; the caller's stream is recorded on the
    leftover for the allocator.  With spans on, the four steps are
    ``uts.stage_in``, ``uts.launch``, ``uts.wait`` and ``uts.leftover``,
    under the thread's current task."""
    t_in = time.monotonic() if telemetry.SPANS_ON else None
    dev = depths.device
    size = depths.shape[0]
    table = _thresholds_on(float(b0), int(max_children), dev)
    caller = torch.cuda.current_stream(dev)
    work_d = torch.empty((5, capacity), dtype=torch.int32, device=dev)
    work_p = torch.empty((capacity,), dtype=torch.int32, device=dev)
    state = torch.empty((4,), dtype=torch.int64, device=dev)
    lib = _lib()
    with torch.cuda.device(dev), task_stream(dev):
        stream = torch.cuda.current_stream(dev)
        stream.wait_stream(caller)
        work_d[:, :size].copy_(digests)
        work_p[:size].copy_(depths)
        if t_in is not None:
            t_launch = time.monotonic()
        _launch_began()
        try:
            err = lib.uts_expand_launch(
                work_d.data_ptr(), work_p.data_ptr(), capacity, size, iters,
                chunk, max_depth, table.data_ptr(), table.shape[0],
                state.data_ptr(), stream.cuda_stream)
            _raise_on(err, "uts_expand")
            record_launch("uts_expand")
            if t_in is not None:
                t_wait = time.monotonic()
            host = torch.empty((4,), dtype=torch.int64, pin_memory=True)
            host.copy_(state, non_blocking=True)
            stream.synchronize()
        finally:
            _launch_ended()
        # the state words: count, S, generations, status
        count, size, gens, status = (int(v) for v in host.tolist())
        if status not in (_DONE, _CAPACITY):
            raise RuntimeError(f"uts_expand: kernel state {host.tolist()}")
        with _GENS_LOCK:
            _GENS[0] += gens
        if t_in is not None:
            t_left = time.monotonic()
        left = work_d[:, :size].clone(), work_p[:size].clone()
        stream.synchronize()
    for t in left:
        t.record_stream(caller)
    if t_in is not None:
        task = telemetry.current_task()
        telemetry.add_span("uts.stage_in", t_in, t_launch, task)
        telemetry.add_span("uts.launch", t_launch, t_wait, task)
        telemetry.add_span("uts.wait", t_wait, t_left, task)
        telemetry.add_span("uts.leftover", t_left, time.monotonic(), task)
    return (count, *left)


def uts_expand_cuda(digests: torch.Tensor, depths: torch.Tensor, iters: int,
                    *, b0: float, max_depth: int, chunk: int,
                    max_children: int = 64, capacity: Optional[int] = None
                    ) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """``uts_expand`` through the kernel: check the bag, then launch (and
    relaunch with a larger buffer while the stack outgrows it)."""
    if digests.dtype != torch.int32 or depths.dtype != torch.int32:
        raise TypeError(
            f"uts_expand_cuda: int32 digests and depths expected, got "
            f"{digests.dtype} and {depths.dtype}")
    if digests.device.type != "cuda" or depths.device != digests.device:
        raise ValueError(
            f"uts_expand_cuda: CUDA tensors on one device expected, got "
            f"{digests.device} and {depths.device}")
    if digests.dim() != 2 or digests.shape[0] != 5 or \
            depths.shape != (digests.shape[1],):
        raise ValueError(
            f"uts_expand_cuda: shapes [5, S] and [S] expected, got "
            f"{tuple(digests.shape)} and {tuple(depths.shape)}")
    if chunk < 1 or not 0 < max_children <= _lib().uts_expand_max_table():
        raise ValueError(
            f"uts_expand_cuda: chunk {chunk} and max_children {max_children} "
            f"must be >= 1 and in 1..{_lib().uts_expand_max_table()}")
    return expand_relaunching(
        _expand_launch, digests, depths, iters, chunk=chunk,
        capacity=capacity, b0=b0, max_depth=max_depth,
        max_children=max_children)


def _expand_plain(digests: torch.Tensor, depths: torch.Tensor, iters: int,
                  *, b0: float, max_depth: int, chunk: int,
                  max_children: int = 64, capacity: Optional[int] = None
                  ) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """``uts_expand`` through the plain version, over the same loop."""
    return expand_relaunching(
        uts_expand_ref, digests, depths, iters, chunk=chunk,
        capacity=capacity, b0=b0, max_depth=max_depth,
        max_children=max_children)


register_kernel(KernelOp(
    name="uts_expand",
    cuda_body=uts_expand_cuda,
    reference_body=_expand_plain,
    # no elastic axes: a padded node would be expanded
    cost_hint=lambda digests, depths: float(depths.shape[0]),
))


def uts_expand(digests: torch.Tensor, depths: torch.Tensor, iters: int, *,
               b0: float, max_depth: int, chunk: int, max_children: int = 64,
               capacity: Optional[int] = None, backend: str | None = None
               ) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """Traverse up to ``iters`` nodes of a bag: (count, leftover digests,
    leftover depths), LIFO by generations of at most ``chunk`` nodes.

    digests [5, S] int32 (uint32 bits), depths [S] int32.  ``capacity``:
    the work buffer's first size in nodes (default ``max(2 S, S + 8
    chunk)``; it doubles as needed).  backend: "cuda" (the kernel; CUDA
    tensors), "ref" (plain PyTorch, any device), or None = from the
    operands' device.  An empty bag or ``iters <= 0`` returns the bag
    untouched.
    """
    return dispatch("uts_expand", digests, depths, backend=backend,
                    iters=iters, b0=b0, max_depth=max_depth, chunk=chunk,
                    max_children=max_children, capacity=capacity)


def expand_generations() -> int:
    """Generations run by ``uts_expand``'s kernel since the last reset."""
    return _GENS[0]


def reset_expand_generations() -> None:
    with _GENS_LOCK:
        _GENS[0] = 0


def expand_overlap() -> Overlap:
    """``uts_expand`` kernel launches since the last reset, and how many
    others of the process each found in flight (for measurement)."""
    with _GENS_LOCK:
        return Overlap(*_OVERLAP)


def reset_expand_overlap() -> None:
    """Zero the counts of :func:`expand_overlap`; launches in flight stay
    counted as such."""
    with _GENS_LOCK:
        _OVERLAP[:] = [0, 0, 0, 0]


def expand_plan(chunk: int, device: Optional[torch.device] = None) -> dict:
    """The launch ``uts_expand``'s kernel makes at ``chunk`` on a CUDA
    device: blocks a cluster, threads a block, dynamic shared bytes a
    block, clusters resident on the card at once
    (``cudaOccupancyMaxActiveClusters``), registers and local (spill)
    bytes a thread, static shared bytes a block."""
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(device if device is not None else 0):
        _raise_on(_lib().uts_expand_plan(int(chunk), ctypes.addressof(out)),
                  "uts_expand plan")
    keys = ("cluster", "threads", "smem_bytes", "clusters_resident",
            "registers", "local_bytes", "static_smem_bytes")
    return dict(zip(keys, out))
