"""Kernel dispatch of the PyTorch port: one registry, one padding policy.

Counterpart of ``repro.kernels.dispatch``, rewritten for PyTorch (the
original is built on ``jax.jit``).  The surface is the same:

* :class:`KernelOp` describes one kernel: the hand-written CUDA body,
  the plain PyTorch reference body, which argument axes are *elastic*
  (sized by the irregular workload and therefore padded), the pad
  constants, the bucket floor, and an a-priori cost hint.
* :func:`register_kernel` / :func:`get_kernel` /
  :func:`registered_kernels` are the registry.
* :func:`dispatch` is the single entry point.  It owns

  - **backend resolution**: ``"cuda"`` (the hand kernel) or ``"ref"``
    (plain PyTorch).  ``None`` resolves from the operands' device:
    ``cuda`` for CUDA tensors, ``ref`` for CPU tensors.  ``"ref"`` may be
    forced on CUDA tensors to compare a kernel with its plain version;
    ``"cuda"`` on CPU tensors raises.  There is no fallback: a CUDA body
    that fails raises.
  - **bucket padding**: every elastic axis is padded up to the next
    power of two >= the op's floor, with the same floors and pad
    constants as the reference package, so the set of distinct launch
    shapes over a run stays O(log max_size);
  - the :func:`compile_log` of distinct (backend, static kwargs, padded
    signature) launches, which the tests bound;
  - **unpadding** of the output back to the caller's sizes;
  - a plain integer **launch count** per op (:func:`launches`), which
    each CUDA body bumps through :func:`record_launch` right where it
    launches its kernel, so a run can show it went through the kernel.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple, Union

import torch

__all__ = [
    "KernelOp", "register_kernel", "get_kernel", "registered_kernels",
    "dispatch", "bucket", "resolve_backend",
    "compile_log", "reset_compile_log", "estimate_cost",
    "launches", "record_launch", "reset_launches",
]

BACKENDS = ("cuda", "ref")


def resolve_backend(backend: Optional[str], device: torch.device) -> str:
    """Canonical backend; ``None`` = ``cuda`` on a CUDA device, else ``ref``."""
    if backend is None:
        return "cuda" if device.type == "cuda" else "ref"
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of "
            f"{', '.join(BACKENDS)}")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(
            f"backend 'cuda' needs CUDA tensors, got tensors on {device}")
    return backend


def bucket(n: int, floor: int = 128) -> int:
    """Next power-of-two >= max(floor, n)."""
    if floor < 1:
        raise ValueError("bucket floor must be >= 1")
    b = floor
    while b < n:
        b <<= 1
    return b


@dataclass(frozen=True)
class KernelOp:
    """Declarative description of one dispatchable kernel.

    ``arg_dims`` names the *elastic* axes: for each positional tensor
    argument, a tuple of ``(axis, dim_name)`` pairs.  Axes sharing a
    ``dim_name`` must agree in size and are padded to the same bucket.
    ``out_dims`` locates the same named dims on the (single) output so
    :func:`dispatch` can slice the padding back off.
    """

    name: str
    #: hand-kernel body: ``(*tensors, **static) -> tensor`` (CUDA tensors)
    cuda_body: Callable[..., Any]
    #: plain PyTorch body with the same signature, any device
    reference_body: Callable[..., Any]
    #: per-argument elastic axes: ((axis, dim_name), ...) per positional arg
    arg_dims: Tuple[Tuple[Tuple[int, str], ...], ...] = ()
    #: per-argument pad constant (only used for args with elastic axes)
    pad_values: Tuple[Any, ...] = ()
    #: elastic axes of the output, for unpadding
    out_dims: Tuple[Tuple[int, str], ...] = ()
    #: bucket floor for every elastic dim of this op
    bucket_floor: int = 128
    #: a-priori work estimate from the *unpadded* operands
    cost_hint: Callable[..., float] = field(default=lambda *args: 1.0)

    def __post_init__(self) -> None:
        if self.pad_values and len(self.pad_values) != len(self.arg_dims):
            raise ValueError(
                f"{self.name}: pad_values ({len(self.pad_values)}) and "
                f"arg_dims ({len(self.arg_dims)}) must align")


_REGISTRY: Dict[str, KernelOp] = {}
# op name -> set of (backend, static-kwargs, padded arg signatures): one
# entry per distinct launch shape; capped so a long-lived process does
# not grow this diagnostic set forever
_COMPILE_LOG: Dict[str, Set[tuple]] = {}
_COMPILE_LOG_CAP = 4096
# op name -> kernel launches of its CUDA body; pool workers launch
# concurrently, so the read-modify-write holds a lock
_LAUNCHES: Dict[str, int] = {}
_LAUNCHES_LOCK = threading.Lock()


def register_kernel(op: KernelOp) -> KernelOp:
    """Add ``op`` to the registry (idempotent on re-import); re-registering
    a name drops its compile log and launch count."""
    if op.name in _REGISTRY:
        _COMPILE_LOG.pop(op.name, None)
        _LAUNCHES.pop(op.name, None)
    _REGISTRY[op.name] = op
    return op


def _ensure_registered() -> None:
    # Kernel packages self-register at import; pull the shipped ops in
    # for callers that touch the registry before importing either.
    if {"uts_hash", "mandelbrot"} <= _REGISTRY.keys():
        return
    from .uts_hash import ops as _u      # noqa: F401
    from .mandelbrot import ops as _m    # noqa: F401


def get_kernel(name: str) -> KernelOp:
    if name not in _REGISTRY:
        _ensure_registered()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel {name!r}; registered: "
            f"{', '.join(sorted(_REGISTRY))}") from None


def registered_kernels() -> List[str]:
    _ensure_registered()
    return sorted(_REGISTRY)


def compile_log(name: Optional[str] = None) -> Dict[str, Set[tuple]]:
    """Distinct (backend, static, padded-shape) signatures dispatched so
    far.  The bucketing policy keeps ``len(compile_log()[op])`` at
    O(log max_operand_size) over a run."""
    if name is not None:
        return {name: set(_COMPILE_LOG.get(name, set()))}
    return {k: set(v) for k, v in _COMPILE_LOG.items()}


def reset_compile_log(name: Optional[str] = None) -> None:
    if name is None:
        _COMPILE_LOG.clear()
    else:
        _COMPILE_LOG.pop(name, None)


def launches(name: str) -> int:
    """How many times ``name``'s CUDA body has launched its kernel."""
    return _LAUNCHES.get(name, 0)


def record_launch(name: str) -> None:
    """Count one kernel launch of ``name`` (called by its CUDA body)."""
    with _LAUNCHES_LOCK:
        _LAUNCHES[name] = _LAUNCHES.get(name, 0) + 1


def reset_launches(name: Optional[str] = None) -> None:
    with _LAUNCHES_LOCK:
        if name is None:
            _LAUNCHES.clear()
        else:
            _LAUNCHES.pop(name, None)


def estimate_cost(op: Union[str, KernelOp], *args: Any) -> float:
    """The op's a-priori work estimate for these (unpadded) operands."""
    if isinstance(op, str):
        op = get_kernel(op)
    return float(op.cost_hint(*args))


def _pad(t: torch.Tensor, sizes: List[int], value: Any) -> torch.Tensor:
    out = torch.full(sizes, value, dtype=t.dtype, device=t.device)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


def dispatch(op: Union[str, KernelOp], *args: torch.Tensor,
             backend: Optional[str] = None, **static: Any) -> torch.Tensor:
    """Run a registered kernel: pad -> call -> unpad.

    ``static`` kwargs (iteration counts...) are forwarded to the op
    bodies and must be hashable; they key the compile log alongside the
    backend and the bucketed operand shapes.
    """
    if isinstance(op, str):
        op = get_kernel(op)
    devices = {a.device for a in args}
    if len(devices) != 1:
        raise ValueError(f"{op.name}: operands on several devices {devices}")
    backend = resolve_backend(backend, devices.pop())

    # -- measure the elastic dims off the unpadded operands ---------------
    dims: Dict[str, int] = {}
    for i, (arr, adims) in enumerate(zip(args, op.arg_dims)):
        for axis, dname in adims:
            size = arr.shape[axis]
            if dims.setdefault(dname, size) != size:
                raise ValueError(
                    f"{op.name}: dim {dname!r} is {dims[dname]} but arg "
                    f"{i} axis {axis} has size {size}")

    buckets = {d: bucket(n, op.bucket_floor) for d, n in dims.items()}

    # -- pad every elastic axis up to its bucket ---------------------------
    padded = []
    for i, arr in enumerate(args):
        adims = op.arg_dims[i] if i < len(op.arg_dims) else ()
        sizes = list(arr.shape)
        for axis, dname in adims:
            sizes[axis] = buckets[dname]
        if sizes != list(arr.shape):
            pv = op.pad_values[i] if i < len(op.pad_values) else 0
            arr = _pad(arr, sizes, pv)
        padded.append(arr)

    skey = tuple(sorted(static.items()))
    sig = tuple((tuple(a.shape), str(a.dtype)) for a in padded)
    log = _COMPILE_LOG.setdefault(op.name, set())
    if len(log) < _COMPILE_LOG_CAP:
        log.add((backend, skey, sig))

    body = op.cuda_body if backend == "cuda" else op.reference_body
    out = body(*padded, **static)

    # -- slice the padding back off ---------------------------------------
    if op.out_dims:
        index: List[Any] = [slice(None)] * out.ndim
        for axis, dname in op.out_dims:
            index[axis] = slice(0, dims[dname])
        out = out[tuple(index)]
    return out
