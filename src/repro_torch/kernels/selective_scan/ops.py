"""Public wrapper for Mamba's selective scan, forward and backward.

Registers op ``selective_scan`` with the port's dispatch registry.  Its
CUDA body launches the hand-written kernel of ``csrc/selective_scan.cu``
(one launch for the whole scan); its reference body is the plain PyTorch
version of ``ref.py``, which describes the operands.  The state is
updated in place, so dispatch must hand the bodies the caller's own
tensors: the op declares no elastic axis, and dispatch pads nothing.

Training: when an operand requires grad, :func:`selective_scan` goes
through :class:`SelectiveScan`, an autograd function whose forward runs op
``selective_scan`` with the kernel's state checkpoints on (every 16 steps;
``y`` and the state keep their bits) and whose backward runs op
``selective_scan_bwd``: on CUDA tensors the hand-written backward kernel
``csrc/selective_scan_bwd.cu`` (it recomputes the states between
checkpoints; deterministic; its two launches counted as one), on the CPU
autograd over the unchanged plain forward (``selective_scan_bwd_ref``),
which keeps only the initial state.  The JAX package trains through XLA's
autodiff of its ``lax.scan``.  Under ``torch.utils.checkpoint`` the
forward runs twice and the backward once a layer.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..dispatch import (KernelOp, dispatch, record_launch, register_kernel,
                        resolve_backend, trace_only, traced)
from .ref import selective_scan_bwd_ref, selective_scan_ref

__all__ = ["selective_scan", "selective_scan_cuda", "selective_scan_ref",
           "selective_scan_bwd_cuda", "selective_scan_bwd_ref",
           "selective_scan_bwd_plan",
           "SelectiveScan", "STATE_SIZES", "CKPT_EVERY",
           "selective_scan_work", "selective_scan_bwd_work", "OPS_A_STEP",
           "BWD_OPS_A_STEP"]

#: state sizes N the kernel is built for
STATE_SIZES = (4, 8, 16)
#: steps between two of the forward kernel's state checkpoints
CKPT_EVERY = 16
#: the kernel's grid puts the batch on blockIdx.y
_MAX_BATCH = 65535


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built and loaded on first use."""
    lib = _build.load("selective_scan")
    lib.selective_scan_launch.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.selective_scan_launch.restype = ctypes.c_int
    lib.selective_scan_error_string.argtypes = [ctypes.c_int]
    lib.selective_scan_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    """The backward kernel's library, built and loaded on first use."""
    lib = _build.load("selective_scan_bwd")
    lib.selective_scan_bwd_launch.argtypes = [ctypes.c_void_p] * 15 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.selective_scan_bwd_launch.restype = ctypes.c_int
    lib.selective_scan_bwd_workspace.argtypes = [ctypes.c_int] * 4
    lib.selective_scan_bwd_workspace.restype = ctypes.c_longlong
    lib.selective_scan_bwd_error_string.argtypes = [ctypes.c_int]
    lib.selective_scan_bwd_error_string.restype = ctypes.c_char_p
    lib.selective_scan_bwd_plan.argtypes = [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.selective_scan_bwd_plan.restype = ctypes.c_int
    return lib


#: what ``selective_scan_bwd_plan`` reports of the backward kernel's launch
BWD_PLAN_KEYS = ("values_a_lane", "steps_a_sub_chunk", "threads_a_block",
                 "blocks_a_cluster", "shared_bytes_a_block",
                 "registers_a_thread", "local_bytes_a_thread",
                 "blocks_an_sm", "clusters_resident", "blocks_launched")


def selective_scan_bwd_plan(b, s, di, n) -> dict:
    """The backward kernel's launch at this shape, as the card reports it
    (``BWD_PLAN_KEYS``: residency from the CUDA occupancy calculator).
    Needs the card; for measurement, never on the main path."""
    lib = _bwd_lib()
    out = (ctypes.c_int * len(BWD_PLAN_KEYS))()
    err = lib.selective_scan_bwd_plan(b, s, di, n, ctypes.addressof(out))
    if err != 0:
        msg = lib.selective_scan_bwd_error_string(err).decode()
        raise RuntimeError(f"selective_scan_bwd_plan: {msg}")
    return dict(zip(BWD_PLAN_KEYS, out))


def checkpoint_count(s: int) -> int:
    """Checkpoints the forward kernel keeps of an S-step scan: the state
    before steps 0, 16, 32, ... and, when 16 divides S, after the last."""
    return s // CKPT_EVERY + 1


def _check(xi, dt, bm, cm, a, state) -> tuple:
    """Device, dtype, shape and contiguity; returns ``(B, S, Di, N)``."""
    named = (("xi", xi), ("dt", dt), ("bm", bm), ("cm", cm), ("a", a),
             ("state", state))
    for what, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"selective_scan: {what} must be float32, got "
                            f"{t.dtype}")
    dev = xi.device
    if dev.type != "cuda" and not traced(xi):
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
                        state: torch.Tensor, *,
                        checkpoints: bool = False) -> tuple:
    """Launch the kernel: ``(y, state)``, ``state`` updated in place; with
    ``checkpoints`` also the states the backward kernel starts from,
    ``[B, Di, checkpoint_count(S), N]`` float32."""
    b, s, di, n = _check(xi, dt, bm, cm, a, state)
    y = torch.empty((b, s, di), dtype=torch.float32, device=xi.device)
    ckpt = torch.empty((b, di, checkpoint_count(s), n), dtype=torch.float32,
                       device=xi.device) if checkpoints else None
    if trace_only("selective_scan", xi, dt, bm, cm, a, state,
                  checkpoints=checkpoints):
        return (y, state, ckpt) if checkpoints else (y, state)
    lib = _lib()
    with torch.cuda.device(xi.device):
        stream = torch.cuda.current_stream(xi.device).cuda_stream
        err = lib.selective_scan_launch(
            xi.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            a.data_ptr(), state.data_ptr(), y.data_ptr(),
            None if ckpt is None else ckpt.data_ptr(), b, s, di, n, stream)
    if err != 0:
        raise RuntimeError(
            f"selective_scan kernel launch failed: "
            f"{lib.selective_scan_error_string(err).decode()} "
            f"(cudaError {err})")
    record_launch("selective_scan", xi, dt, bm, cm, a, state,
                  checkpoints=checkpoints)
    return (y, state, ckpt) if checkpoints else (y, state)


def selective_scan_bwd_cuda(xi: torch.Tensor, dt: torch.Tensor,
                            bm: torch.Tensor, cm: torch.Tensor,
                            a: torch.Tensor, ckpt: torch.Tensor,
                            dy: torch.Tensor, dstate: torch.Tensor) -> tuple:
    """Launch the backward kernel: the operands as
    :func:`selective_scan_cuda` took them, ``ckpt`` its checkpoints, ``dy``
    the gradient of ``y`` and ``dstate`` that of the final state.  Returns
    ``(dxi, ddt, dbm, dcm, da, dstate0)``, dstate0 the initial state's
    gradient."""
    b, s, di, n = _check(xi, dt, bm, cm, a, dstate)
    for what, t, shape in (("ckpt", ckpt, (b, di, checkpoint_count(s), n)),
                           ("dy", dy, (b, s, di))):
        if t.dtype != torch.float32 or t.device != xi.device or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"selective_scan_bwd: {what} must be a "
                             f"contiguous float32 {shape} tensor on "
                             f"{xi.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    dxi, ddt, dbm, dcm, da, dstate0 = (torch.empty_like(t) for t in (
        xi, dt, bm, cm, a, dstate))
    if trace_only("selective_scan_bwd", xi, dt, bm, cm, a, ckpt, dy, dstate):
        return dxi, ddt, dbm, dcm, da, dstate0
    lib = _bwd_lib()
    work = torch.empty(lib.selective_scan_bwd_workspace(b, s, di, n),
                       dtype=torch.uint8, device=xi.device)
    with torch.cuda.device(xi.device):
        stream = torch.cuda.current_stream(xi.device).cuda_stream
        err = lib.selective_scan_bwd_launch(
            xi.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
            a.data_ptr(), ckpt.data_ptr(), dy.data_ptr(), dstate.data_ptr(),
            dxi.data_ptr(), ddt.data_ptr(), dbm.data_ptr(), dcm.data_ptr(),
            da.data_ptr(), dstate0.data_ptr(), work.data_ptr(), b, s, di, n,
            stream)
    if err != 0:
        raise RuntimeError(
            f"selective_scan_bwd kernel launch failed: "
            f"{lib.selective_scan_bwd_error_string(err).decode()} "
            f"(cudaError {err})")
    record_launch("selective_scan_bwd", xi, dt, bm, cm, a, ckpt, dy, dstate)
    return dxi, ddt, dbm, dcm, da, dstate0


def _cost(xi, dt, bm, cm, a, *rest) -> float:
    """State values updated over the scan, the cost hint."""
    return float(xi.numel() * a.shape[-1])


#: float operations a state value and step, counted from the reference's
#: step (an exp as one): dt*A, exp, x*B, dt*bx, state*dA, +, state*C, +
OPS_A_STEP = 8
#: the same for the backward, the step recomputed from the checkpoints
#: included: dt*A, exp, x*B, dt*xB, P*e, + again, then dy*C + G', G*dt,
#: G*Pe, and the dx, ddt, dA, dB, dC terms with their sums, G*e
BWD_OPS_A_STEP = 24


def selective_scan_work(*args, **_static) -> tuple:
    """(flops, bytes) of one forward call: its operands read once and its
    outputs written once (float32; the state both ways), against
    ``OPS_A_STEP`` float operations a state value and step."""
    *ops, state = args
    seq = ops[0]
    per_step = ops[4].shape[-1]
    n_bytes = 4 * (sum(t.numel() for t in ops) + 2 * state.numel()
                   + seq.numel())
    return float(OPS_A_STEP * seq.numel() * per_step), float(n_bytes)


def selective_scan_bwd_work(*args, **_static) -> tuple:
    """(flops, bytes) of one backward call: its operands, the forward's
    checkpoints and the two gradients it starts from read once, its six
    gradients written once (float32), against ``BWD_OPS_A_STEP`` float
    operations a state value and step."""
    *ops, ckpt, dout, dstate = args
    per_step = ops[4].shape[-1]
    n_in = sum(t.numel() for t in (*ops, ckpt, dout, dstate))
    n_out = sum(t.numel() for t in ops) + dstate.numel()
    return (float(BWD_OPS_A_STEP * ops[0].numel() * per_step),
            float(4 * (n_in + n_out)))


register_kernel(KernelOp(
    name="selective_scan",
    cuda_body=selective_scan_cuda,
    reference_body=selective_scan_ref,
    cost_hint=_cost,
    work=selective_scan_work,
))


register_kernel(KernelOp(
    name="selective_scan_bwd",
    cuda_body=selective_scan_bwd_cuda,
    reference_body=selective_scan_bwd_ref,
    cost_hint=_cost,
    work=selective_scan_bwd_work,
))


class SelectiveScan(torch.autograd.Function):
    """The scan with its backward kernel: ``apply(xi, dt, bm, cm, a, state,
    backend)`` -> ``(y, state)``, ``state`` updated in place.  The forward
    keeps xi, dt, bm, cm, a and the states the backward starts from: the
    CUDA kernel's checkpoints, or (plain version) the initial state."""

    @staticmethod
    def forward(ctx, xi, dt, bm, cm, a, state, backend):
        backend = resolve_backend(backend, xi.device)
        if backend == "cuda":
            y, _, ckpt = dispatch("selective_scan", xi, dt, bm, cm, a, state,
                                  backend=backend, checkpoints=True)
        else:
            ckpt = state.detach().float().clone()[:, :, None]
            y, _ = dispatch("selective_scan", xi, dt, bm, cm, a, state,
                            backend=backend)
        ctx.mark_dirty(state)
        ctx.save_for_backward(xi, dt, bm, cm, a, ckpt)
        ctx.backend = backend
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        xi, dt, bm, cm, a, ckpt = ctx.saved_tensors
        grads = dispatch("selective_scan_bwd", xi, dt, bm, cm, a, ckpt,
                         dy.float().contiguous(),
                         dstate.float().contiguous(), backend=ctx.backend)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad)) + (None,)


def selective_scan(xi: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                   cm: torch.Tensor, a: torch.Tensor, state: torch.Tensor, *,
                   backend: str | None = None) -> tuple:
    """Mamba's selective scan over the S steps of ``xi`` from ``state``
    (updated in place); returns ``(y [B, S, Di] float32, state)``.
    Differentiable: with grad enabled and an operand that requires it, it
    runs :class:`SelectiveScan`.

    backend: "cuda" (the hand kernel; CUDA tensors), "ref" (plain
    PyTorch, any device), or None = from the operands' device.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xi, dt, bm, cm, a, state)):
        return SelectiveScan.apply(xi, dt, bm, cm, a, state, backend)
    return dispatch("selective_scan", xi, dt, bm, cm, a, state,
                    backend=backend)
