"""Public wrapper for RWKV-6's WKV recurrence, forward and backward.

Registers op ``wkv6`` with the port's dispatch registry.  Its CUDA body
launches the hand-written kernel of ``csrc/wkv6.cu`` (one launch for the
whole scan); its reference body is the plain PyTorch version of
``ref.py``, which describes the operands.  The state is updated in place,
so dispatch must hand the bodies the caller's own tensors: the op
declares no elastic axis, and dispatch pads nothing.

Training: when an operand requires grad, :func:`wkv6` goes through
:class:`WKV6`, an autograd function whose forward runs op ``wkv6`` with
the kernel's state checkpoints on (every 16 steps; ``o`` and the state
keep their bits) and whose backward runs op ``wkv6_bwd``: on CUDA tensors
the hand-written backward kernel ``csrc/wkv6_bwd.cu`` (it recomputes the
states between checkpoints; deterministic; its two launches counted as
one), on the CPU autograd over the unchanged plain forward
(``wkv6_bwd_ref``), which keeps only the initial state.  The JAX package
trains through XLA's autodiff of its ``lax.scan``.  Under
``torch.utils.checkpoint`` the forward runs twice and the backward once a
layer.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from ..dispatch import (KernelOp, dispatch, record_launch, register_kernel,
                        resolve_backend, trace_only, traced)
from .ref import wkv6_bwd_ref, wkv6_ref

__all__ = ["wkv6", "wkv6_cuda", "wkv6_ref", "wkv6_bwd_cuda", "wkv6_bwd_ref",
           "wkv6_bwd_plan", "WKV6", "HEAD_SIZES", "CKPT_EVERY",
           "wkv6_work", "wkv6_bwd_work", "OPS_A_STEP",
           "BWD_OPS_A_STEP"]

#: head sizes the kernel is built for: rwkv6-1.6b's and its smoke config's
HEAD_SIZES = (16, 64)
#: steps between two of the forward kernel's state checkpoints
CKPT_EVERY = 16


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built and loaded on first use."""
    lib = _build.load("wkv6")
    lib.wkv6_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.wkv6_launch.restype = ctypes.c_int
    lib.wkv6_error_string.argtypes = [ctypes.c_int]
    lib.wkv6_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    """The backward kernel's library, built and loaded on first use."""
    lib = _build.load("wkv6_bwd")
    lib.wkv6_bwd_launch.argtypes = [ctypes.c_void_p] * 15 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.wkv6_bwd_launch.restype = ctypes.c_int
    lib.wkv6_bwd_workspace.argtypes = [ctypes.c_int] * 4
    lib.wkv6_bwd_workspace.restype = ctypes.c_longlong
    lib.wkv6_bwd_error_string.argtypes = [ctypes.c_int]
    lib.wkv6_bwd_error_string.restype = ctypes.c_char_p
    lib.wkv6_bwd_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.wkv6_bwd_plan.restype = ctypes.c_int
    return lib


#: what ``wkv6_bwd_plan`` reports of the backward kernel's launch
BWD_PLAN_KEYS = ("values_a_lane", "rows_a_thread", "steps_a_sub_chunk",
                 "threads_a_block", "blocks_a_cluster", "shared_bytes_a_block",
                 "registers_a_thread", "local_bytes_a_thread",
                 "blocks_an_sm", "clusters_resident", "blocks_launched")


def wkv6_bwd_plan(b, s, h, hd) -> dict:
    """The backward kernel's launch at this shape, as the card reports it
    (``BWD_PLAN_KEYS``: residency from the CUDA occupancy calculator).
    Needs the card; for measurement, never on the main path."""
    lib = _bwd_lib()
    out = (ctypes.c_int * len(BWD_PLAN_KEYS))()
    err = lib.wkv6_bwd_plan(b, s, h, hd, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"wkv6_bwd_plan: "
                           f"{lib.wkv6_bwd_error_string(err).decode()}")
    return dict(zip(BWD_PLAN_KEYS, out))


def checkpoint_count(s: int) -> int:
    """Checkpoints the forward kernel keeps of an S-step scan: the state
    before steps 0, 16, 32, ... and, when 16 divides S, after the last."""
    return s // CKPT_EVERY + 1


def _check(r, k, v, w, u, state) -> tuple:
    """Device, dtype, shape and contiguity; returns ``(B, S, H, hd)``."""
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
             ("state", state))
    for what, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"wkv6: {what} must be float32, got "
                            f"{t.dtype}")
    dev = r.device
    if dev.type != "cuda" and not traced(r):
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
              w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
              checkpoints: bool = False) -> tuple:
    """Launch the kernel: ``(o, state)``, ``state`` updated in place; with
    ``checkpoints`` also the states the backward kernel starts from,
    ``[B, H, checkpoint_count(S), hd, hd]`` float32."""
    b, s, h, hd = _check(r, k, v, w, u, state)
    o = torch.empty((b, s, h, hd), dtype=torch.float32, device=r.device)
    ckpt = torch.empty((b, h, checkpoint_count(s), hd, hd),
                       dtype=torch.float32, device=r.device) \
        if checkpoints else None
    if trace_only("wkv6", r, k, v, w, u, state, checkpoints=checkpoints):
        return (o, state, ckpt) if checkpoints else (o, state)
    lib = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv6_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                              w.data_ptr(), u.data_ptr(), state.data_ptr(),
                              o.data_ptr(),
                              None if ckpt is None else ckpt.data_ptr(),
                              b, s, h, hd, stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: "
                           f"{lib.wkv6_error_string(err).decode()} "
                           f"(cudaError {err})")
    record_launch("wkv6", r, k, v, w, u, state, checkpoints=checkpoints)
    return (o, state, ckpt) if checkpoints else (o, state)


def wkv6_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, ckpt: torch.Tensor,
                  do: torch.Tensor, dstate: torch.Tensor) -> tuple:
    """Launch the backward kernel: r, k, v, w, u as :func:`wkv6_cuda` took
    them, ``ckpt`` its checkpoints, ``do`` the gradient of ``o`` and
    ``dstate`` that of the final state.  Returns ``(dr, dk, dv, dw, du,
    dstate0)``, dstate0 the initial state's gradient."""
    b, s, h, hd = _check(r, k, v, w, u, dstate)
    for what, t, shape in (("ckpt", ckpt, (b, h, checkpoint_count(s), hd,
                                           hd)),
                           ("do", do, (b, s, h, hd))):
        if t.dtype != torch.float32 or t.device != r.device or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"wkv6_bwd: {what} must be a contiguous float32 "
                             f"{shape} tensor on {r.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not traced(ckpt) and ckpt.data_ptr() % 16:
        raise ValueError("wkv6_bwd: ckpt must be 16-byte aligned")
    dr, dk, dv, dw = (torch.empty_like(t) for t in (r, k, v, w))
    du = torch.empty_like(u)
    dstate0 = torch.empty_like(dstate)
    if trace_only("wkv6_bwd", r, k, v, w, u, ckpt, do, dstate):
        return dr, dk, dv, dw, du, dstate0
    lib = _bwd_lib()
    work = torch.empty(lib.wkv6_bwd_workspace(b, s, h, hd),
                       dtype=torch.uint8, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.wkv6_bwd_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), ckpt.data_ptr(), do.data_ptr(), dstate.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
            du.data_ptr(), dstate0.data_ptr(), work.data_ptr(), b, s, h, hd,
            stream)
    if err != 0:
        raise RuntimeError(f"wkv6_bwd kernel launch failed: "
                           f"{lib.wkv6_bwd_error_string(err).decode()} "
                           f"(cudaError {err})")
    record_launch("wkv6_bwd", r, k, v, w, u, ckpt, do, dstate)
    return dr, dk, dv, dw, du, dstate0


def _cost(r, *rest) -> float:
    """State values updated over the scan, the cost hint."""
    return float(r.numel() * r.shape[-1])


#: float operations a state value and step, counted from the reference's
#: step (an exp as one): k*v, u*kv, +, r*(..), +, state*w, +
OPS_A_STEP = 7
#: the same for the backward, the step recomputed from the checkpoints
#: included: k*v, P*w, + again, then v*G, do*P, G*P, k*G and their four
#: sums, w*G + r*do
BWD_OPS_A_STEP = 14


def wkv6_work(*args, **_static) -> tuple:
    """(flops, bytes) of one forward call: its operands read once and its
    outputs written once (float32; the state both ways), against
    ``OPS_A_STEP`` float operations a state value and step."""
    *ops, state = args
    seq = ops[0]
    per_step = ops[4].shape[-1]
    n_bytes = 4 * (sum(t.numel() for t in ops) + 2 * state.numel()
                   + seq.numel())
    return float(OPS_A_STEP * seq.numel() * per_step), float(n_bytes)


def wkv6_bwd_work(*args, **_static) -> tuple:
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
    name="wkv6",
    cuda_body=wkv6_cuda,
    reference_body=wkv6_ref,
    cost_hint=_cost,
    work=wkv6_work,
))


register_kernel(KernelOp(
    name="wkv6_bwd",
    cuda_body=wkv6_bwd_cuda,
    reference_body=wkv6_bwd_ref,
    cost_hint=_cost,
    work=wkv6_bwd_work,
))


class WKV6(torch.autograd.Function):
    """The recurrence with its backward kernel: ``apply(r, k, v, w, u,
    state, backend)`` -> ``(o, state)``, ``state`` updated in place.  The
    forward keeps r, k, v, w, u and the states the backward starts from:
    the CUDA kernel's checkpoints, or (plain version) the initial state."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, backend):
        backend = resolve_backend(backend, r.device)
        if backend == "cuda":
            o, _, ckpt = dispatch("wkv6", r, k, v, w, u, state,
                                  backend=backend, checkpoints=True)
        else:
            ckpt = state.detach().float().clone()[:, :, None]
            o, _ = dispatch("wkv6", r, k, v, w, u, state, backend=backend)
        ctx.mark_dirty(state)
        ctx.save_for_backward(r, k, v, w, u, ckpt)
        ctx.backend = backend
        return o, state

    @staticmethod
    def backward(ctx, do, dstate):
        r, k, v, w, u, ckpt = ctx.saved_tensors
        grads = dispatch("wkv6_bwd", r, k, v, w, u, ckpt,
                         do.float().contiguous(),
                         dstate.float().contiguous(), backend=ctx.backend)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad)) + (None,)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor, *,
         backend: str | None = None) -> tuple:
    """RWKV-6's WKV recurrence over the S steps of ``r`` from ``state``
    (updated in place); returns ``(o [B, S, H, hd] float32, state)``.
    Differentiable: with grad enabled and an operand that requires it, it
    runs :class:`WKV6`.

    backend: "cuda" (the hand kernel; CUDA tensors), "ref" (plain
    PyTorch, any device), or None = from the operands' device.
    """
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, state)):
        return WKV6.apply(r, k, v, w, u, state, backend)
    return dispatch("wkv6", r, k, v, w, u, state, backend=backend)
