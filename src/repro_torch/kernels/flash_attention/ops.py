"""Model-layout wrapper: flash attention through the port's dispatch.

Counterpart of ``repro.kernels.flash_attention.ops``.  It registers op
``flash_attention_fwd`` with no elastic axes (the model layer hands over
whole sequences; the kernel masks its own ragged edge), whose CUDA body
launches the hand-written kernel ``csrc/flash_attention.cu`` and whose
reference body is the plain PyTorch version of ``ref.py``.
:func:`flash_attention_fused` moves the model's [B, S, Hkv, G, D] layout
to the kernel's [BHG, S, D] batch of heads and back.  Where q.k and v have
head dims the kernel is not built for (MLA: 192 and 128), it zero-pads all
three to the next one it is (256) and cuts the output back to v's: zeros
add nothing to a dot product, so this is exact, and it costs the padded
shape's time (a kernel instantiation for Dk != Dv is later work).

Training: when an operand requires grad, :func:`flash_attention_fused`
goes through :class:`FlashAttention`, an autograd function whose forward
runs op ``flash_attention_fwd`` with the rows' log-sum-exp on (the CUDA
kernel writes it beside ``o``, which it leaves bit for bit as it is) and
whose backward runs op ``flash_attention_bwd``: on CUDA tensors the
hand-written backward kernel ``csrc/flash_attention_bwd.cu`` (wgmma and
TMA; a Delta pass, a dK/dV pass, with GQA a pass summing its per-head
float32 partials in a fixed order, and a dQ pass: deterministic, counted
as one launch; its workspace is allocated here), on the CPU autograd over
the plain forward.  The JAX package has no backward kernel (its training
path is XLA's autodiff of a chunked flash,
``repro.models.attention.attention_train``); without this function the
CUDA forward's output would carry no gradient at all.
Under ``torch.utils.checkpoint`` the forward runs twice and the backward
once a layer.

``flash_attention_fused`` keeps the reference's ``q_chunk`` and
``kv_chunk`` arguments for its callers, and drops them: they sized the
Pallas kernel's VMEM blocks.  The CUDA kernel uses its own tiles (64
query rows by 32 keys, :func:`kernel_tiles`) and the plain version its own
row blocks, which change no result.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ... import benchlib
from .. import _build
from ..dispatch import (KernelOp, dispatch, record_launch, register_kernel,
                        trace_only, traced)
from .ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = ["flash_attention_fused", "flash_attention_ref",
           "flash_attention_cuda", "flash_attention_bwd_cuda",
           "flash_attention_bwd_ref", "FlashAttention", "kernel_tiles",
           "padded_head_dim", "flash_fwd_work", "flash_bwd_work",
           "flash_bound", "flash_bwd_bound", "flash_bwd_floor"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: (q and k, v) dtype pairs the kernel is built for; a bf16 model feeds the
#: last one (RoPE returns float32 q and k)
_DTYPE_PAIRS = ((torch.float32, torch.float32),
                (torch.bfloat16, torch.bfloat16),
                (torch.float32, torch.bfloat16))
_HEAD_DIMS = (16, 32, 64, 128, 256)
#: the kernel's grid puts heads on blockIdx.y
_MAX_HEADS = 65535


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built and loaded on first use."""
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.flash_attention_block_q.restype = ctypes.c_int
    lib.flash_attention_block_k.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    """The backward kernel's library, built and loaded on first use."""
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_attention_bwd_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
    lib.flash_attention_bwd_workspace.argtypes = [ctypes.c_int] * 7
    lib.flash_attention_bwd_workspace.restype = ctypes.c_longlong
    return lib


def kernel_tiles() -> tuple:
    """The CUDA kernel's (query rows, keys) per tile."""
    lib = _lib()
    return lib.flash_attention_block_q(), lib.flash_attention_block_k()


def _check_operands(what: str, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, window: Optional[int],
                    softcap: Optional[float]) -> None:
    """Device, dtypes, shapes, alignment and options both kernels take."""
    dev = q.device
    fake = traced(q, k, v)
    if (dev.type != "cuda" and not fake) or k.device != dev or \
            v.device != dev:
        raise ValueError(
            f"{what}: CUDA tensors on one device expected, got "
            f"{q.device}, {k.device}, {v.device}")
    if k.dtype != q.dtype or (q.dtype, v.dtype) not in _DTYPE_PAIRS:
        raise TypeError(
            f"{what}: q and k of one dtype, (q/k, v) dtypes "
            f"one of {[tuple(map(str, p)) for p in _DTYPE_PAIRS]} expected, "
            f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(
            f"{what}: q [BHG, Sq, D], k and v [BHkv, Skv, D] "
            f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    bhg, sq, d = q.shape
    bhkv, skv, dk = k.shape
    if dk != d or d not in _HEAD_DIMS:
        raise ValueError(
            f"{what}: head dims {d} (q) and {dk} (k, v) must "
            f"agree and be one of {_HEAD_DIMS}")
    if bhkv == 0 or bhg % bhkv or bhg > _MAX_HEADS:
        raise ValueError(
            f"{what}: {bhg} query heads on {bhkv} KV heads "
            f"(a multiple, at most {_MAX_HEADS})")
    if max(sq, skv) >= 2**30:
        raise ValueError(f"{what}: sequence {max(sq, skv)} "
                         f"beyond the kernel's 32-bit positions")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or (not fake and t.data_ptr() % 16):
            raise ValueError(
                f"{what}: {name} must be contiguous and "
                f"16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window {window} < 1")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"{what}: softcap {softcap} <= 0")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         return_lse: bool = False):
    """Launch the CUDA kernel. q: [BHG, Sq, D] (pre-scaled);
    k, v: [BHkv, Skv, D]; q and k of one dtype, (q/k, v) float32 and
    float32, bfloat16 and bfloat16, or float32 and bfloat16; D in
    {16, 32, 64, 128, 256}.  Returns [BHG, Sq, D] in q's dtype, and with
    ``return_lse`` also the rows' log-sum-exp, float32 [BHG, Sq]."""
    _check_operands("flash_attention_cuda", q, k, v, window, softcap)
    dev = q.device
    bhg, sq, d = q.shape
    bhkv, skv, _ = k.shape
    out = torch.empty((bhg, sq, d), dtype=q.dtype, device=dev)
    lse = None
    if return_lse:
        # with no key the kernel only zeroes the output: +inf for every row
        lse = torch.full((bhg, sq), float("inf"), dtype=torch.float32,
                         device=dev) if skv == 0 else torch.empty(
            (bhg, sq), dtype=torch.float32, device=dev)
    static = dict(causal=causal, window=window, softcap=softcap)
    if trace_only("flash_attention_fwd", q, k, v, **static):
        return (out, lse) if return_lse else out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), bhg,
            bhg // bhkv, sq, skv, d, _DTYPES[q.dtype], _DTYPES[v.dtype],
            int(causal),
            -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: "
            f"{lib.flash_attention_error_string(err).decode()} "
            f"(cudaError {err})")
    record_launch("flash_attention_fwd", q, k, v, **static)
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None,
                             softcap: Optional[float] = None) -> tuple:
    """Launch the backward kernel: q, k, v as :func:`flash_attention_cuda`
    takes them, ``o`` its output, ``dout`` the output's gradient (both
    [BHG, Sq, D] in q's dtype) and ``lse`` its rows' log-sum-exp (float32
    [BHG, Sq]).  Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    _check_operands("flash_attention_bwd_cuda", q, k, v, window, softcap)
    bhg, sq, d = q.shape
    bhkv, skv, _ = k.shape
    fake = traced(q, k, v, o, dout, lse)
    for name, t, dtype, shape in (("o", o, q.dtype, q.shape),
                                  ("dout", dout, q.dtype, q.shape),
                                  ("lse", lse, torch.float32, (bhg, sq))):
        if t.device != q.device or t.dtype != dtype or \
                tuple(t.shape) != tuple(shape) or not t.is_contiguous() \
                or (not fake and t.data_ptr() % 16):
            raise ValueError(
                f"flash_attention_bwd_cuda: {name} must be a contiguous, "
                f"16-byte aligned {dtype} {tuple(shape)} tensor on "
                f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if sq == 0 or skv == 0:
        raise ValueError("flash_attention_bwd_cuda: empty sequence")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    static = dict(causal=causal, window=window, softcap=softcap)
    if trace_only("flash_attention_bwd", q, k, v, o, dout, lse, **static):
        return dq, dk, dv
    lib = _bwd_lib()
    # Delta, dO rounded to v's dtype (float32 q with bf16 v) and, with GQA,
    # the float32 partial sums of dK and dV over the query heads
    n_work = lib.flash_attention_bwd_workspace(
        bhg, bhg // bhkv, sq, skv, d, _DTYPES[q.dtype], _DTYPES[v.dtype])
    work = torch.empty(n_work, dtype=torch.uint8, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bhg, bhg // bhkv, sq, skv, d,
            _DTYPES[q.dtype], _DTYPES[v.dtype], int(causal),
            -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap), stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention_bwd kernel launch failed: "
            f"{lib.flash_attention_bwd_error_string(err).decode()} "
            f"(cudaError {err})")
    record_launch("flash_attention_bwd", q, k, v, o, dout, lse, **static)
    return dq, dk, dv


def _pairs(q2, k2, causal: bool, window) -> int:
    """Live (query, key) pairs of a call, over all its query heads."""
    return q2.shape[0] * benchlib.live_pairs(q2.shape[1], k2.shape[1],
                                             causal, window)


def flash_fwd_work(q2, k2, v2, *, causal: bool = True, window=None,
                   **_static) -> tuple:
    """(flops, bytes) of one forward call: 2 * (Dk + Dv) flops a live pair
    (q.k^T and p.v), against q, k, v read and o ([BHG, Sq, Dv], q's type)
    written once."""
    bhg, sq, dk = q2.shape
    dv = v2.shape[2]
    flops = _pairs(q2, k2, causal, window) * 2 * (dk + dv)
    n_bytes = (q2.numel() + k2.numel() + bhg * sq * dv) * \
        q2.element_size() + v2.numel() * v2.element_size()
    return float(flops), float(n_bytes)


def flash_bound(q2, k2, v2, causal: bool, window) -> tuple:
    """Least card time for one forward call -> (ms, "bytes" or
    "operations", flops): :func:`flash_fwd_work`'s bytes at ``HBM_BW``
    against its two products, each at ``benchlib.product_s``'s rate for
    its operands' type (q.k^T in q's and k's, p.v in v's), added."""
    dk, dv = q2.shape[2], v2.shape[2]
    pairs = _pairs(q2, k2, causal, window)
    flops, n_bytes = flash_fwd_work(q2, k2, v2, causal=causal, window=window)
    t_ops = (benchlib.product_s(pairs * 2 * dk, q2.dtype) +
             benchlib.product_s(pairs * 2 * dv, v2.dtype)) * 1e3
    t_bytes = n_bytes / benchlib.HBM_BW * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", int(flops))


def flash_bwd_work(q2, k2, v2, *rest, causal: bool = True, window=None,
                   **_static) -> tuple:
    """(flops, bytes) of one backward call: the five products over the live
    pairs (q.k^T again, dV = p^T dO, dP = dO v^T, dQ = dS k, dK = dS^T q:
    2 * (3 Dk + 2 Dv) flops a pair), against q, k, v, o, dO and lse read
    and dq, dk, dv written once."""
    bhg, sq, dk = q2.shape
    dv = v2.shape[2]
    flops = 2 * _pairs(q2, k2, causal, window) * (3 * dk + 2 * dv)
    n_bytes = 2 * (q2.numel() * q2.element_size()
                   + k2.numel() * k2.element_size()
                   + v2.numel() * v2.element_size()) \
        + 2 * bhg * sq * dv * q2.element_size() + bhg * sq * 4
    return float(flops), float(n_bytes)


def flash_bwd_bound(q2, k2, v2, causal: bool, window) -> tuple:
    """Least card time for one backward call -> (ms, "bytes" or
    "operations", flops): :func:`flash_bwd_work` with all five products at
    the dense bf16 rate."""
    flops, n_bytes = flash_bwd_work(q2, k2, v2, causal=causal,
                                    window=window)
    ms, by = benchlib.bound_ms(n_bytes, flops, benchlib.PEAK_FLOPS)
    return ms, by, int(flops)


def flash_bwd_floor(q2, k2, v2, causal: bool, window) -> tuple:
    """The backward's floor with each product priced in the type it must
    keep (``benchlib.product_s``): q.k^T, dQ = dS k and dK = dS^T q in q's
    and k's type (three TF32 passes for float32), dP = dO v^T and dV = p^T
    dO in v's; and the same with the dQ pass's recomputation of q.k^T and
    dP.  Returns (ms, ms with the recomputation); beside
    :func:`flash_bwd_bound`, which prices all five at the bf16 rate."""
    dk, dv = q2.shape[2], v2.shape[2]
    pairs = _pairs(q2, k2, causal, window)
    qk = benchlib.product_s(pairs * 2 * dk, q2.dtype)
    pv = benchlib.product_s(pairs * 2 * dv, v2.dtype)
    return (3 * qk + 2 * pv) * 1e3, (4 * qk + 3 * pv) * 1e3


register_kernel(KernelOp(
    name="flash_attention_fwd",
    cuda_body=flash_attention_cuda,
    reference_body=flash_attention_ref,
    # no elastic axes: the kernel masks the ragged edge itself
    arg_dims=((), (), ()),
    pad_values=(0, 0, 0),
    out_dims=(),
    bucket_floor=1,
    cost_hint=lambda q2, k2, v2: float(
        q2.shape[0] * q2.shape[1] * k2.shape[1]),
    work=flash_fwd_work,
))


register_kernel(KernelOp(
    name="flash_attention_bwd",
    cuda_body=flash_attention_bwd_cuda,
    reference_body=flash_attention_bwd_ref,
    arg_dims=((),) * 6,
    pad_values=(0,) * 6,
    out_dims=(),
    bucket_floor=1,
    cost_hint=lambda q2, k2, *rest: float(
        q2.shape[0] * q2.shape[1] * k2.shape[1]),
    work=flash_bwd_work,
))


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward kernel, on the kernel's layout:
    ``apply(q2, k2, v2, backend, causal, window, softcap)`` with q2
    [BHG, Sq, D], k2 and v2 [BHkv, Skv, D] as :func:`flash_attention_cuda`
    takes them.  The forward keeps q2, k2, v2, the output and its rows'
    log-sum-exp for the backward."""

    @staticmethod
    def forward(ctx, q2, k2, v2, backend, causal, window, softcap):
        out, lse = dispatch("flash_attention_fwd", q2, k2, v2,
                            backend=backend, causal=causal, window=window,
                            softcap=softcap, return_lse=True)
        ctx.save_for_backward(q2, k2, v2, out, lse)
        ctx.opts = dict(backend=backend, causal=causal, window=window,
                        softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q2, k2, v2, out, lse = ctx.saved_tensors
        dq, dk, dv = dispatch("flash_attention_bwd", q2, k2, v2, out,
                              dout.to(out.dtype).contiguous(), lse,
                              **ctx.opts)
        return dq, dk, dv, None, None, None, None


def padded_head_dim(dk: int, dv: int) -> int:
    """The head dim q, k and v go to the kernel at: their own where they
    agree and the kernel is built for it, else the next dim it is built
    for (MLA's q.k 192 and v 128 -> 256), else unchanged (the CUDA wrapper
    then refuses it; the plain version takes any)."""
    if dk == dv and dk in _HEAD_DIMS:
        return dk
    return next((d for d in _HEAD_DIMS if d >= max(dk, dv)), max(dk, dv))


def flash_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          q_chunk: int = 512, kv_chunk: int = 512,
                          backend: Optional[str] = None) -> torch.Tensor:
    """q: [B, Sq, Hkv, G, Dk] (pre-scaled); k/v: [B, Skv, Hkv, D*].
    Returns [B, Sq, Hkv, G, Dv].  ``backend``: "cuda", "ref", or None =
    from the operands' device.  Head dims the kernel is not built for are
    zero-padded to :func:`padded_head_dim` on either backend (the padding's
    gradient is cut off with the output's columns).  Differentiable: with
    an operand that requires grad it runs :class:`FlashAttention`."""
    del q_chunk, kv_chunk  # no result depends on them (module docstring)
    b, sq, hkv, g, dk = q.shape
    skv = k.shape[1]
    dv = v.shape[-1]
    d = padded_head_dim(dk, dv)
    q2 = q.permute(0, 2, 3, 1, 4).reshape(b * hkv * g, sq, dk)
    k2 = k.permute(0, 2, 1, 3).reshape(b * hkv, skv, dk)
    v2 = v.permute(0, 2, 1, 3).reshape(b * hkv, skv, dv)
    # zero columns add nothing to q.k and give output columns that are cut
    q2, k2, v2 = ((F.pad(t, (0, d - t.shape[-1])) if t.shape[-1] < d
                   else t).contiguous() for t in (q2, k2, v2))
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q2, k2, v2)):
        out = FlashAttention.apply(q2, k2, v2, backend, causal, window,
                                   softcap)
    else:
        out = dispatch("flash_attention_fwd", q2, k2, v2, backend=backend,
                       causal=causal, window=window, softcap=softcap)
    return out[..., :dv].reshape(b, hkv, g, sq, dv).permute(0, 3, 1, 2, 4)
