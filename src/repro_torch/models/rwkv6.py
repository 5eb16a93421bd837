"""RWKV-6 "Finch" mixer (arXiv:2404.05892), PyTorch.

Counterpart of ``repro.models.rwkv6`` with the same names and parameter
tree.  Time mix: a per-head state S of [hd, hd] with data-dependent decay
w_t,

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

then a per-head norm, the output gate and projection.  Channel mix: the
squared-ReLU RWKV FFN.  Both mix each projection's input between x_t and
x_{t-1} (token shift).  The caches are ``{"state": [B, H, hd, hd] float32,
"x_prev": [B, D]}`` (time mix) and ``{"x_prev": [B, D]}`` (channel mix).

* The recurrence (the reference's ``lax.scan`` of ``step``) is
  :func:`~repro_torch.kernels.wkv6.ops.wkv6`: on CUDA tensors the
  hand-written kernel (``kernels/csrc/wkv6.cu``), one launch a layer for
  the whole prompt and one a decode step; on the CPU, or with
  ``backend="ref"``, the plain version.  In training
  (:func:`rwkv_tmix_train` under autograd) it runs the ``WKV6`` autograd
  function, whose backward is the hand-written kernel
  ``kernels/csrc/wkv6_bwd.cu`` on CUDA tensors.
* The per-head norm takes the population variance, as ``jnp.var`` does
  (``torch.var`` defaults to the unbiased one): ``correction=0``.
* The decode functions update their cache **in place** (the kernel
  writes the state back, ``x_prev`` is copied over); the reference
  returns a new cache with the same values.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.wkv6.ops import wkv6
from .layers import dense, init_dense

__all__ = ["init_rwkv_tmix", "rwkv_tmix_train", "rwkv_tmix_prefill",
           "rwkv_tmix_decode", "init_rwkv_cmix", "rwkv_cmix_train",
           "rwkv_cmix_prefill", "rwkv_cmix_decode",
           "init_rwkv_tmix_cache", "init_rwkv_cmix_cache"]

LORA_R = 64


def init_rwkv_tmix(gen: torch.Generator, d: int, head_size: int,
                   dtype: torch.dtype, device: torch.device) -> dict:
    h = d // head_size
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wr": init_dense(gen, d, d, dtype, device),
        "wk": init_dense(gen, d, d, dtype, device),
        "wv": init_dense(gen, d, d, dtype, device),
        "wg": init_dense(gen, d, d, dtype, device),
        "wo": init_dense(gen, d, d, dtype, device),
        # token-shift mix coefficients per projection (r, k, v, g, w)
        "mix": torch.rand((5, d), generator=gen, **f32).to(dtype),
        # data-dependent decay LoRA: d -> R -> d
        "w_lora_a": init_dense(gen, d, LORA_R, dtype, device),
        "w_lora_b": init_dense(gen, LORA_R, d, dtype, device),
        "w_bias": torch.full((d,), -6.0, **f32),
        # per-head bonus u
        "u": torch.randn((h, head_size), generator=gen, **f32) * 0.1,
        "ln_out": {"scale": torch.ones((d,), **f32)},
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x: [B, S, D] -> x shifted right by one; position 0 gets ``prev``."""
    return torch.cat([prev[:, None, :], x[:, :-1]], dim=1)


def _tmix_inputs(params: dict, x: torch.Tensor, x_prev: torch.Tensor):
    xs = _token_shift(x, x_prev)
    mix = params["mix"]
    r_in, k_in, v_in, g_in, w_in = (x + (xs - x) * mix[i] for i in range(5))
    r = dense(params["wr"], r_in)
    k = dense(params["wk"], k_in)
    v = dense(params["wv"], v_in)
    g = F.silu(dense(params["wg"], g_in))
    w_raw = dense(params["w_lora_b"],
                  torch.tanh(dense(params["w_lora_a"], w_in)))
    # decay in (0, 1): exp(-exp(..)), data-dependent (Finch), in float32
    w = torch.exp(-torch.exp(w_raw.float() + params["w_bias"]))
    return r, k, v, g, w


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    """[B, S, D] -> float32 [B, S, H, hd], contiguous."""
    b, s, d = x.shape
    return x.float().reshape(b, s, h, d // h).contiguous()


def _mix_out(params: dict, o: torch.Tensor, g: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """Per-head norm of o [B, S, H, hd] (the reference's stand-in for
    RWKV's GroupNorm), scale, gate and output projection."""
    b, s, h, hd = o.shape
    mu = o.mean(-1, keepdim=True)
    var = o.var(-1, keepdim=True, correction=0)
    o = ((o - mu) * torch.rsqrt(var + 64e-5)).reshape(b, s, h * hd)
    o = o * params["ln_out"]["scale"]
    return dense(params["wo"], o.to(dtype) * g)


def _tmix_full(params: dict, x: torch.Tensor, head_size: int,
               state: torch.Tensor, x_prev: torch.Tensor,
               backend: Optional[str] = None):
    """-> (y [B, S, D], state after the last step); ``state`` is updated
    in place."""
    h = x.shape[-1] // head_size
    r, k, v, g, w = _tmix_inputs(params, x, x_prev)
    o, state = wkv6(_heads(r, h), _heads(k, h), _heads(v, h), _heads(w, h),
                    params["u"], state, backend=backend)
    return _mix_out(params, o, g, x.dtype), state


def _zero_state(b: int, d: int, head_size: int,
                device: torch.device) -> torch.Tensor:
    return torch.zeros((b, d // head_size, head_size, head_size),
                       dtype=torch.float32, device=device)


def rwkv_tmix_train(params: dict, x: torch.Tensor, head_size: int, *,
                    backend: Optional[str] = None) -> torch.Tensor:
    b, _, d = x.shape
    return _tmix_full(params, x, head_size,
                      _zero_state(b, d, head_size, x.device),
                      x.new_zeros((b, d)), backend)[0]


def rwkv_tmix_prefill(params: dict, x: torch.Tensor, head_size: int, *,
                      backend: Optional[str] = None
                      ) -> Tuple[torch.Tensor, dict]:
    """Full pass returning the carried (state, last input) cache slice."""
    b, _, d = x.shape
    y, state = _tmix_full(params, x, head_size,
                          _zero_state(b, d, head_size, x.device),
                          x.new_zeros((b, d)), backend)
    return y, {"state": state, "x_prev": x[:, -1].clone()}


def init_rwkv_cmix(gen: torch.Generator, d: int, d_ff: int,
                   dtype: torch.dtype, device: torch.device) -> dict:
    return {
        "wk": init_dense(gen, d, d_ff, dtype, device),
        "wv": init_dense(gen, d_ff, d, dtype, device),
        "wr": init_dense(gen, d, d, dtype, device),
        "mix": torch.rand((2, d), generator=gen, dtype=torch.float32,
                          device=device).to(dtype),
    }


def _cmix(params: dict, x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    mix = params["mix"]
    k_in = x + (xs - x) * mix[0]
    r_in = x + (xs - x) * mix[1]
    k = torch.square(torch.relu(dense(params["wk"], k_in)))
    kv = dense(params["wv"], k)
    return torch.sigmoid(dense(params["wr"], r_in)) * kv


def rwkv_cmix_train(params: dict, x: torch.Tensor) -> torch.Tensor:
    b, _, d = x.shape
    return _cmix(params, x, _token_shift(x, x.new_zeros((b, d))))


# -- decode-time (single step, carried state) ---------------------------------

def init_rwkv_tmix_cache(batch: int, d: int, head_size: int,
                         dtype: torch.dtype, device: torch.device) -> dict:
    return {
        "state": _zero_state(batch, d, head_size, device),
        "x_prev": torch.zeros((batch, d), dtype=dtype, device=device),
    }


def init_rwkv_cmix_cache(batch: int, d: int, dtype: torch.dtype,
                         device: torch.device) -> dict:
    return {"x_prev": torch.zeros((batch, d), dtype=dtype, device=device)}


def rwkv_tmix_decode(params: dict, cache: dict, x: torch.Tensor,
                     head_size: int, *, backend: Optional[str] = None
                     ) -> Tuple[torch.Tensor, dict]:
    """x: [B, 1, D] -> ([B, 1, D], cache), the cache updated in place."""
    y, _ = _tmix_full(params, x, head_size, cache["state"],
                      cache["x_prev"].to(x.dtype), backend)
    cache["x_prev"].copy_(x[:, 0])
    return y, cache


def rwkv_cmix_prefill(params: dict, x: torch.Tensor
                      ) -> Tuple[torch.Tensor, dict]:
    return rwkv_cmix_train(params, x), {"x_prev": x[:, -1].clone()}


def rwkv_cmix_decode(params: dict, cache: dict, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, dict]:
    """x: [B, 1, D] -> ([B, 1, D], cache), the cache updated in place."""
    y = _cmix(params, x, cache["x_prev"].to(x.dtype)[:, None, :])
    cache["x_prev"].copy_(x[:, 0])
    return y, cache
