"""Mamba (S6) mixer for the Jamba hybrid (arXiv:2403.19887), PyTorch.

Counterpart of ``repro.models.mamba`` with the same names and parameter
tree: in_proj -> causal depthwise conv -> data-dependent (dt, B, C) ->
diagonal SSM recurrence -> gated out_proj.  The cache is ``{"conv":
[B, d_conv - 1, Di], "ssm": [B, Di, N] float32}``.

* The recurrence (the reference's ``lax.scan`` of ``_ssm_step``) is
  :func:`~repro_torch.kernels.selective_scan.ops.selective_scan`: on CUDA
  tensors the hand-written kernel (``kernels/csrc/selective_scan.cu``),
  one launch a layer for the whole prompt and one a decode step; on the
  CPU, or with ``backend="ref"``, the plain version.  In training
  (:func:`mamba_train` under autograd) it runs the ``SelectiveScan``
  autograd function, whose backward is the hand-written kernel
  ``kernels/csrc/selective_scan_bwd.cu`` on CUDA tensors.  Neither builds the
  reference's ``x * B`` for all steps (``[B, S, Di, N]``): both form it
  one step at a time, the same products.
* The prefill convolution is the reference's sum of shifted products in
  the model dtype, in its order (bf16 arithmetic in a bf16 model); the
  decode convolution is float32, as in the reference.
* ``softplus`` is the reference's ``logaddexp(x, 0)``, without torch's
  switch to the identity above 20.
* :func:`mamba_decode` updates the cache **in place** (the kernel writes
  the state back; the conv window is shifted by a copy); the reference
  returns a new cache with the same values.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.selective_scan.ops import selective_scan
from .config import MambaConfig
from .layers import dense, init_dense

__all__ = ["init_mamba", "mamba_train", "mamba_prefill", "mamba_decode",
           "init_mamba_cache"]


def _dims(d_model: int, cfg: MambaConfig) -> Tuple[int, int]:
    d_inner = cfg.expand * d_model
    dt_rank = cfg.dt_rank or -(-d_model // 16)
    return d_inner, dt_rank


def init_mamba(gen: torch.Generator, d_model: int, cfg: MambaConfig,
               dtype: torch.dtype, device: torch.device) -> dict:
    d_inner, dt_rank = _dims(d_model, cfg)
    f32 = dict(dtype=torch.float32, device=device)
    # S4D-real initialization for A
    a = torch.arange(1, cfg.d_state + 1, **f32).repeat(d_inner, 1)
    return {
        "in_proj": init_dense(gen, d_model, 2 * d_inner, dtype, device),
        "conv_w": (torch.randn((cfg.d_conv, d_inner), generator=gen, **f32)
                   * 0.1).to(dtype),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "x_proj": init_dense(gen, d_inner, dt_rank + 2 * cfg.d_state, dtype,
                             device),
        "dt_proj": init_dense(gen, dt_rank, d_inner, dtype, device),
        "dt_bias": torch.zeros((d_inner,), **f32),
        "A_log": torch.log(a),                     # [d_inner, d_state] f32
        "D": torch.ones((d_inner,), **f32),
        "out_proj": init_dense(gen, d_inner, d_model, dtype, device),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no linear cut-over."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_inputs(params: dict, xi: torch.Tensor, cfg: MambaConfig,
                dt_rank: int) -> Tuple[torch.Tensor, ...]:
    """(dt, B, C) float32 from the conv output ``xi`` (model dtype), and
    the decay rates A."""
    proj = dense(params["x_proj"], xi)             # [.., R + 2N]
    dt_in = proj[..., :dt_rank]
    bmat = proj[..., dt_rank:dt_rank + cfg.d_state]
    cmat = proj[..., dt_rank + cfg.d_state:]
    dt = _softplus(dense(params["dt_proj"], dt_in).float()
                   + params["dt_bias"])
    a = -torch.exp(params["A_log"])                # [Di, N]
    return dt, bmat.float(), cmat.float(), a


def _mamba_full(params: dict, x: torch.Tensor, cfg: MambaConfig,
                backend: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (y [B, S, D], final ssm state, raw conv inputs xi_pre [B, S, Di])."""
    b, s, d = x.shape
    d_inner, dt_rank = _dims(d, cfg)
    xz = dense(params["in_proj"], x)               # [B, S, 2 * Di]
    xi_pre, z = torch.chunk(xz, 2, dim=-1)

    # causal depthwise conv over time, in the model dtype and the
    # reference's order of sums
    pad = xi_pre.new_zeros((b, cfg.d_conv - 1, d_inner))
    xp = torch.cat([pad, xi_pre], dim=1)
    xi = sum(xp[:, i:i + s] * params["conv_w"][i]
             for i in range(cfg.d_conv)) + params["conv_b"]
    xi = F.silu(xi)

    dt, bmat, cmat, a = _ssm_inputs(params, xi, cfg, dt_rank)
    state = torch.zeros((b, d_inner, cfg.d_state), dtype=torch.float32,
                        device=x.device)
    xf = xi.float()
    y, state = selective_scan(xf.contiguous(), dt.contiguous(),
                              bmat.contiguous(), cmat.contiguous(), a, state,
                              backend=backend)
    y = y + xf * params["D"]
    y = (y * F.silu(z.float())).to(x.dtype)
    return dense(params["out_proj"], y), state, xi_pre


def mamba_train(params: dict, x: torch.Tensor, cfg: MambaConfig, *,
                backend: Optional[str] = None) -> torch.Tensor:
    """x: [B, S, D] -> [B, S, D] (causal)."""
    return _mamba_full(params, x, cfg, backend)[0]


def mamba_prefill(params: dict, x: torch.Tensor, cfg: MambaConfig, *,
                  backend: Optional[str] = None) -> Tuple[torch.Tensor, dict]:
    """Full pass + carried cache (conv window of raw inputs, ssm state)."""
    y, state, xi_pre = _mamba_full(params, x, cfg, backend)
    # a copy: a view would keep the whole [B, S, 2 * Di] projection alive
    conv = xi_pre[:, -(cfg.d_conv - 1):, :].clone()
    return y, {"conv": conv, "ssm": state}


def init_mamba_cache(batch: int, d_model: int, cfg: MambaConfig,
                     dtype: torch.dtype, device: torch.device) -> dict:
    d_inner, _ = _dims(d_model, cfg)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, d_inner), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, d_inner, cfg.d_state),
                           dtype=torch.float32, device=device),
    }


def mamba_decode(params: dict, cache: dict, x: torch.Tensor,
                 cfg: MambaConfig, *, backend: Optional[str] = None
                 ) -> Tuple[torch.Tensor, dict]:
    """One step: x [B, 1, D] -> ([B, 1, D], cache), the cache updated in
    place."""
    b, _, d = x.shape
    d_inner, dt_rank = _dims(d, cfg)
    xz = dense(params["in_proj"], x[:, 0])         # [B, 2 * Di]
    xi, z = torch.chunk(xz, 2, dim=-1)

    window = torch.cat([cache["conv"], xi[:, None, :]], dim=1)
    conv_out = torch.einsum("bkd,kd->bd", window.float(),
                            params["conv_w"].float())
    xi_c = F.silu(conv_out + params["conv_b"].float())

    dt, bmat, cmat, a = _ssm_inputs(params, xi_c.to(x.dtype), cfg, dt_rank)
    y, _ = selective_scan(xi_c[:, None, :].contiguous(),
                          dt[:, None, :].contiguous(),
                          bmat[:, None, :].contiguous(),
                          cmat[:, None, :].contiguous(), a, cache["ssm"],
                          backend=backend)
    y = y[:, 0] + xi_c * params["D"]
    y = (y * F.silu(z.float())).to(x.dtype)
    out = dense(params["out_proj"], y[:, None, :])
    cache["conv"].copy_(window[:, 1:])
    return out, cache
