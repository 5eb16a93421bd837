"""Shared model layers: norms, RoPE, MLPs, embeddings (PyTorch).

Counterpart of ``repro.models.layers`` with the same names and parameter
layouts (``{"w": [d_in, d_out]}``, ``{"table": [vocab, d]}``,
``{"scale": [d]}``).  Three places where a literal port would go wrong:

* ``jax.nn.gelu`` is the tanh approximation by default, so the MLP uses
  ``F.gelu(..., approximate="tanh")``;
* RoPE rotates *interleaved* pairs ``(x[0::2], x[1::2])`` of the first
  ``rotary_dim`` dims (GPT-NeoX/GLM style), not the half-split rotation;
* ``rms_norm`` takes its statistics and scales in float32 and casts back;
* in a bf16 model RoPE returns float32 q and k, as the reference's does
  (its float32 cos/sin tables promote them); attention then scores them in
  float32 against bf16 v.

Init draws from an explicit ``torch.Generator``; the numbers differ from
``jax.random``'s, so the tests hand both packages the same weights
through ``repro_torch.convert.params_from_jax``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "rms_norm", "init_rms_norm", "rope_freqs", "apply_rope",
    "init_dense", "dense", "init_mlp", "mlp_block",
    "init_embedding", "embed", "unembed",
]


def init_rms_norm(d: int, device: torch.device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with float32 statistics, scaled in float32, cast back."""
    xf = x.float()
    var = (xf * xf).sum(-1, keepdim=True) / x.shape[-1]
    return (xf * torch.rsqrt(var + eps) * params["scale"]).to(x.dtype)


# -- rotary embeddings --------------------------------------------------------

def rope_freqs(positions: torch.Tensor, rotary_dim: int,
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables [*, rotary_dim/2] for integer positions."""
    half = rotary_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freq = 1.0 / torch.pow(theta, exps)
    angles = positions.float()[..., None] * freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rotary_dim: Optional[int] = None) -> torch.Tensor:
    """Rotate the first ``rotary_dim`` dims of the trailing head axis.

    x: [..., S, H, D]; cos/sin: [..., S, rotary_dim/2] (broadcast over H).
    Pairing is (x[0::2], x[1::2]) — interleaved, GPT-NeoX/GLM style.
    """
    d = x.shape[-1]
    rd = rotary_dim or d
    xr, xp = x[..., :rd], x[..., rd:]
    x1 = xr[..., 0::2]
    x2 = xr[..., 1::2]
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    y1 = x1 * c - x2 * s
    y2 = x1 * s + x2 * c
    # float32 tables promote bf16 activations to float32, as in the reference
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr, xp.to(yr.dtype)], dim=-1) if rd < d else yr


# -- dense / MLP --------------------------------------------------------------

def init_dense(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, device: torch.device) -> dict:
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device) * (1.0 / d_in ** 0.5)
    return {"w": w.to(dtype)}


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"]


def init_mlp(gen: torch.Generator, d: int, d_ff: int, act: str,
             dtype: torch.dtype, device: torch.device) -> dict:
    p = {
        "up": init_dense(gen, d, d_ff, dtype, device),
        "down": init_dense(gen, d_ff, d, dtype, device),
    }
    if act == "silu":  # gated (SwiGLU-style)
        p["gate"] = init_dense(gen, d, d_ff, dtype, device)
    return p


def mlp_block(params: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        h = F.silu(dense(params["gate"], x)) * dense(params["up"], x)
    else:
        h = F.gelu(dense(params["up"], x), approximate="tanh")
    return dense(params["down"], h)


# -- embeddings ---------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype: torch.dtype, device: torch.device) -> dict:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device) * 0.02
    return {"table": w.to(dtype)}


def embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits via the (possibly tied) output table: [.., d] -> [.., V]."""
    return x @ params["table"].T
