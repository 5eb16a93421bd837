"""Int8 gradient compression with error feedback (PyTorch).

Counterpart of ``repro.optim.compression``: int8 values with a per-tensor
float32 scale (max |x| / 127), and an error-feedback residual that carries
the quantization error to the next step.  ``torch.round`` rounds half to
even, as ``jnp.round`` does, so the int8 values are the reference's.  The
reference applies it before a cross-pod all-reduce; the port's training
step runs on one device and does not call it (multi-device training is
ROADMAP.md's queue 4).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from .adamw import tree_map

__all__ = ["compress", "decompress", "ef_roundtrip", "init_ef"]


def compress(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32/bf16 -> (int8 values, float32 scale)."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def init_ef(params: Any) -> Any:
    """Per-leaf error-feedback residual buffers (float32)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def ef_roundtrip(grads: Any, ef: Any) -> Tuple[Any, Any]:
    """Quantize (g + ef) leafwise; return (dequantized grads, new ef)."""
    def one(g, e):
        tot = g.float() + e
        q, s = compress(tot)
        deq = decompress(q, s)
        return deq.to(g.dtype), tot - deq
    done = []
    deq = tree_map(lambda g, e: done.append(one(g, e)) or done[-1][0],
                   grads, ef)
    residuals = iter(done)
    return deq, tree_map(lambda g: next(residuals)[1], grads)
