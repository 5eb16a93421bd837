"""Shape stand-ins for every model input (counterpart of
``repro.launch.specs``).

The reference returns ``jax.ShapeDtypeStruct``s; the port returns tensors
on the ``meta`` device, which carry a shape and a dtype and no storage.
``abstract_params`` runs ``init_params`` on ``meta``, where no generator
draws and nothing is allocated (deepseek-v3-671b's tree takes no memory);
its leaves are in the port's layout (a list of periods under each stage).
Modality-stub archs (musicgen, llava) get precomputed frame or patch
embeddings [B, S, d] instead of token ids.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.shapes import ShapeSpec
from ..models import ModelConfig, init_cache, init_params

__all__ = ["input_specs", "abstract_params", "abstract_cache",
           "abstract_opt_state"]

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _tokens_or_embeds(cfg: ModelConfig, b: int, s: int) -> Dict[str, Any]:
    if cfg.frontend is not None:
        return {"embeds": _sds((b, s, cfg.d_model), torch.bfloat16)}
    return {"tokens": _sds((b, s), torch.int32)}


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Model inputs for one (arch x shape) cell as meta tensors."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = _tokens_or_embeds(cfg, b, s)
        batch["labels"] = _sds((b, s), torch.int32)
        return {"batch": batch}
    if shape.kind == "prefill":
        return {"batch": _tokens_or_embeds(cfg, b, s)}
    if shape.kind == "decode":
        return {"batch": _tokens_or_embeds(cfg, b, 1),
                "pos": _sds((b,), torch.int32)}
    raise ValueError(shape.kind)


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as meta tensors (no allocation)."""
    return init_params(cfg, 0, device=META)


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int) -> dict:
    return init_cache(cfg, batch, max_seq, device=META)


def abstract_opt_state(param_shapes: Any, opt_cfg) -> dict:
    from ..optim import init_opt_state
    return init_opt_state(param_shapes, opt_cfg)
