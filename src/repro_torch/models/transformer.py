"""Model assembly: init, forward, prefill and decode passes (PyTorch).

Counterpart of ``repro.models.transformer`` for blocks with
``mixer="attn"`` and ``ffn="mlp"`` (the dense families: gemma3, glm4).
The reference stacks each stage's per-period parameters on a leading
``n_periods`` axis and scans over it; the port keeps the same names with
that axis turned into a Python list, ``params[f"stage{si}"][period]
[f"block{i}"]``, and runs the layers in a plain loop.  The cache mirrors
it: ``cache[f"stage{si}"][period][f"block{i}"]["mixer"] = {"k", "v"}``.

Inference only: ``forward`` has no remat and no loss.  Prefill attention
runs the hand-written flash kernel on CUDA tensors (``backend="ref"``
forces the plain version, to compare the two on the card).  ``mla``,
``mamba``, ``rwkv6``, ``moe``, modality frontends and ``ShardCtx`` are
not ported yet and raise ``NotImplementedError`` naming ``ROADMAP.md``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from .attention import (attention_decode, attention_prefill,
                        attention_train, init_attention, init_kv_cache)
from .config import BlockSpec, ModelConfig
from .layers import (dense, embed, init_dense, init_embedding, init_mlp,
                     init_rms_norm, mlp_block, rms_norm, unembed)

__all__ = ["ShardCtx", "init_params", "forward", "prefill", "decode_step",
           "init_cache"]

_NOT_PORTED = "not ported to repro_torch yet (ROADMAP.md, queue 1)"


class ShardCtx:
    """Mesh context of the reference; sharding is not ported yet."""

    def __init__(self, *args: Any, **kw: Any) -> None:
        raise NotImplementedError(f"ShardCtx (mesh sharding) is {_NOT_PORTED}")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check(cfg: ModelConfig, ctx: Optional[ShardCtx] = None) -> None:
    if ctx is not None:
        raise NotImplementedError(f"ShardCtx is {_NOT_PORTED}")
    if cfg.frontend is not None:
        raise NotImplementedError(
            f"frontend {cfg.frontend!r} ({cfg.name}) is {_NOT_PORTED}")
    if cfg.mtp_depth:
        raise NotImplementedError(f"the MTP head ({cfg.name}) is {_NOT_PORTED}")
    for stage in cfg.stages:
        for spec in stage.pattern:
            if spec.mixer != "attn":
                raise NotImplementedError(
                    f"mixer {spec.mixer!r} ({cfg.name}) is {_NOT_PORTED}")
            if spec.ffn != "mlp":
                raise NotImplementedError(
                    f"ffn {spec.ffn!r} ({cfg.name}) is {_NOT_PORTED}")


def _blocks(cfg: ModelConfig, tree: dict) -> Iterator[Tuple[BlockSpec, Any]]:
    """(spec, per-layer subtree) for every layer, in execution order."""
    for si, stage in enumerate(cfg.stages):
        for period in tree[f"stage{si}"]:
            for i, spec in enumerate(stage.pattern):
                yield spec, period[f"block{i}"]


def _attn_cfg(cfg: ModelConfig, spec: BlockSpec):
    return spec.attn_override or cfg.attention


# -- init ---------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ModelConfig, spec: BlockSpec,
                device: torch.device) -> dict:
    dt = _dtype(cfg)
    d = cfg.d_model
    return {
        "norm1": init_rms_norm(d, device),
        "mixer": init_attention(gen, d, _attn_cfg(cfg, spec), dt, device),
        "norm2": init_rms_norm(d, device),
        "ffn": init_mlp(gen, d, cfg.d_ff, cfg.act, dt, device),
    }


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: DeviceLike = None) -> dict:
    """Random weights from ``seed``, drawn on the device by a
    ``torch.Generator`` there."""
    _check(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    dt = _dtype(cfg)
    params: Dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dt, device),
        "final_norm": init_rms_norm(cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init_dense(gen, cfg.d_model, cfg.vocab_size, dt,
                                       device)
    for si, stage in enumerate(cfg.stages):
        params[f"stage{si}"] = [
            {f"block{i}": _init_block(gen, cfg, spec, device)
             for i, spec in enumerate(stage.pattern)}
            for _ in range(stage.n_periods)]
    return params


# -- shared pieces ------------------------------------------------------------

def _positions(b: int, s: int, device: torch.device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return dense(params["lm_head"], x)


def _ffn(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    return x + mlp_block(p["ffn"], rms_norm(p["norm2"], x, cfg.norm_eps),
                         cfg.act)


# -- forward ------------------------------------------------------------------

def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            ctx: Optional[ShardCtx] = None):
    """Inference forward -> (logits [B, S, V], aux_loss)."""
    _check(cfg, ctx)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed(params["embed"], tokens)
    positions = _positions(b, s, x.device)
    for spec, p in _blocks(cfg, params):
        h = rms_norm(p["norm1"], x, cfg.norm_eps)
        x = x + attention_train(p["mixer"], h, positions,
                                _attn_cfg(cfg, spec))
        x = _ffn(cfg, p, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(cfg, params, x), aux


# -- cache --------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device: DeviceLike = None) -> dict:
    """Zeroed decode cache, one ``{"mixer": {"k", "v"}}`` per layer."""
    _check(cfg)
    device = resolve_device(device)
    dt = _dtype(cfg)
    return {f"stage{si}": [
        {f"block{i}": {"mixer": init_kv_cache(
            batch, max_seq, _attn_cfg(cfg, spec), dt, device)}
         for i, spec in enumerate(stage.pattern)}
        for _ in range(stage.n_periods)]
        for si, stage in enumerate(cfg.stages)}


# -- prefill ------------------------------------------------------------------

def prefill(cfg: ModelConfig, params: dict, batch: dict, *,
            ctx: Optional[ShardCtx] = None, backend: Optional[str] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Prefill a prompt of length S -> (last-position logits [B, V],
    cache filled for positions [0, S))."""
    _check(cfg, ctx)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed(params["embed"], tokens)
    positions = _positions(b, s, x.device)
    cache: Dict[str, Any] = {}
    for si, stage in enumerate(cfg.stages):
        periods = []
        for period in params[f"stage{si}"]:
            pc = {}
            for i, spec in enumerate(stage.pattern):
                p = period[f"block{i}"]
                h = rms_norm(p["norm1"], x, cfg.norm_eps)
                h, kv = attention_prefill(p["mixer"], h, positions,
                                          _attn_cfg(cfg, spec),
                                          backend=backend)
                x = _ffn(cfg, p, x + h)
                pc[f"block{i}"] = {"mixer": kv}
            periods.append(pc)
        cache[f"stage{si}"] = periods
    logits = _head(cfg, params, x[:, -1:])
    return logits[:, 0], cache


# -- decode -------------------------------------------------------------------

def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict,
                pos: torch.Tensor, *, ctx: Optional[ShardCtx] = None
                ) -> Tuple[torch.Tensor, dict]:
    """One-token decode: batch {tokens [B, 1]}, pos [B].  Writes the new
    K and V into ``cache`` in place; returns (logits [B, V], cache)."""
    _check(cfg, ctx)
    x = embed(params["embed"], batch["tokens"])
    for (spec, p), (_, c) in zip(_blocks(cfg, params), _blocks(cfg, cache)):
        h = rms_norm(p["norm1"], x, cfg.norm_eps)
        h, _ = attention_decode(p["mixer"], c["mixer"], h, pos,
                                _attn_cfg(cfg, spec))
        x = _ffn(cfg, p, x + h)
    logits = _head(cfg, params, x)
    return logits[:, 0], cache
