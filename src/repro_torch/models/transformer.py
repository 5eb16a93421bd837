"""Model assembly: init, forward, prefill and decode passes (PyTorch).

Counterpart of ``repro.models.transformer`` for every block of the
reference: ``mixer`` in ``{"attn", "mla", "mamba", "rwkv6", "none"}`` and
``ffn`` in ``{"mlp", "moe", "rwkv6_cmix", "none"}`` (the dense families,
deepseek-moe, deepseek-v3, rwkv6 and the jamba hybrid), and for the
modality frontend stubs: with ``cfg.frontend`` set, every pass takes
precomputed ``batch["embeds"]`` [B, S, D] (cast to the model dtype)
instead of ``batch["tokens"]``.  The
reference stacks each stage's per-period parameters on a leading
``n_periods`` axis and scans over it; the port keeps the same names with
that axis turned into a Python list, ``params[f"stage{si}"][period]
[f"block{i}"]``, and runs the layers in a plain loop.  The cache mirrors
it: ``cache[f"stage{si}"][period][f"block{i}"]["mixer"]`` is ``{"k", "v"}``
for attention, ``{"c_kv", "k_pe"}`` for MLA, ``{"conv", "ssm"}`` for Mamba
and ``{"state", "x_prev"}`` for RWKV-6's time mix, whose channel mix
carries ``["ffn"] = {"x_prev"}``.  The recurrent caches hold no sequence
axis: decode updates them in place, every step, for every slot.

Training and inference.  ``forward`` is the reference's training forward
(``remat`` and ``return_hidden`` included) and ``loss_fn`` its loss: the
float32 cross-entropy ``_xent`` over the whole vocabulary (no chunking, as
in the reference), plus the MoE router's aux loss weighted by
``router_aux_weight``, plus 0.3 x the MTP head's next-next-token loss where
``cfg.mtp_depth`` builds one.  Remat wraps each period (all blocks of one
period, as the reference's ``_wrap_remat`` wraps its scan body) in
``torch.utils.checkpoint(..., use_reentrant=False)``: ``"full"`` keeps only
the period's input, ``"dots"`` also the outputs of the dense products
without batch dims (``aten.mm``, ``aten.addmm``: the counterpart of
``checkpoint_dots_with_no_batch_dims``), ``"none"`` wraps nothing.  Remat
applies only while grad is enabled.  Attention (and MLA's expanded form)
runs the hand-written flash kernels on CUDA tensors, forward and, under
autograd, backward; Mamba's recurrence runs the selective-scan kernel and
RWKV-6's the WKV kernel, forward and, under autograd, backward (the
``SelectiveScan`` and ``WKV6`` autograd functions: a forward kernel that
keeps state checkpoints, a backward kernel that recomputes from them; on
the CPU autograd over the plain scans).  Under remat each scan's forward
runs twice and its backward once a layer.  ``backend="ref"`` forces the
plain versions, to compare the two on the card.  A MoE block
runs ``moe_block_local`` on one device plus the shared experts, as the
reference does without a ``ShardCtx``; its aux loss is summed over the
layers in ``forward``.  With ``cfg.mtp_depth`` ``init_params`` builds the
reference's ``params["mtp"]`` head; only the training loss reads it, so
serving carries it and never runs it.  ``ShardCtx`` and the MoE mesh path
are not ported yet and raise ``NotImplementedError`` naming
``ROADMAP.md``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.utils.checkpoint as torch_checkpoint

from ..device import DeviceLike, resolve_device
from .attention import (attention_decode, attention_prefill,
                        attention_train, init_attention, init_kv_cache)
from .config import BlockSpec, ModelConfig
from .layers import (dense, embed, init_dense, init_embedding, init_mlp,
                     init_rms_norm, mlp_block, rms_norm, unembed)
from .mamba import (init_mamba, init_mamba_cache, mamba_decode,
                    mamba_prefill, mamba_train)
from .mla import init_mla, init_mla_cache, mla_decode, mla_prefill, mla_train
from .moe import init_moe, moe_block_local, shared_expert_mlp
from .rwkv6 import (init_rwkv_cmix, init_rwkv_cmix_cache, init_rwkv_tmix,
                    init_rwkv_tmix_cache, rwkv_cmix_decode,
                    rwkv_cmix_prefill, rwkv_cmix_train, rwkv_tmix_decode,
                    rwkv_tmix_prefill, rwkv_tmix_train)

__all__ = ["ShardCtx", "init_params", "forward", "prefill", "decode_step",
           "init_cache", "loss_fn"]

_NOT_PORTED = "not ported to repro_torch yet (ROADMAP.md, queue 1)"
_MIXERS = ("attn", "mla", "mamba", "rwkv6", "none")
_FFNS = ("mlp", "moe", "rwkv6_cmix", "none")


class ShardCtx:
    """Mesh context of the reference; sharding is not ported yet."""

    def __init__(self, *args: Any, **kw: Any) -> None:
        raise NotImplementedError(f"ShardCtx (mesh sharding) is {_NOT_PORTED}")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check(cfg: ModelConfig, ctx: Optional[ShardCtx] = None) -> None:
    if ctx is not None:
        raise NotImplementedError(f"ShardCtx is {_NOT_PORTED}")
    for stage in cfg.stages:
        for spec in stage.pattern:
            if spec.mixer not in _MIXERS:
                raise NotImplementedError(
                    f"mixer {spec.mixer!r} ({cfg.name}) is {_NOT_PORTED}")
            if spec.ffn not in _FFNS:
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
    p: Dict[str, Any] = {}
    if spec.mixer != "none":
        p["norm1"] = init_rms_norm(d, device)
    if spec.mixer == "attn":
        p["mixer"] = init_attention(gen, d, _attn_cfg(cfg, spec), dt, device)
    elif spec.mixer == "mla":
        p["mixer"] = init_mla(gen, d, cfg.mla, dt, device)
    elif spec.mixer == "mamba":
        p["mixer"] = init_mamba(gen, d, cfg.mamba, dt, device)
    elif spec.mixer == "rwkv6":
        p["mixer"] = init_rwkv_tmix(gen, d, cfg.rwkv_head_size, dt, device)
    if spec.ffn != "none":
        p["norm2"] = init_rms_norm(d, device)
    if spec.ffn == "mlp":
        p["ffn"] = init_mlp(gen, d, cfg.d_ff, cfg.act, dt, device)
    elif spec.ffn == "moe":
        p["ffn"] = init_moe(gen, d, cfg.moe, dt, device)
    elif spec.ffn == "rwkv6_cmix":
        p["ffn"] = init_rwkv_cmix(gen, d, cfg.d_ff, dt, device)
    return p


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: DeviceLike = None) -> dict:
    """Random weights from ``seed``, drawn on the device by a
    ``torch.Generator`` there, leaf by leaf in float32 and then cast."""
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
    if cfg.mtp_depth:
        # DeepSeek-V3 MTP: a block predicting token t+2 from (h_t,
        # embed(token_{t+1})); read by the training loss only
        mtp_spec = BlockSpec(mixer="mla" if cfg.mla else "attn", ffn="mlp")
        params["mtp"] = {
            "combine": init_dense(gen, 2 * cfg.d_model, cfg.d_model, dt,
                                  device),
            "block": _init_block(gen, cfg, mtp_spec, device),
        }
    return params


# -- shared pieces ------------------------------------------------------------

def _inputs(cfg: ModelConfig, params: dict, batch: dict) -> torch.Tensor:
    """[B, S, D] block input: token embeddings, or a frontend stub's
    precomputed ``embeds`` cast to the model dtype."""
    if cfg.frontend is not None:
        return batch["embeds"].to(_dtype(cfg))
    return embed(params["embed"], batch["tokens"])


def _positions(b: int, s: int, device: torch.device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x)
    return dense(params["lm_head"], x)


def _apply_moe(cfg: ModelConfig, p: dict, h: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_apply_moe`` without a ``ShardCtx``: the local
    block over all B * S tokens, plus the shared experts."""
    b, s, d = h.shape
    out, aux, _ = moe_block_local(p, h.reshape(b * s, d), cfg.moe,
                                  n_shards=1, shard_ix=0, tp_axis=None,
                                  act=cfg.act)
    out = out.reshape(b, s, d)
    if cfg.moe.n_shared:
        out = out + shared_expert_mlp(p["shared"], h)
    return out, aux


def _ffn(cfg: ModelConfig, spec: BlockSpec, p: dict, x: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """-> (x after the FFN half of the block, the MoE aux loss or None)."""
    if spec.ffn == "none":
        return x, None
    h = rms_norm(p["norm2"], x, cfg.norm_eps)
    if spec.ffn == "mlp":
        return x + mlp_block(p["ffn"], h, cfg.act), None
    if spec.ffn == "rwkv6_cmix":
        return x + rwkv_cmix_train(p["ffn"], h), None
    h, aux = _apply_moe(cfg, p["ffn"], h)
    return x + h, aux


# -- forward ------------------------------------------------------------------

def _block(cfg: ModelConfig, spec: BlockSpec, p: dict, x: torch.Tensor,
           positions: torch.Tensor, backend: Optional[str]
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block of the training forward -> (x, MoE aux loss or None)."""
    if spec.mixer != "none":
        h = rms_norm(p["norm1"], x, cfg.norm_eps)
        if spec.mixer == "attn":
            h = attention_train(p["mixer"], h, positions,
                                _attn_cfg(cfg, spec), backend=backend)
        elif spec.mixer == "mla":
            h = mla_train(p["mixer"], h, positions, cfg.mla,
                          eps=cfg.norm_eps, backend=backend)
        elif spec.mixer == "mamba":
            h = mamba_train(p["mixer"], h, cfg.mamba, backend=backend)
        else:
            h = rwkv_tmix_train(p["mixer"], h, cfg.rwkv_head_size,
                                backend=backend)
        x = x + h
    return _ffn(cfg, spec, p, x)


#: the products whose outputs ``remat="dots"`` keeps: dense layers
#: (no batch dims), as ``checkpoint_dots_with_no_batch_dims`` does
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kw):
    return (torch_checkpoint.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def _wrap_remat(body, remat: str):
    """The reference's ``_wrap_remat`` for one period's body."""
    if remat == "none" or not torch.is_grad_enabled():
        return body
    if remat == "full":
        return functools.partial(torch_checkpoint.checkpoint, body,
                                 use_reentrant=False)
    return functools.partial(      # "dots"
        torch_checkpoint.checkpoint, body, use_reentrant=False,
        context_fn=functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _dots_policy))


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            ctx: Optional[ShardCtx] = None, remat: str = "full",
            return_hidden: bool = False, backend: Optional[str] = None):
    """Training forward -> (logits [B, S, V], aux_loss[, hidden]): aux_loss
    is the MoE layers' load-balance losses summed (0 without MoE), hidden
    the last block's output before the final norm.  ``remat`` as the
    reference's (module docstring); it changes no value."""
    _check(cfg, ctx)
    if remat not in ("full", "dots", "none"):
        raise ValueError(f"unknown remat policy {remat!r}")
    x = _inputs(cfg, params, batch)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, stage in enumerate(cfg.stages):
        def period_body(xc, auxc, period, _stage=stage):
            for i, spec in enumerate(_stage.pattern):
                xc, aux = _block(cfg, spec, period[f"block{i}"], xc,
                                 positions, backend)
                if aux is not None:
                    auxc = auxc + aux
            return xc, auxc

        body = _wrap_remat(period_body, remat)
        for period in params[f"stage{si}"]:
            x, aux_total = body(x, aux_total, period)
    logits = _head(cfg, params, x)
    if return_hidden:
        return logits, aux_total, x
    return logits, aux_total


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy, in float32 over the whole vocabulary."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return (lse - gold).mean()


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *,
            ctx: Optional[ShardCtx] = None, remat: str = "full",
            backend: Optional[str] = None) -> Tuple[torch.Tensor, dict]:
    """Causal LM loss (+ router aux + optional MTP auxiliary head) ->
    (total, {"nll", "router_aux"[, "mtp_nll"]})."""
    logits, aux, h = forward(cfg, params, batch, ctx=ctx, remat=remat,
                             return_hidden=True, backend=backend)
    nll = _xent(logits, batch["labels"])
    del logits
    total = nll + (cfg.moe.router_aux_weight * aux if cfg.moe else 0.0)
    metrics = {"nll": nll, "router_aux": aux}
    if cfg.mtp_depth and "mtp" in params and cfg.frontend is None:
        tokens = batch["tokens"]
        labels = batch["labels"]
        b, s = tokens.shape
        nxt = embed(params["embed"], tokens[:, 1:])           # t+1 tokens
        comb = torch.cat([h[:, :-1], nxt], dim=-1)
        hm = dense(params["mtp"]["combine"], comb)
        spec = BlockSpec(mixer="mla" if cfg.mla else "attn", ffn="mlp")
        hm, _ = _block(cfg, spec, params["mtp"]["block"], hm,
                       _positions(b, s - 1, hm.device), backend)
        mtp_nll = _xent(_head(cfg, params, hm), labels[:, 1:])
        total = total + 0.3 * mtp_nll
        metrics["mtp_nll"] = mtp_nll
    return total, metrics


# -- cache --------------------------------------------------------------------

def _init_block_cache(cfg: ModelConfig, spec: BlockSpec, batch: int,
                      max_seq: int, dt: torch.dtype,
                      device: torch.device) -> dict:
    c: Dict[str, Any] = {}
    if spec.mixer == "attn":
        c["mixer"] = init_kv_cache(batch, max_seq, _attn_cfg(cfg, spec), dt,
                                   device)
    elif spec.mixer == "mla":
        c["mixer"] = init_mla_cache(batch, max_seq, cfg.mla, dt, device)
    elif spec.mixer == "mamba":
        c["mixer"] = init_mamba_cache(batch, cfg.d_model, cfg.mamba, dt,
                                      device)
    elif spec.mixer == "rwkv6":
        c["mixer"] = init_rwkv_tmix_cache(batch, cfg.d_model,
                                          cfg.rwkv_head_size, dt, device)
    if spec.ffn == "rwkv6_cmix":
        c["ffn"] = init_rwkv_cmix_cache(batch, cfg.d_model, dt, device)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, *,
               device: DeviceLike = None) -> dict:
    """Zeroed decode cache: ``{"mixer": {"k", "v"}}`` per attention layer,
    ``{"mixer": {"c_kv", "k_pe"}}`` per MLA layer, ``{"mixer": {"conv",
    "ssm"}}`` per Mamba layer, ``{"mixer": {"state", "x_prev"}, "ffn":
    {"x_prev"}}`` per RWKV-6 layer."""
    _check(cfg)
    device = resolve_device(device)
    dt = _dtype(cfg)
    return {f"stage{si}": [
        {f"block{i}": _init_block_cache(cfg, spec, batch, max_seq, dt, device)
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
    x = _inputs(cfg, params, batch)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    cache: Dict[str, Any] = {}
    for si, stage in enumerate(cfg.stages):
        periods = []
        for period in params[f"stage{si}"]:
            pc = {}
            for i, spec in enumerate(stage.pattern):
                p = period[f"block{i}"]
                c: Dict[str, Any] = {}
                if spec.mixer != "none":
                    h = rms_norm(p["norm1"], x, cfg.norm_eps)
                    if spec.mixer == "attn":
                        h, c["mixer"] = attention_prefill(
                            p["mixer"], h, positions, _attn_cfg(cfg, spec),
                            backend=backend)
                    elif spec.mixer == "mla":
                        h, c["mixer"] = mla_prefill(
                            p["mixer"], h, positions, cfg.mla,
                            eps=cfg.norm_eps, backend=backend)
                    elif spec.mixer == "mamba":
                        h, c["mixer"] = mamba_prefill(
                            p["mixer"], h, cfg.mamba, backend=backend)
                    else:
                        h, c["mixer"] = rwkv_tmix_prefill(
                            p["mixer"], h, cfg.rwkv_head_size,
                            backend=backend)
                    x = x + h
                if spec.ffn == "rwkv6_cmix":
                    h, c["ffn"] = rwkv_cmix_prefill(
                        p["ffn"], rms_norm(p["norm2"], x, cfg.norm_eps))
                    x = x + h
                else:
                    x, _ = _ffn(cfg, spec, p, x)
                pc[f"block{i}"] = c
            periods.append(pc)
        cache[f"stage{si}"] = periods
    logits = _head(cfg, params, x[:, -1:])
    return logits[:, 0], cache


# -- decode -------------------------------------------------------------------

def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict,
                pos: torch.Tensor, *, ctx: Optional[ShardCtx] = None,
                backend: Optional[str] = None
                ) -> Tuple[torch.Tensor, dict]:
    """One-token decode: batch {tokens [B, 1] | embeds [B, 1, D]}, pos [B].
    Writes the new cache rows (K and V, or MLA's latent) into ``cache`` in
    place, and the recurrent layers' new states over their old ones;
    returns (logits [B, V], cache).  ``backend="ref"`` runs the recurrent
    layers' plain versions on the card (attention decode has no kernel)."""
    _check(cfg, ctx)
    x = _inputs(cfg, params, batch)
    for (spec, p), (_, c) in zip(_blocks(cfg, params), _blocks(cfg, cache)):
        if spec.mixer != "none":
            h = rms_norm(p["norm1"], x, cfg.norm_eps)
            if spec.mixer == "attn":
                h, _ = attention_decode(p["mixer"], c["mixer"], h, pos,
                                        _attn_cfg(cfg, spec))
            elif spec.mixer == "mla":
                h, _ = mla_decode(p["mixer"], c["mixer"], h, pos, cfg.mla,
                                  eps=cfg.norm_eps)
            elif spec.mixer == "mamba":
                h, _ = mamba_decode(p["mixer"], c["mixer"], h, cfg.mamba,
                                    backend=backend)
            else:
                h, _ = rwkv_tmix_decode(p["mixer"], c["mixer"], h,
                                        cfg.rwkv_head_size, backend=backend)
            x = x + h
        if spec.ffn == "rwkv6_cmix":
            h, _ = rwkv_cmix_decode(p["ffn"], c["ffn"],
                                    rms_norm(p["norm2"], x, cfg.norm_eps))
            x = x + h
        else:
            x, _ = _ffn(cfg, spec, p, x)
    logits = _head(cfg, params, x)
    return logits[:, 0], cache
