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
float32 cross-entropy ``_VocabXent`` over the whole vocabulary (no
chunking, as in the reference), plus the MoE router's aux loss weighted by
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
serving carries it and never runs it.

Meshes.  With a :class:`ShardCtx` every pass runs as explicit SPMD, one
process a device (``runtime/collectives.py``): ``params`` are this rank's
blocks under ``ctx.param_specs`` (the rule engine's specs, the port's
layout), ``batch`` (and ``pos``) the whole batch, which each pass cuts to
this rank's block over the dp axes when the batch divides them (else every
dp rank runs all of it).  Within a period the FSDP-sharded leaves are
all-gathered over their axis at use (inside remat, so the gathers repeat
in the recomputation) and their gradients reduce-scattered.  Tensor
parallelism over the model axis: a layer whose leaves the rules split on
head or channel boundaries computes only this rank's heads or channels,
and its row-parallel output is all-reduced (the Megatron pair
:func:`copy_to` / :func:`reduce_from`, which also sums the input's
gradient):

* attention whose four projections are split, and a dense MLP;
* GQA attention whose query heads are split and whose KV heads stay whole
  (the rank's query heads under one KV head): in training the whole
  ``wk``/``wv`` leaves are cut to that head, their gradient summed over
  the axis (``copy_to`` on the leaf); prefill and decode compute every KV
  head, for the whole cache;
* MLA: the latent path (``wq_a``, ``wkv_a``, the norms, ``k_pe``) whole on
  every rank, the latents passing to the rank's heads through ``copy_to``
  (so the layer's input takes no second sum);
* Mamba: ``in_proj``'s column blocks are ``[x | z]``'s, not the rank's
  channels, so it is gathered whole (its gradient reduce-scattered,
  :func:`fsdp_gather`) and the rank's x and z columns cut from it;
  ``x_proj``'s partial products are summed (all-reduce both ways);
* RWKV-6's time mix where the heads divide the axis: token shift, ``mix``
  and ``w_lora_a`` whole (their gradients summed), the whole leaves
  ``wk``, ``wv``, ``wo``, ``w_bias`` and ``ln_out`` cut to the rank's heads
  (:func:`split_rep`: the gradient's blocks gathered).

Prefill all-gathers Mamba's and RWKV-6's final states into the whole cache
the rules give every rank, and their decode runs replicated on it.  A
layer whose split does not fall on heads or channels (its rule degraded,
or the heads do not divide the axis), RWKV-6's channel mix, whose leaves
the rules never split, and Mamba's and RWKV-6's decode compute replicated:
their model-split leaves are gathered whole before use
(:func:`replication_tally` counts them).  The embedding and the output head
are vocab-parallel, and the loss a vocab-parallel cross-entropy
(:class:`_VocabXent`) that never gathers the logits.
MoE layers run :func:`moe.moe_apply`, the all-to-all dispatch where
``FLAGS.moe_a2a`` asks and the sequence divides the model axis (the
reference's condition).  Under ``FLAGS.seq_shard_acts`` the residual
stream between blocks is split over the sequence on the model axis and
gathered before each half-block.  ``loss_fn`` returns the whole batch's
loss on every rank (each term mean-reduced over the dp axes);
``prefill`` and ``decode_step`` return the whole batch's logits and this
rank's cache blocks.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.utils.checkpoint as torch_checkpoint

from ..device import DeviceLike, resolve_device
from ..runtime.collectives import (all_gather_dim, axis_group, axis_index,
                                   axis_size, copy_to, fsdp_gather,
                                   gather_rep, mean_rep, reduce_from,
                                   split_rep)
from ..runtime.sharding import shard_local, spec_axes
from .attention import (attention_decode, attention_prefill,
                        attention_train, init_attention, init_kv_cache)
from .config import BlockSpec, ModelConfig
from .flags import FLAGS
from .layers import (dense, embed, init_dense, init_embedding, init_mlp,
                     init_rms_norm, mlp_block, rms_norm, unembed)
from .mamba import (init_mamba, init_mamba_cache, mamba_decode,
                    mamba_prefill, mamba_train)
from .mla import init_mla, init_mla_cache, mla_decode, mla_prefill, mla_train
from .moe import init_moe, moe_apply, moe_block_local, shared_expert_mlp
from .rwkv6 import (init_rwkv_cmix, init_rwkv_cmix_cache, init_rwkv_tmix,
                    init_rwkv_tmix_cache, rwkv_cmix_decode,
                    rwkv_cmix_prefill, rwkv_cmix_train, rwkv_tmix_decode,
                    rwkv_tmix_prefill, rwkv_tmix_train)

__all__ = ["ShardCtx", "init_params", "forward", "prefill", "decode_step",
           "init_cache", "loss_fn", "replication_tally"]

_NOT_PORTED = "not a block kind of the reference (ROADMAP.md)"
_MIXERS = ("attn", "mla", "mamba", "rwkv6", "none")
_FFNS = ("mlp", "moe", "rwkv6_cmix", "none")

#: the open :func:`replication_tally` counters
_TALLIES: list = []


@contextlib.contextmanager
def replication_tally():
    """Counts, while open, each computation a mesh pass runs whole on every
    rank of a model axis larger than one (``ShardCtx.replicate``): by kind
    ("attn", "mla", "mamba", "rwkv6", "mlp", "rwkv6_cmix", "moe_shared",
    "embed", "head"), one a layer and pass.  Yields a ``Counter``."""
    tally: collections.Counter = collections.Counter()
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.remove(tally)


def _replicated(ctx: "ShardCtx", kind: str) -> None:
    if _TALLIES and ctx.tp_size > 1:
        for tally in _TALLIES:
            tally[kind] += 1


@dataclass(frozen=True, eq=False)
class ShardCtx:
    """Mesh context threaded to mesh-aware layers: the reference's
    ``mesh``, ``dp_axes`` and ``tp_axis``, the spec tree of the local
    parameters (``param_specs``, the port's layout, as ``plan_cell`` sets
    it; None: every leaf whole on every rank, which only a model axis of
    one runs) and of the local decode cache (``cache_specs``; None: the
    cache split over the batch and the KV heads only), and ``dp_ok``,
    whether the batch in flight is split over the dp axes (each pass sets
    it from the batch it gets)."""
    mesh: Any
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    param_specs: Any = None
    cache_specs: Any = None
    dp_ok: bool = True

    @functools.cached_property
    def tp_size(self) -> int:
        return axis_size(self.mesh, self.tp_axis)

    @functools.cached_property
    def tp_rank(self) -> int:
        return axis_index(self.mesh, self.tp_axis)

    @functools.cached_property
    def tp_group(self):
        return axis_group(self.mesh, self.tp_axis)

    @functools.cached_property
    def dp_size(self) -> int:
        return axis_size(self.mesh, self.dp_axes)

    @functools.cached_property
    def dp_group(self):
        return axis_group(self.mesh, self.dp_axes)

    # -- the batch ------------------------------------------------------------

    def for_batch(self, b: int) -> "ShardCtx":
        """This context for a batch of ``b`` (split over dp if it divides)."""
        return dataclasses.replace(self, dp_ok=b % self.dp_size == 0)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole-batch tensor (dim 0)."""
        if not self.dp_ok:
            return t
        k = t.shape[0] // self.dp_size
        return t.narrow(0, axis_index(self.mesh, self.dp_axes) * k, k)

    def whole(self, t: torch.Tensor) -> torch.Tensor:
        """The whole batch of a per-rank block (dim 0; no gradient)."""
        return all_gather_dim(t, 0, self.dp_group) if self.dp_ok else t

    def seq_split(self, s: int) -> bool:
        """Megatron-SP between blocks (``FLAGS.seq_shard_acts``)."""
        return FLAGS.seq_shard_acts and s > 1 and s % self.tp_size == 0

    # -- parameters -----------------------------------------------------------

    def unshard(self, tree: Any, specs: Any) -> Tuple[Any, Any]:
        """FSDP: every leaf all-gathered over the axes other than the model
        axis (reduce-scatter backward) -> (tree, specs with the model axis
        only)."""
        if specs is None:
            return tree, None
        if isinstance(tree, dict):
            pairs = {k: self.unshard(tree[k], specs[k]) for k in tree}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        if isinstance(tree, (list, tuple)):
            pairs = [self.unshard(t, s) for t, s in zip(tree, specs)]
            return (type(tree)(p[0] for p in pairs),
                    type(tree)(p[1] for p in pairs))
        out, kept = tree, []
        for dim, entry in enumerate(specs):
            axes = tuple(a for a in spec_axes(entry) if a != self.tp_axis)
            if axes:
                out = fsdp_gather(out, dim, axis_group(self.mesh, axes))
            kept.append(self.tp_axis if self.tp_axis in spec_axes(entry)
                        else None)
        return out, kept

    def replicate(self, tree: Any, specs: Any) -> Any:
        """Every model-split leaf gathered whole, for a computation that
        runs replicated over the model axis (its gradient: this rank's
        block)."""
        if specs is None:
            return tree
        if isinstance(tree, dict):
            return {k: self.replicate(tree[k], specs[k]) for k in tree}
        out = tree
        for dim, entry in enumerate(specs):
            if entry == self.tp_axis:
                out = gather_rep(out, dim, self.tp_group)
        return out

    def split(self, specs: Any, *wants: Tuple[str, int]) -> bool:
        """Whether each named leaf ``(path, dim)`` is split over the model
        axis at ``dim`` (paths as "wq/w")."""
        if specs is None:
            return False
        for path, dim in wants:
            node = specs
            for k in path.split("/"):
                if not isinstance(node, dict) or k not in node:
                    return False
                node = node[k]
            if node[dim] != self.tp_axis:
                return False
        return True


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check(cfg: ModelConfig) -> None:
    for stage in cfg.stages:
        for spec in stage.pattern:
            if spec.mixer not in _MIXERS:
                raise NotImplementedError(
                    f"mixer {spec.mixer!r} ({cfg.name}) is {_NOT_PORTED}")
            if spec.ffn not in _FFNS:
                raise NotImplementedError(
                    f"ffn {spec.ffn!r} ({cfg.name}) is {_NOT_PORTED}")


def _attn_cfg(cfg: ModelConfig, spec: BlockSpec):
    return spec.attn_override or cfg.attention


def _specs(ctx: Optional[ShardCtx], key: str, n: int):
    """The spec subtree under ``key`` (a list of ``n`` Nones without)."""
    if ctx is None or ctx.param_specs is None:
        return [None] * n if n else None
    return ctx.param_specs[key]


# -- init ---------------------------------------------------------------------

def _init_block(gen: Optional[torch.Generator], cfg: ModelConfig,
                spec: BlockSpec, device: torch.device) -> dict:
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


def _keep_local(tree: Any, specs: Any, mesh) -> Any:
    if isinstance(tree, dict):
        return {k: _keep_local(v, specs[k], mesh) for k, v in tree.items()}
    return shard_local(tree, specs, mesh).clone()


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device: DeviceLike = None,
                ctx: Optional[ShardCtx] = None) -> dict:
    """Random weights from ``seed``, drawn on the device by a
    ``torch.Generator`` there, leaf by leaf in float32 and then cast.  On
    the ``meta`` device nothing is drawn or allocated (shapes only).  With
    ``ctx`` each block keeps only this rank's blocks of its leaves, under
    ``ctx.param_specs``, as soon as it is drawn (the same numbers as the
    whole tree's: every leaf is drawn whole)."""
    _check(cfg)
    device = resolve_device(device)
    gen = None
    if device.type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
    dt = _dtype(cfg)
    keep = (lambda tree, specs: tree) if ctx is None else \
        (lambda tree, specs: _keep_local(tree, specs, ctx.mesh))
    ps = ctx.param_specs if ctx is not None else None
    params: Dict[str, Any] = {
        "embed": keep(init_embedding(gen, cfg.vocab_size, cfg.d_model, dt,
                                     device), ps and ps["embed"]),
        "final_norm": keep(init_rms_norm(cfg.d_model, device),
                           ps and ps["final_norm"]),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = keep(init_dense(gen, cfg.d_model, cfg.vocab_size,
                                            dt, device),
                                 ps and ps["lm_head"])
    for si, stage in enumerate(cfg.stages):
        params[f"stage{si}"] = [
            {f"block{i}": keep(_init_block(gen, cfg, spec, device),
                               ps and ps[f"stage{si}"][n][f"block{i}"])
             for i, spec in enumerate(stage.pattern)}
            for n in range(stage.n_periods)]
    if cfg.mtp_depth:
        # DeepSeek-V3 MTP: a block predicting token t+2 from (h_t,
        # embed(token_{t+1})); read by the training loss only
        mtp_spec = BlockSpec(mixer="mla" if cfg.mla else "attn", ffn="mlp")
        params["mtp"] = {
            "combine": keep(init_dense(gen, 2 * cfg.d_model, cfg.d_model, dt,
                                       device),
                            ps and ps["mtp"]["combine"]),
            "block": keep(_init_block(gen, cfg, mtp_spec, device),
                          ps and ps["mtp"]["block"]),
        }
    return params


# -- shared pieces ------------------------------------------------------------

def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
           ctx: Optional[ShardCtx]) -> torch.Tensor:
    if ctx is None:
        return embed(params["embed"], tokens)
    table, ts = ctx.unshard(params["embed"]["table"],
                            ctx.param_specs and
                            ctx.param_specs["embed"]["table"])
    if ts is None or ts[0] != ctx.tp_axis:
        _replicated(ctx, "embed")
        return embed({"table": ctx.replicate(table, ts)}, tokens)
    # vocab-parallel: each rank looks up the ids it holds, the rest are 0
    v_loc = table.shape[0]
    ids = tokens - ctx.tp_rank * v_loc
    mine = (ids >= 0) & (ids < v_loc)
    e = table[ids.clamp(0, v_loc - 1)]
    return reduce_from(torch.where(mine[..., None], e, 0), ctx.tp_group)


def _inputs(cfg: ModelConfig, params: dict, batch: dict,
            ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """[B, S, D] block input: token embeddings, or a frontend stub's
    precomputed ``embeds`` cast to the model dtype."""
    if cfg.frontend is not None:
        return batch["embeds"].to(_dtype(cfg))
    return _embed(cfg, params, batch["tokens"], ctx)


def _positions(b: int, s: int, device: torch.device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, :].expand(b, s)


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor,
          ctx: Optional[ShardCtx] = None
          ) -> Tuple[torch.Tensor, Optional[int]]:
    """-> (logits, the first vocabulary id they hold when split over the
    model axis, else None)."""
    if ctx is None:
        x = rms_norm(params["final_norm"], x, cfg.norm_eps)
        if cfg.tie_embeddings:
            return unembed(params["embed"], x), None
        return dense(params["lm_head"], x), None
    norm, _ = ctx.unshard(params["final_norm"], _specs(ctx, "final_norm", 0))
    x = rms_norm(norm, x, cfg.norm_eps)
    key, leaf, dim = (("embed", "table", 0) if cfg.tie_embeddings
                      else ("lm_head", "w", 1))
    w, ws = ctx.unshard(params[key][leaf],
                        ctx.param_specs and ctx.param_specs[key][leaf])
    if ws is None or ws[dim] != ctx.tp_axis:
        _replicated(ctx, "head")
        w = ctx.replicate(w, ws)
        return (x @ w.T if dim == 0 else x @ w), None
    x = copy_to(x, ctx.tp_group)
    return (x @ w.T if dim == 0 else x @ w), ctx.tp_rank * w.shape[dim]


def _apply_moe(cfg: ModelConfig, p: dict, h: torch.Tensor,
               ctx: Optional[ShardCtx] = None, ps: Any = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_apply_moe``: without a ``ShardCtx`` the local
    block over all B * S tokens plus the shared experts; with one
    ``moe_apply``, the all-to-all dispatch where ``FLAGS.moe_a2a`` asks and
    the sequence divides the model axis."""
    if ctx is not None:
        dispatch = "a2a" if (FLAGS.moe_a2a and h.shape[1] % ctx.tp_size == 0
                             and h.shape[1] > 1) else "replicated"
        shared_split = bool(cfg.moe.n_shared) and ctx.split(
            ps, ("shared/up/w", -1), ("shared/gate/w", -1),
            ("shared/down/w", -2))
        if cfg.moe.n_shared and not shared_split:
            _replicated(ctx, "moe_shared")
            p = {**p, "shared": ctx.replicate(p["shared"],
                                              ps and ps["shared"])}
        out, aux, _ = moe_apply(p, h, cfg.moe, mesh=ctx.mesh,
                                dp_axes=ctx.dp_axes, tp_axis=ctx.tp_axis,
                                act=cfg.act, dispatch=dispatch,
                                dp_ok=ctx.dp_ok, shared_split=shared_split)
        return out, aux
    b, s, d = h.shape
    out, aux, _ = moe_block_local(p, h.reshape(b * s, d), cfg.moe,
                                  n_shards=1, shard_ix=0, tp_axis=None,
                                  act=cfg.act)
    out = out.reshape(b, s, d)
    if cfg.moe.n_shared:
        out = out + shared_expert_mlp(p["shared"], h)
    return out, aux


@dataclass(frozen=True)
class _Mixer:
    """A block's mixer as one rank runs it: its parameters (this rank's
    share where the layer runs split), its config (the attention or MLA
    config with the rank's head counts; None for Mamba and RWKV-6), the
    model axis's group when the layer runs split over it, and for GQA
    layers whose KV heads stay whole ``kv = (first KV head, whole KV
    heads)`` (``attention.py``)."""
    params: dict
    cfg: Any = None
    group: Any = None
    kv: Optional[Tuple[int, int]] = None


_MAMBA_SPLIT = (("in_proj/w", -1), ("conv_w", -1), ("conv_b", -1),
                ("x_proj/w", -2), ("dt_proj/w", -1), ("dt_bias", -1),
                ("A_log", -2), ("D", -1), ("out_proj/w", -2))


def _mixer_setup(cfg: ModelConfig, spec: BlockSpec, p: dict, ps: Any,
                 ctx: Optional[ShardCtx], mode: str = "train") -> _Mixer:
    """The mixer of one block for a pass (``mode``: "train", "prefill" or
    "decode"): split over the model axis where the rules' split of its
    leaves falls on heads or channels, else replicated (module
    docstring)."""
    pm, acfg = p["mixer"], _attn_cfg(cfg, spec)
    if ctx is None:
        return _Mixer(pm, cfg.mla if spec.mixer == "mla" else acfg)
    ms = ps and ps["mixer"]
    n, group = ctx.tp_size, ctx.tp_group
    if spec.mixer == "attn":
        if ctx.split(ms, ("wq/w", -1), ("wk/w", -1), ("wv/w", -1),
                     ("wo/w", -2)):
            return _Mixer(pm, dataclasses.replace(
                acfg, n_heads=acfg.n_heads // n,
                n_kv_heads=acfg.n_kv_heads // n), group)
        hq = acfg.n_heads // n
        groups = acfg.n_heads // acfg.n_kv_heads
        if ctx.split(ms, ("wq/w", -1), ("wo/w", -2)) and groups % hq == 0:
            # the rank's query heads share one KV head, whose K and V
            # projections are whole leaves
            local = dataclasses.replace(acfg, n_heads=hq, n_kv_heads=1)
            first = ctx.tp_rank * hq // groups
            if mode != "train":     # the cache holds every KV head
                return _Mixer(pm, local, group, (first, acfg.n_kv_heads))
            d = acfg.head_dim
            return _Mixer({**pm, **{k: {"w": copy_to(pm[k]["w"], group)
                                        .narrow(-1, first * d, d)}
                                    for k in ("wk", "wv")}}, local, group)
    elif spec.mixer == "mla":
        if ctx.split(ms, ("wq_b/w", -1), ("wkv_b/w", -1), ("wo/w", -2)):
            return _Mixer(pm, dataclasses.replace(
                cfg.mla, n_heads=cfg.mla.n_heads // n), group)
    elif spec.mixer == "mamba":
        if mode != "decode" and ctx.split(ms, *_MAMBA_SPLIT):
            # in_proj's columns are [x | z]: its blocks are not the rank's
            # channels, so it is gathered whole (its gradient
            # reduce-scattered) and the rank's x and z columns cut from it
            w = fsdp_gather(pm["in_proj"]["w"], -1, group)
            di = w.shape[-1] // 2
            k, r = di // n, ctx.tp_rank
            w = torch.cat([w.narrow(-1, r * k, k),
                           w.narrow(-1, di + r * k, k)], dim=-1)
            return _Mixer({**pm, "in_proj": {"w": w}}, None, group)
    elif spec.mixer == "rwkv6":
        if mode != "decode" and ctx.split(
                ms, ("wr/w", -1), ("wg/w", -1), ("w_lora_b/w", -1),
                ("u", -2)):
            # u split by heads: every split falls on them.  The token
            # shift's mix and w_lora_a run whole on every rank: their
            # gradients are summed over the axis.  The whole leaves the
            # rank's heads use are cut to them: each block's gradient is
            # its rank's alone, gathered
            def cut(leaf, dim):
                return split_rep(leaf, dim, group)
            return _Mixer({
                **pm, "mix": copy_to(pm["mix"], group),
                "w_lora_a": {"w": copy_to(pm["w_lora_a"]["w"], group)},
                "wk": {"w": cut(pm["wk"]["w"], -1)},
                "wv": {"w": cut(pm["wv"]["w"], -1)},
                "wo": {"w": cut(pm["wo"]["w"], -2)},
                "w_bias": cut(pm["w_bias"], -1),
                "ln_out": {"scale": cut(pm["ln_out"]["scale"], -1)}},
                None, group)
    _replicated(ctx, spec.mixer)
    return _Mixer(ctx.replicate(pm, ms),
                  cfg.mla if spec.mixer == "mla" else acfg)


def _mixer(cfg: ModelConfig, spec: BlockSpec, p: dict, ps: Any,
           ctx: Optional[ShardCtx], h: torch.Tensor, mode: str,
           positions: Optional[torch.Tensor] = None,
           backend: Optional[str] = None, cache: Optional[dict] = None,
           pos: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, Optional[dict]]:
    """The block's mixer on the normed input ``h`` in a pass (``mode``) ->
    (its output, the layer's cache from a prefill, else None).  Split over
    the model axis (``_mixer_setup``): the output all-reduced, and the
    input's gradient too, except for MLA, whose latents take that sum
    where they pass to the rank's heads."""
    m = _mixer_setup(cfg, spec, p, ps, ctx, mode)
    g, pm = m.group, m.params
    if spec.mixer == "attn":
        if mode == "train":
            return _tp(lambda y: attention_train(pm, y, positions, m.cfg,
                                                 backend=backend), g, h), None
        if mode == "prefill":
            return _tp(lambda y: attention_prefill(
                pm, y, positions, m.cfg, kv=m.kv, backend=backend), g, h)
        out, _ = _tp(lambda y: attention_decode(pm, cache, y, pos, m.cfg,
                                                kv=m.kv), g, h)
        return out, None
    if spec.mixer == "mla":
        kw = dict(eps=cfg.norm_eps)
        if g is not None:
            kw["enter"] = functools.partial(copy_to, group=g)
        c = None
        if mode == "train":
            out = mla_train(pm, h, positions, m.cfg, backend=backend, **kw)
        elif mode == "prefill":
            out, c = mla_prefill(pm, h, positions, m.cfg, backend=backend,
                                 **kw)
        else:
            out, _ = mla_decode(pm, cache, h, pos, m.cfg, eps=cfg.norm_eps)
        return (out if g is None else reduce_from(out, g)), c
    if mode == "decode":
        if spec.mixer == "mamba":
            return mamba_decode(pm, cache, h, cfg.mamba,
                                backend=backend)[0], None
        return rwkv_tmix_decode(pm, cache, h, cfg.rwkv_head_size,
                                backend=backend)[0], None
    if spec.mixer == "mamba":
        kw = dict(backend=backend)
        if g is not None:    # x_proj's partial products (the rank's rows)
            kw["reduce"] = lambda t: copy_to(reduce_from(t, g), g)
        if mode == "train":
            return _tp(lambda y: mamba_train(pm, y, cfg.mamba, **kw), g,
                       h), None
        out, c = _tp(lambda y: mamba_prefill(pm, y, cfg.mamba, **kw), g, h)
        if g is not None:    # the whole cache, as cache_specs lays it out
            c = {"conv": all_gather_dim(c["conv"], 2, g),
                 "ssm": all_gather_dim(c["ssm"], 1, g)}
        return out, c
    hs = cfg.rwkv_head_size
    if mode == "train":
        return _tp(lambda y: rwkv_tmix_train(pm, y, hs, backend=backend), g,
                   h), None
    out, c = _tp(lambda y: rwkv_tmix_prefill(pm, y, hs, backend=backend), g,
                 h)
    if g is not None:
        c = {**c, "state": all_gather_dim(c["state"], 1, g)}
    return out, c


def _ffn_setup(cfg: ModelConfig, spec: BlockSpec, p: dict, ps: Any,
               ctx: Optional[ShardCtx]):
    """-> (the MLP's or channel mix's parameters, the model axis's group
    when the MLP runs column/row-parallel, else None)."""
    if ctx is None:
        return p["ffn"], None
    fs = ps and ps["ffn"]
    if spec.ffn == "mlp" and ctx.split(
            fs, ("up/w", -1), ("down/w", -2),
            *((("gate/w", -1),) if cfg.act == "silu" else ())):
        return p["ffn"], ctx.tp_group
    _replicated(ctx, spec.ffn)
    return ctx.replicate(p["ffn"], fs), None


def _tp(fn, group, h: torch.Tensor):
    """``fn(h)``, whose output (or its first element) is all-reduced over
    ``group`` when given, and the input's gradient too (Megatron's pair)."""
    if group is None:
        return fn(h)
    out = fn(copy_to(h, group))
    if isinstance(out, tuple):
        return (reduce_from(out[0], group),) + out[1:]
    return reduce_from(out, group)


class _SP:
    """Megatron-SP between blocks: the residual split over the sequence on
    the model axis, gathered before each half-block."""

    def __init__(self, ctx: Optional[ShardCtx], s: int) -> None:
        self.group = ctx.tp_group if ctx is not None and ctx.seq_split(s) \
            else None

    def enter(self, x):
        return x if self.group is None else split_rep(x, 1, self.group)

    def full(self, x):
        return x if self.group is None else gather_rep(x, 1, self.group)

    def back(self, h):
        return h if self.group is None else split_rep(h, 1, self.group)


_NO_SP = _SP(None, 1)


def _ffn(cfg: ModelConfig, spec: BlockSpec, p: dict, x: torch.Tensor,
         ctx: Optional[ShardCtx] = None, ps: Any = None, sp: _SP = _NO_SP
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """-> (x after the FFN half of the block, the MoE aux loss or None)."""
    if spec.ffn == "none":
        return x, None
    h = rms_norm(p["norm2"], sp.full(x), cfg.norm_eps)
    aux = None
    if spec.ffn == "moe":
        h, aux = _apply_moe(cfg, p["ffn"], h, ctx, ps and ps["ffn"])
    else:
        pf, group = _ffn_setup(cfg, spec, p, ps, ctx)
        if spec.ffn == "mlp":
            h = _tp(lambda y: mlp_block(pf, y, cfg.act), group, h)
        else:
            h = rwkv_cmix_train(pf, h)
    return x + sp.back(h), aux


# -- forward ------------------------------------------------------------------

def _block(cfg: ModelConfig, spec: BlockSpec, p: dict, x: torch.Tensor,
           positions: torch.Tensor, backend: Optional[str],
           ctx: Optional[ShardCtx] = None, ps: Any = None,
           sp: _SP = _NO_SP
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One block of the training forward -> (x, MoE aux loss or None)."""
    if spec.mixer != "none":
        h = rms_norm(p["norm1"], sp.full(x), cfg.norm_eps)
        h, _ = _mixer(cfg, spec, p, ps, ctx, h, "train", positions, backend)
        x = x + sp.back(h)
    return _ffn(cfg, spec, p, x, ctx, ps, sp)


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


def _local_batch(batch: dict, ctx: Optional[ShardCtx]
                 ) -> Tuple[dict, Optional[ShardCtx]]:
    """Under a ctx, this rank's block of the whole batch, and the ctx for
    it."""
    if ctx is None:
        return batch, None
    b = next(iter(batch.values())).shape[0]
    ctx = ctx.for_batch(b)
    return {k: ctx.local(v) for k, v in batch.items()}, ctx


def _forward(cfg: ModelConfig, params: dict, batch: dict,
             ctx: Optional[ShardCtx], remat: str, backend: Optional[str]):
    """-> (logits, aux, hidden, the first vocab id of the logits or None,
    the local batch, the ctx for it)."""
    _check(cfg)
    if remat not in ("full", "dots", "none"):
        raise ValueError(f"unknown remat policy {remat!r}")
    batch, ctx = _local_batch(batch, ctx)
    x = _inputs(cfg, params, batch, ctx)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    sp = _SP(ctx, s)
    x = sp.enter(x)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, stage in enumerate(cfg.stages):
        def period_body(xc, auxc, period, pspecs, _stage=stage):
            if ctx is not None:
                period, pspecs = ctx.unshard(period, pspecs)
            for i, spec in enumerate(_stage.pattern):
                xc, aux = _block(cfg, spec, period[f"block{i}"], xc,
                                 positions, backend, ctx,
                                 pspecs and pspecs[f"block{i}"], sp)
                if aux is not None:
                    auxc = auxc + aux
            return xc, auxc

        body = _wrap_remat(period_body, remat)
        periods = params[f"stage{si}"]
        for period, pspecs in zip(periods,
                                  _specs(ctx, f"stage{si}", len(periods))):
            x, aux_total = body(x, aux_total, period, pspecs)
    x = sp.full(x)
    logits, v0 = _head(cfg, params, x, ctx)
    return logits, aux_total, x, v0, batch, ctx


def forward(cfg: ModelConfig, params: dict, batch: dict, *,
            ctx: Optional[ShardCtx] = None, remat: str = "full",
            return_hidden: bool = False, backend: Optional[str] = None):
    """Training forward -> (logits [B, S, V], aux_loss[, hidden]): aux_loss
    is the MoE layers' load-balance losses summed (0 without MoE), hidden
    the last block's output before the final norm.  ``remat`` as the
    reference's (module docstring); it changes no value.  Under a ctx the
    logits and hidden are this rank's batch block, the logits its
    vocabulary block where the head is split."""
    logits, aux, h, _, _, _ = _forward(cfg, params, batch, ctx, remat,
                                       backend)
    if return_hidden:
        return logits, aux, h
    return logits, aux


class _VocabXent(torch.autograd.Function):
    """Mean token cross-entropy, in float32 over the vocabulary: the max
    and the sum of exponentials of the logits and the gold logit, each
    all-reduced over ``group`` where the logits are split by vocabulary
    over it (``v0`` the first id of this rank's block; no collective
    without a group).  The logits are never gathered, and the backward
    keeps only them (in their own dtype) and the log-sum-exp."""

    @staticmethod
    def forward(ctx, logits, labels, v0, group):
        def reduce(t, **kw):
            if group is not None:
                dist.all_reduce(t, group=group, **kw)
        lf = logits.float()
        m = torch.amax(lf, dim=-1, keepdim=True)
        reduce(m, op=dist.ReduceOp.MAX)
        m.masked_fill_(m.abs() == float("inf"), 0)
        s = torch.sum(torch.exp(lf - m), dim=-1)
        reduce(s)
        lse = s.log().add(m[..., 0])
        local = labels.long() - v0
        mine = (local >= 0) & (local < lf.shape[-1])
        local = local.clamp(0, lf.shape[-1] - 1)
        gold = torch.gather(lf, -1, local[..., None])[..., 0]
        gold = torch.where(mine, gold, 0.0)
        reduce(gold)
        ctx.save_for_backward(logits, lse, local, mine)
        return (lse - gold).mean()

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, mine = ctx.saved_tensors
        gt = g.expand(lse.shape) / lse.numel()
        grad = gt[..., None] * (logits.float() - lse[..., None]).exp()
        grad.scatter_add_(-1, local[..., None],
                          torch.where(mine, -gt, 0.0)[..., None])
        return grad.to(logits.dtype), None, None, None


def _nll(logits: torch.Tensor, labels: torch.Tensor, v0: Optional[int],
         ctx: Optional[ShardCtx]) -> torch.Tensor:
    group = None if ctx is None or v0 is None else ctx.tp_group
    nll = _VocabXent.apply(logits, labels, v0 or 0, group)
    return nll if ctx is None else mean_rep(nll, ctx.dp_group)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, *,
            ctx: Optional[ShardCtx] = None, remat: str = "full",
            backend: Optional[str] = None) -> Tuple[torch.Tensor, dict]:
    """Causal LM loss (+ router aux + optional MTP auxiliary head) ->
    (total, {"nll", "router_aux"[, "mtp_nll"]}); under a ctx the whole
    batch's, on every rank."""
    logits, aux, h, v0, batch, ctx = _forward(cfg, params, batch, ctx,
                                              remat, backend)
    nll = _nll(logits, batch["labels"], v0, ctx)
    del logits
    total = nll + (cfg.moe.router_aux_weight * aux if cfg.moe else 0.0)
    metrics = {"nll": nll, "router_aux": aux}
    if cfg.mtp_depth and "mtp" in params and cfg.frontend is None:
        tokens = batch["tokens"]
        labels = batch["labels"]
        b, s = tokens.shape
        mtp, ms = params["mtp"], _specs(ctx, "mtp", 0)
        if ctx is not None:
            mtp, ms = ctx.unshard(mtp, ms)
            mtp = {**mtp, "combine": ctx.replicate(mtp["combine"],
                                                   ms and ms["combine"])}
        nxt = _embed(cfg, params, tokens[:, 1:], ctx)         # t+1 tokens
        comb = torch.cat([h[:, :-1], nxt], dim=-1)
        hm = dense(mtp["combine"], comb)
        spec = BlockSpec(mixer="mla" if cfg.mla else "attn", ffn="mlp")
        hm, _ = _block(cfg, spec, mtp["block"], hm,
                       _positions(b, s - 1, hm.device), backend, ctx,
                       ms and ms["block"])
        logits2, v0 = _head(cfg, params, hm, ctx)
        mtp_nll = _nll(logits2, labels[:, 1:], v0, ctx)
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


def _cache_seq_axes(ctx: Optional[ShardCtx], cs: Any):
    """{leaf: the axes its sequence dim (dim 1) is split over} of one
    layer's cache specs: the KV caches of a batch that does not divide the
    dp axes (the rules' ``long_500k`` case)."""
    if ctx is None or cs is None:
        return {}
    return {(part, k): spec_axes(s[1]) for part, sub in cs.items()
            for k, s in sub.items() if len(s) > 1 and spec_axes(s[1])}


def _whole_logits(logits: torch.Tensor, v0: Optional[int],
                  ctx: Optional[ShardCtx]) -> torch.Tensor:
    if ctx is None:
        return logits
    if v0 is not None:
        logits = all_gather_dim(logits, -1, ctx.tp_group)
    return ctx.whole(logits)


# -- prefill ------------------------------------------------------------------

def prefill(cfg: ModelConfig, params: dict, batch: dict, *,
            ctx: Optional[ShardCtx] = None, backend: Optional[str] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Prefill a prompt of length S -> (last-position logits [B, V],
    cache filled for positions [0, S)); under a ctx the whole batch's
    logits and this rank's cache blocks."""
    _check(cfg)
    batch, ctx = _local_batch(batch, ctx)
    x = _inputs(cfg, params, batch, ctx)
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    sp = _SP(ctx, s)
    x = sp.enter(x)
    cache: Dict[str, Any] = {}
    for si, stage in enumerate(cfg.stages):
        periods = []
        n = len(params[f"stage{si}"])
        cspecs = ctx.cache_specs[f"stage{si}"] if ctx is not None and \
            ctx.cache_specs is not None else [None] * n
        for period, pspecs, cperiod in zip(params[f"stage{si}"],
                                           _specs(ctx, f"stage{si}", n),
                                           cspecs):
            if ctx is not None:
                period, pspecs = ctx.unshard(period, pspecs)
            pc = {}
            for i, spec in enumerate(stage.pattern):
                p = period[f"block{i}"]
                ps = pspecs and pspecs[f"block{i}"]
                c: Dict[str, Any] = {}
                if spec.mixer != "none":
                    h = rms_norm(p["norm1"], sp.full(x), cfg.norm_eps)
                    h, c["mixer"] = _mixer(cfg, spec, p, ps, ctx, h,
                                           "prefill", positions, backend)
                    x = x + sp.back(h)
                if spec.ffn == "rwkv6_cmix":
                    pf, _ = _ffn_setup(cfg, spec, p, ps, ctx)
                    h, c["ffn"] = rwkv_cmix_prefill(
                        pf, rms_norm(p["norm2"], sp.full(x), cfg.norm_eps))
                    x = x + sp.back(h)
                else:
                    x, _ = _ffn(cfg, spec, p, x, ctx, ps, sp)
                for (part, k), axes in _cache_seq_axes(
                        ctx, cperiod and cperiod[f"block{i}"]).items():
                    t = c[part][k]
                    n_ax = axis_size(ctx.mesh, axes)
                    c[part][k] = t.narrow(1, axis_index(ctx.mesh, axes)
                                          * (t.shape[1] // n_ax),
                                          t.shape[1] // n_ax).clone()
                pc[f"block{i}"] = c
            periods.append(pc)
        cache[f"stage{si}"] = periods
    x = sp.full(x)
    logits, v0 = _head(cfg, params, x[:, -1:], ctx)
    return _whole_logits(logits[:, 0], v0, ctx), cache


# -- decode -------------------------------------------------------------------

def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict,
                pos: torch.Tensor, *, ctx: Optional[ShardCtx] = None,
                backend: Optional[str] = None
                ) -> Tuple[torch.Tensor, dict]:
    """One-token decode: batch {tokens [B, 1] | embeds [B, 1, D]}, pos [B].
    Writes the new cache rows (K and V, or MLA's latent) into ``cache`` in
    place, and the recurrent layers' new states over their old ones;
    returns (logits [B, V], cache).  ``backend="ref"`` runs the recurrent
    layers' plain versions on the card (attention decode has no kernel).
    Under a ctx ``batch`` and ``pos`` are the whole batch's, ``cache``
    this rank's blocks; the logits are the whole batch's."""
    _check(cfg)
    batch, ctx = _local_batch(batch, ctx)
    if ctx is not None:
        pos = ctx.local(pos)
    x = _inputs(cfg, params, batch, ctx)
    for si, stage in enumerate(cfg.stages):
        n = len(params[f"stage{si}"])
        cspecs = ctx.cache_specs[f"stage{si}"] if ctx is not None and \
            ctx.cache_specs is not None else [None] * n
        for period, pspecs, cper, cspec in zip(
                params[f"stage{si}"], _specs(ctx, f"stage{si}", n),
                cache[f"stage{si}"], cspecs):
            if ctx is not None:
                period, pspecs = ctx.unshard(period, pspecs)
            for i, spec in enumerate(stage.pattern):
                p, c = period[f"block{i}"], cper[f"block{i}"]
                ps = pspecs and pspecs[f"block{i}"]
                split = _cache_seq_axes(ctx, cspec and cspec[f"block{i}"])
                if split:   # the sequence-split KV cache, whole for the step
                    kept, c = c, {part: dict(sub) for part, sub in c.items()}
                    for (part, k), axes in split.items():
                        c[part][k] = all_gather_dim(
                            kept[part][k], 1, axis_group(ctx.mesh, axes))
                x = _decode_block(cfg, spec, p, ps, c, x, pos, ctx, backend)
                for (part, k), axes in split.items():
                    step = kept[part][k].shape[1]
                    kept[part][k].copy_(c[part][k].narrow(
                        1, axis_index(ctx.mesh, axes) * step, step))
    logits, v0 = _head(cfg, params, x, ctx)
    return _whole_logits(logits[:, 0], v0, ctx), cache


def _decode_block(cfg: ModelConfig, spec: BlockSpec, p: dict, ps: Any,
                  c: dict, x: torch.Tensor, pos: torch.Tensor,
                  ctx: Optional[ShardCtx], backend: Optional[str]
                  ) -> torch.Tensor:
    if spec.mixer != "none":
        h = rms_norm(p["norm1"], x, cfg.norm_eps)
        h, _ = _mixer(cfg, spec, p, ps, ctx, h, "decode", backend=backend,
                      cache=c["mixer"], pos=pos)
        x = x + h
    if spec.ffn == "rwkv6_cmix":
        pf, _ = _ffn_setup(cfg, spec, p, ps, ctx)
        h, _ = rwkv_cmix_decode(pf, c["ffn"],
                                rms_norm(p["norm2"], x, cfg.norm_eps))
        return x + h
    x, _ = _ffn(cfg, spec, p, x, ctx, ps)
    return x
