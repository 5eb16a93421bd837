"""Sharding rule engine: logical param/cache/batch layouts -> mesh specs.

Counterpart of ``repro.runtime.sharding``, rule for rule.  Tensor-parallel
("model" axis) assignment is *name-based* with divisibility checks;
whenever an axis does not divide the mesh axis the rule degrades to
replication and the degradation is recorded (gemma3-1b's 4 heads cannot
be 16-way sharded, so only d_ff and the vocabulary shard).  FSDP ("data"
axis) is then layered on the largest remaining unsharded dim of large
leaves: ZeRO-3 at-rest sharding, which the port's steps gather at use.
Attention projections are sharded only if the *head count* divides the
axis, so a [d, H*hd] shard never splits a head.

Two layouts.  The reference's rules see a *stacked* tree: each stage's
leaves carry a leading ``n_periods`` axis (the period scan), which the
rules skip.  The port keeps a stage as a list of periods (unstacked); given
such a tree, :func:`param_specs` and :func:`cache_specs` decide each leaf
as its stacked counterpart (the same path, the stacked shape and size) and
return, for every period, that spec without its leading ``None``.

The port's :class:`PartitionSpec` prints as JAX's does
(``PartitionSpec(None, 'model')``): checkpoint manifests store that
string, and manifests cross packages.  :func:`shard_local` cuts this
rank's block of a whole tensor by its spec, :func:`gather_full` puts the
whole back together from the ranks' blocks (a collective).
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Any, Iterator, List, Optional, Tuple

import torch

from .collectives import (all_gather_dim, axis_group, axis_index, axis_size,
                          mesh_shape)

__all__ = ["PartitionSpec", "P", "NamedSharding", "ShardingPolicy",
           "param_specs", "batch_specs", "cache_specs", "prepare", "named",
           "zero_extend", "shard_local", "gather_full", "stack_specs",
           "spec_axes", "is_spec"]


class PartitionSpec:
    """One entry per dim: None, an axis name, or a tuple of axis names
    (linearised first axis major).  Equal, hashable and printed as JAX's."""

    __slots__ = ("_parts",)

    def __init__(self, *parts: Any) -> None:
        self._parts = tuple(_entry(p) for p in parts)

    def __iter__(self) -> Iterator:
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        return isinstance(other, PartitionSpec) and self._parts == \
            other._parts

    def __hash__(self) -> int:
        return hash(self._parts)

    def __repr__(self) -> str:       # JAX's: the parts as a tuple
        return "PartitionSpec" + repr(self._parts)


P = PartitionSpec


def _entry(p: Any) -> Any:
    """JAX's canonical entry: a one-axis tuple is that axis."""
    if isinstance(p, (list, tuple)):
        p = tuple(p)
        return p[0] if len(p) == 1 else (p or None)
    return p


def is_spec(x: Any) -> bool:
    return isinstance(x, PartitionSpec)


@dataclass(frozen=True)
class NamedSharding:
    """A spec bound to its mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: PartitionSpec


def spec_axes(entry: Any) -> Tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass
class ShardingPolicy:
    tp_axis: str = "model"
    dp_axes: Tuple[str, ...] = ("data",)
    fsdp_axis: Optional[str] = "data"   # None disables FSDP
    fsdp_min_size: int = 1 << 20        # leaves below this stay unsharded
    #: filled by param_specs: paths whose TP rule degraded to replication
    degraded: List[str] = field(default_factory=list)


def _head_count(cfg, path: str) -> Optional[int]:
    """Heads relevant to a projection (for head-boundary sharding)."""
    if cfg is None:
        return None
    if re.search(r"mixer/w[q]", path) or "wq_b" in path:
        if cfg.mla is not None:
            return cfg.mla.n_heads
        return cfg.attention.n_heads if cfg.attention else None
    if re.search(r"mixer/w[kv]\b", path) or "wkv_b" in path:
        if cfg.mla is not None:
            return cfg.mla.n_heads
        return cfg.attention.n_kv_heads if cfg.attention else None
    if "mixer/wo" in path:
        if cfg.mla is not None:
            return cfg.mla.n_heads
        return cfg.attention.n_heads if cfg.attention else None
    return None


def _tp_rule(path: str, shape: Tuple[int, ...], tp: int,
             cfg) -> Optional[List[Optional[str]]]:
    """Spec template over the *logical* (unstacked) dims, entries "tp"
    where the model axis goes.  None = no TP opinion (replicate)."""
    nd = len(shape)

    def out_col():   # shard the last (output) dim
        t: List[Optional[str]] = [None] * nd
        t[-1] = "tp"
        return t

    def in_row():    # shard the second-to-last (input) dim
        t: List[Optional[str]] = [None] * nd
        t[-2] = "tp"
        return t

    # attention projections: head-boundary aware
    if re.search(r"mixer/(wq|wk|wv|wq_b|wkv_b)/w$", path):
        heads = _head_count(cfg, path)
        if heads is not None and heads % tp == 0 and shape[-1] % tp == 0:
            return out_col()
        return None
    if re.search(r"mixer/wo/w$", path):
        heads = _head_count(cfg, path)
        if heads is not None and heads % tp == 0 and shape[-2] % tp == 0:
            return in_row()
        return None
    if re.search(r"mixer/(wq_a|wkv_a)/w$", path):
        return None  # small latent projections: replicated
    # dense MLP
    if re.search(r"ffn/(gate|up)/w$", path) and shape[-1] % tp == 0:
        return out_col()
    if re.search(r"ffn/down/w$", path) and shape[-2] % tp == 0:
        return in_row()
    # MoE expert stacks [E, d, f] / shared-expert fused MLP
    if re.search(r"ffn/(gate|up|down)$", path) and nd >= 3:
        if shape[-3] % tp == 0:
            t: List[Optional[str]] = [None] * nd
            t[-3] = "tp"
            return t
        return None
    if re.search(r"ffn/shared/(gate|up)/w$", path) and shape[-1] % tp == 0:
        return out_col()
    if re.search(r"ffn/shared/down/w$", path) and shape[-2] % tp == 0:
        return in_row()
    if "router" in path:
        return [None] * nd
    # mamba (d_inner sharded)
    if re.search(r"mixer/in_proj/w$", path) and shape[-1] % (2 * tp) == 0:
        return out_col()
    if re.search(r"mixer/(conv_w)$", path) and shape[-1] % tp == 0:
        return out_col()
    if re.search(r"mixer/(conv_b|D)$", path) and shape[-1] % tp == 0:
        return out_col()
    if re.search(r"mixer/dt_bias$", path) and shape[-1] % tp == 0:
        return out_col()
    if re.search(r"mixer/(x_proj|out_proj)/w$", path) and shape[-2] % tp == 0:
        return in_row()
    if re.search(r"mixer/A_log$", path) and shape[-2] % tp == 0:
        return in_row()
    if re.search(r"mixer/dt_proj/w$", path) and shape[-1] % tp == 0:
        return out_col()
    # rwkv6 (d sharded on projection outputs, head-aligned)
    if re.search(r"mixer/(wr|wk|wv|wg)/w$", path) and shape[-1] % tp == 0:
        return out_col()
    if re.search(r"mixer/w_lora_b/w$", path) and shape[-1] % tp == 0:
        return out_col()
    if re.search(r"mixer/wo/w$", path) and shape[-2] % tp == 0:
        return in_row()
    if re.search(r"mixer/u$", path) and shape[-2] % tp == 0:
        return in_row()
    # embeddings / head: vocab-sharded
    if path.endswith("embed/table") and shape[-2] % tp == 0:
        return in_row()
    if path.endswith("lm_head/w") and shape[-1] % tp == 0:
        return out_col()
    if "mtp/combine" in path:
        return None
    return None


def _walk(tree: Any, fn, path: Tuple[str, ...] = ()) -> Any:
    """``fn(path string, shape, stacked periods or 0)`` over a stacked or
    unstacked (per-period lists under ``stageN``) tree, in sorted-key order
    (the reference's tree order); a list under a stage returns one spec
    per period, the stacked spec without its leading entry."""
    if isinstance(tree, dict):
        out = {k: _walk(tree[k], fn, path + (str(k),)) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    pstr = "/".join(path)
    if isinstance(tree, (list, tuple)) and len(path) == 1 and \
            pstr.startswith("stage"):
        n = len(tree)
        one = _walk_stacked(tree[0], fn, path, n)
        return [one for _ in range(n)]
    stacked = int(pstr.startswith("stage"))
    return fn(pstr, tuple(tree.shape), stacked)


def _walk_stacked(tree: Any, fn, path: Tuple[str, ...], n: int) -> Any:
    if isinstance(tree, dict):
        out = {k: _walk_stacked(tree[k], fn, path + (str(k),), n)
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    spec = fn("/".join(path), (n,) + tuple(tree.shape), 1)
    return P(*list(spec)[1:])


def param_specs(shapes: Any, policy: ShardingPolicy, cfg=None) -> Any:
    """Map a tree of shaped leaves (tensors, meta tensors, anything with a
    ``shape``) to PartitionSpecs; the stacked or the port's layout."""
    tp_name = policy.tp_axis

    def leaf_spec(pstr: str, shape: Tuple[int, ...], stacked: int):
        logical = shape[stacked:]
        tpl = _tp_rule(pstr, logical, policy._tp_size, cfg)
        if tpl is None:
            if any(k in pstr for k in ("mixer/", "ffn/", "embed", "lm_head")) \
                    and len(logical) >= 2:
                policy.degraded.append(pstr)
            tpl = [None] * len(logical)
        spec: List[Any] = [None] * stacked + [
            tp_name if t == "tp" else None for t in tpl]
        # FSDP: largest remaining unsharded dim of large leaves
        if policy.fsdp_axis and math.prod(shape) >= policy.fsdp_min_size:
            cands = [i for i in range(stacked, len(shape))
                     if spec[i] is None
                     and shape[i] % policy._fsdp_size == 0]
            if cands:
                best = max(cands, key=lambda i: shape[i])
                spec[best] = policy.fsdp_axis
        return P(*spec)

    return _walk(shapes, leaf_spec)


def batch_specs(shapes: Any, policy: ShardingPolicy) -> Any:
    """Batch dims shard over all dp axes when divisible, else replicate."""
    def leaf_spec(pstr, shape, stacked):
        nd = len(shape)
        b = shape[0] if nd else 1
        if b % policy._dp_size == 0:
            return P(policy.dp_axes, *([None] * (nd - 1)))
        return P(*([None] * nd))

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return leaf_spec("", tuple(tree.shape), 0)
    return walk(shapes)


def cache_specs(shapes: Any, policy: ShardingPolicy) -> Any:
    """Decode caches: [L, B, S, (H, hd)] layout rules.

    - batch (dim 1) over dp when divisible; else the sequence dim of KV
      caches over dp (long_500k's B=1 case);
    - KV head dim (dim 3 of 5-D caches) over tp when divisible, which
      keeps decode attention head-parallel.
    """
    def leaf_spec(pstr: str, shape: Tuple[int, ...], stacked: int):
        nd = len(shape)
        spec: List[Any] = [None] * nd
        kv_like = ("mixer/k" in pstr or "mixer/v" in pstr
                   or "c_kv" in pstr or "k_pe" in pstr)
        dp = policy.dp_axes if len(policy.dp_axes) > 1 \
            else policy.dp_axes[0]
        if nd >= 2 and shape[1] % policy._dp_size == 0:
            spec[1] = dp
        elif kv_like and nd >= 3 and shape[2] % policy._dp_size == 0:
            spec[2] = dp
        if kv_like and nd == 5 and shape[3] % policy._tp_size == 0:
            spec[3] = policy.tp_axis
        return P(*spec)
    return _walk(shapes, leaf_spec)


def prepare(policy: ShardingPolicy, mesh) -> ShardingPolicy:
    """Bind mesh axis sizes (kept off the dataclass's fields)."""
    shape = mesh_shape(mesh)
    policy._tp_size = shape[policy.tp_axis]
    policy._dp_size = 1
    for a in policy.dp_axes:
        policy._dp_size *= shape[a]
    policy._fsdp_size = shape[policy.fsdp_axis] if policy.fsdp_axis else 1
    return policy


def _map_specs(fn, specs: Any) -> Any:
    if is_spec(specs):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(_map_specs(fn, v) for v in specs)
    return specs


def named(mesh, specs: Any) -> Any:
    return _map_specs(lambda s: NamedSharding(mesh, s), specs)


def stack_specs(specs: Any) -> Any:
    """The port's per-period spec lists -> the stacked layout's specs (a
    leading ``None`` for the period axis)."""
    return {k: (_map_specs(lambda s: P(None, *s), v[0])
                if isinstance(v, list) else v)
            for k, v in specs.items()}


def zero_extend(spec: PartitionSpec, shape: Tuple[int, ...], axis: str,
                size: int) -> PartitionSpec:
    """ZeRO-1: extend a param spec with ``axis`` on the first dim that is
    unsharded and divisible (optimizer-moment sharding)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (p, s) in enumerate(zip(parts, shape)):
        if p is None and s % size == 0:
            parts[i] = axis
            return P(*parts)
    return spec


def shard_local(full: torch.Tensor, spec: PartitionSpec, mesh
                ) -> torch.Tensor:
    """This rank's block of the whole tensor ``full`` under ``spec`` (a
    view where the cut allows it)."""
    out = full
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if not axes:
            continue
        n = axis_size(mesh, axes)
        k = full.shape[dim] // n
        if k * n != full.shape[dim]:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"divide over {axes} ({n})")
        out = out.narrow(dim, axis_index(mesh, axes) * k, k)
    return out


@torch.no_grad()
def gather_full(local: torch.Tensor, spec: PartitionSpec, mesh
                ) -> torch.Tensor:
    """The whole tensor from every rank's block ``local`` under ``spec``
    (the inverse of :func:`shard_local`; a collective over the axes the
    spec names; no gradient)."""
    out = local.detach()
    for dim, entry in enumerate(spec):
        axes = spec_axes(entry)
        if axes:
            out = all_gather_dim(out, dim, axis_group(mesh, axes))
    return out
