"""Step builders of the port: the train, prefill and decode steps of a cell.

Counterpart of ``repro.launch.steps``.  One cell is (arch
config x shape); :func:`plan_cell` returns the cell's step function:

* ``kind="train"``: ``step(params, opt_state, batch) -> (params, opt_state,
  metrics)``: ``loss_fn`` forward and backward (the attention layers
  through the hand-written flash forward and backward kernels on the card),
  then ``adamw_update``, which writes the new parameters and moments into
  the tensors it was given (the counterpart of the reference's donated
  buffers).  ``metrics``: ``loss``, ``nll``, ``router_aux``, ``mtp_nll``
  where the model has an MTP head, ``grad_norm`` and ``lr``, as 0-d
  tensors on the device (reading one waits for the step).
* ``kind="prefill"``: ``step(params, batch) -> (logits, cache)``.
* ``kind="decode"``: ``step(params, cache, batch, pos) -> (logits, cache)``.

A batch is a dict of numpy arrays (the data pipeline's) or tensors;
:func:`batch_to` moves it to the device at the step.

With a ``mesh`` (``launch/mesh.py``) the plan is the reference's: the rule
engine's specs for the parameters (FSDP over "data" with ``fsdp=True``),
the optimizer moments (the parameters' specs), the batch and the cache,
held in ``CellPlan.shardings`` as ``NamedSharding``s, and a ``ShardCtx``
over the mesh.  Each process runs the step on its own blocks (explicit
SPMD): ``params`` and ``opt_state`` are this rank's blocks (see
``init_params(ctx=...)``), ``batch`` (and ``pos``) the whole batch, which
the passes cut.  The train step's gradients: an FSDP leaf's is
reduce-scattered by its gather's backward, every leaf's is summed over the
dp axes its spec does not split (the loss is the dp ranks' mean, so this
is the mean of their gradients), and ``grad_norm`` is the global norm over
every rank's blocks, each block counted once.  The prefill and decode
steps return the whole batch's logits on every rank and this rank's cache
blocks.  A meshless call ignores ``fsdp``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..configs.shapes import ShapeSpec
from ..device import DeviceLike, resolve_device
from ..models import ModelConfig, ShardCtx, decode_step, loss_fn, prefill
from ..optim import AdamWConfig, adamw_update, tree_leaves, tree_map
from ..runtime.collectives import axis_group, axis_size, mesh_device
from ..runtime.sharding import (P, ShardingPolicy, batch_specs, cache_specs,
                                named, param_specs, prepare, spec_axes)
from .specs import abstract_cache, abstract_params, input_specs

__all__ = ["CellPlan", "plan_cell", "batch_to"]


@dataclass
class CellPlan:
    cfg: ModelConfig
    shape: ShapeSpec
    device: torch.device
    opt_cfg: Optional[AdamWConfig]
    step: Callable
    mesh: Any = None
    policy: Optional[ShardingPolicy] = None
    ctx: Optional[ShardCtx] = None
    #: name -> NamedSharding tree ("params", "opt", "batch", "cache")
    shardings: Dict[str, Any] = field(default_factory=dict)


def batch_to(batch: Dict[str, Any], device: torch.device) -> Dict[str,
                                                                 torch.Tensor]:
    """The data pipeline's numpy batch (or tensors) -> tensors on
    ``device``, dtypes kept (int32 tokens and labels, float32 embeds)."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        out[k] = t.to(device, non_blocking=True)
    return out


def _mk_policy(mesh, *, fsdp: bool = True) -> ShardingPolicy:
    multi = "pod" in mesh.mesh_dim_names
    policy = ShardingPolicy(
        tp_axis="model",
        dp_axes=("pod", "data") if multi else ("data",),
        fsdp_axis="data" if fsdp else None,
    )
    return prepare(policy, mesh)


def _mesh_grads(grads: list, specs: list, ctx: ShardCtx) -> torch.Tensor:
    """Sum each local gradient block over the dp axes its spec does not
    split (in place); -> the global norm, each block counted once."""
    world = axis_size(ctx.mesh, ctx.mesh.mesh_dim_names)
    total = 0
    for g, spec in zip(grads, specs):
        split = {a for e in spec for a in spec_axes(e)}
        axes = tuple(a for a in ctx.dp_axes if a not in split)
        if axes:
            dist.all_reduce(g, group=axis_group(ctx.mesh, axes))
        sq = torch.sum(torch.square(g.float()))
        copies = world // math.prod(axis_size(ctx.mesh, a) for a in split)
        total = total + (sq / copies if copies != 1 else sq)
    total = torch.as_tensor(total, dtype=torch.float32)
    dist.all_reduce(total)
    return torch.sqrt(total)


def _train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, remat: str,
                device: torch.device, ctx: Optional[ShardCtx] = None
                ) -> Callable:
    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for t in leaves:
            if not t.requires_grad:
                t.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = loss_fn(cfg, params, batch_to(batch, device),
                                    ctx=ctx, remat=remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(t)
                 for t, g in zip(leaves, grads)]
        norm = None if ctx is None else _mesh_grads(
            grads, tree_leaves(ctx.param_specs), ctx)
        by_id = {id(t): g for t, g in zip(leaves, grads)}
        del grads
        grad_tree = tree_map(lambda t: by_id[id(t)], params)
        params, opt_state, om = adamw_update(params, grad_tree, opt_state,
                                             opt_cfg, norm=norm)
        out = {k: v.detach() for k, v in metrics.items()}
        out.update(om)
        out["loss"] = loss.detach()
        return params, opt_state, out

    return train_step


def plan_cell(cfg: ModelConfig, shape: ShapeSpec, mesh: Any = None, *,
              opt_cfg: Optional[AdamWConfig] = None, remat: str = "full",
              fsdp: bool = True, device: DeviceLike = None) -> CellPlan:
    """The cell's step, on one device or over ``mesh`` (module
    docstring)."""
    if mesh is None:
        return _plan_one_device(cfg, shape, opt_cfg, remat,
                                resolve_device(device))
    device = mesh_device(mesh)
    policy = _mk_policy(mesh, fsdp=fsdp)
    pspecs = param_specs(abstract_params(cfg), policy, cfg)
    ctx = ShardCtx(mesh=mesh, dp_axes=policy.dp_axes, tp_axis=policy.tp_axis,
                   param_specs=pspecs)
    ins = input_specs(cfg, shape)
    sh = {"params": named(mesh, pspecs),
          "batch": named(mesh, batch_specs(ins["batch"], policy))}
    if shape.kind == "train":
        opt_cfg = opt_cfg or AdamWConfig()
        sh["opt"] = named(mesh, {"m": pspecs, "v": pspecs, "step": P()})
        return CellPlan(cfg, shape, device, opt_cfg,
                        _train_step(cfg, opt_cfg, remat, device, ctx),
                        mesh, policy, ctx, sh)
    if shape.kind not in ("prefill", "decode"):
        raise ValueError(f"unknown shape kind {shape.kind!r}")
    cspecs = cache_specs(abstract_cache(cfg, shape.global_batch,
                                        shape.seq_len), policy)
    sh["cache"] = named(mesh, cspecs)
    ctx = ShardCtx(mesh=mesh, dp_axes=policy.dp_axes, tp_axis=policy.tp_axis,
                   param_specs=pspecs, cache_specs=cspecs)
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            with torch.no_grad():
                return prefill(cfg, params, batch_to(batch, device), ctx=ctx)
        return CellPlan(cfg, shape, device, None, prefill_step, mesh, policy,
                        ctx, sh)

    def serve_step(params, cache, batch, pos):
        with torch.no_grad():
            return decode_step(cfg, params, cache, batch_to(batch, device),
                               torch.as_tensor(pos).to(device), ctx=ctx)
    return CellPlan(cfg, shape, device, None, serve_step, mesh, policy, ctx,
                    sh)


def _plan_one_device(cfg: ModelConfig, shape: ShapeSpec,
                     opt_cfg: Optional[AdamWConfig], remat: str,
                     device: torch.device) -> CellPlan:
    if shape.kind == "train":
        opt_cfg = opt_cfg or AdamWConfig()
        return CellPlan(cfg, shape, device, opt_cfg,
                        _train_step(cfg, opt_cfg, remat, device))
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            with torch.no_grad():
                return prefill(cfg, params, batch_to(batch, device))
        return CellPlan(cfg, shape, device, None, prefill_step)
    if shape.kind == "decode":
        def serve_step(params, cache, batch, pos):
            with torch.no_grad():
                return decode_step(cfg, params, cache,
                                   batch_to(batch, device),
                                   torch.as_tensor(pos).to(device))
        return CellPlan(cfg, shape, device, None, serve_step)
    raise ValueError(f"unknown shape kind {shape.kind!r}")
