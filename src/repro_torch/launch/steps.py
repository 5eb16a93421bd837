"""Step builders of the port: the train, prefill and decode steps of a cell.

Counterpart of ``repro.launch.steps`` on one device.  One cell is (arch
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
:func:`batch_to` moves it to the device at the step.  The reference's
meshes, shardings and FSDP are not ported: a ``mesh`` or ``fsdp=True``
raises ``NotImplementedError`` (ROADMAP.md, queue 4).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..configs.shapes import ShapeSpec
from ..device import DeviceLike, resolve_device
from ..models import ModelConfig, decode_step, loss_fn, prefill
from ..optim import AdamWConfig, adamw_update, tree_leaves, tree_map

__all__ = ["CellPlan", "plan_cell", "batch_to"]

_NO_MESH = ("device meshes, shardings and FSDP are not ported to repro_torch "
            "yet (ROADMAP.md, queue 4); the port's steps run on one device")


@dataclass
class CellPlan:
    cfg: ModelConfig
    shape: ShapeSpec
    device: torch.device
    opt_cfg: Optional[AdamWConfig]
    step: Callable


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


def _train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, remat: str,
                device: torch.device) -> Callable:
    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for t in leaves:
            if not t.requires_grad:
                t.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = loss_fn(cfg, params, batch_to(batch, device),
                                    remat=remat)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        by_id = {id(t): g if g is not None else torch.zeros_like(t)
                 for t, g in zip(leaves, grads)}
        del grads
        grad_tree = tree_map(lambda t: by_id[id(t)], params)
        params, opt_state, om = adamw_update(params, grad_tree, opt_state,
                                             opt_cfg)
        out = {k: v.detach() for k, v in metrics.items()}
        out.update(om)
        out["loss"] = loss.detach()
        return params, opt_state, out

    return train_step


def plan_cell(cfg: ModelConfig, shape: ShapeSpec, mesh: Any = None, *,
              opt_cfg: Optional[AdamWConfig] = None, remat: str = "full",
              fsdp: bool = False, device: DeviceLike = None) -> CellPlan:
    """The cell's step on one device (module docstring)."""
    if mesh is not None or fsdp:
        raise NotImplementedError(f"plan_cell(mesh=..., fsdp=...): {_NO_MESH}")
    device = resolve_device(device)
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
