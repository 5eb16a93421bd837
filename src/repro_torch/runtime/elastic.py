"""Elastic data parallelism: shrink/grow the mesh, re-shard, resume (PyTorch).

Counterpart of ``repro.runtime.elastic``.  ``FailureInjector``,
``rescale_batch_schedule`` and ``ElasticRunner`` are the reference's; a
"mesh" is whatever ``make_mesh`` returns.  :func:`reshard_tree` moves a
tree's tensors to a device: the port trains on one card, a world of size
1, so re-placing state means moving it there (a sharding across cards is
ROADMAP.md's queue 4).  On a failure the runner restores the latest
checkpoint into host tensors (``restore_latest`` of the port's manager)
and replays the batches from the restored step.

The FaaS lesson transplanted to pods (DESIGN.md §2): workers are
stateless executors of (params, batch) -> grads; all durable state is
(checkpoint, data cursor).  Losing a pod therefore reduces to:

    1. detect (health callback / collective timeout),
    2. rebuild the mesh without the lost slice,
    3. re-place state under the new sharding (host-RAM path via the
       checkpoint manager, or live re-device_put when survivors hold a
       full copy — i.e. pure-DP axes),
    4. rescale per-host batch so the global batch is invariant,
    5. resume from the last committed step.

``ElasticRunner`` drives that loop around a step function; failures are
injected by tests through ``FailureInjector`` (the single-process stand-
in for real preemptions).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from ..convert import to_host
from ..device import DeviceLike, resolve_device

__all__ = ["FailureInjector", "ElasticRunner", "reshard_tree",
           "rescale_batch_schedule"]


class FailureInjector:
    """Deterministic failure schedule: {step: n_devices_lost}."""

    def __init__(self, schedule: Optional[dict] = None):
        self.schedule = dict(schedule or {})
        self.log: List[Tuple[int, int]] = []

    def check(self, step: int) -> int:
        lost = self.schedule.pop(step, 0)
        if lost:
            self.log.append((step, lost))
        return lost


def reshard_tree(tree: Any, device: DeviceLike = None) -> Any:
    """Move every tensor (or array) of a nested dict/list tree to
    ``device``: one card, a world of size 1, holds the whole state."""
    device = resolve_device(device)

    def move(x):
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(move(v) for v in x)
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        return x.to(device)
    return move(tree)


def rescale_batch_schedule(global_batch: int, n_data_shards: int) -> int:
    """Per-shard batch after an elastic resize; global batch invariant.
    Raises if the new topology cannot hold the global batch evenly —
    the caller then pads or drops (we raise: silent resizing of the
    effective batch corrupts training-curve comparability)."""
    if global_batch % n_data_shards:
        raise ValueError(
            f"global_batch {global_batch} not divisible by "
            f"{n_data_shards} surviving data shards")
    return global_batch // n_data_shards


def _host(tree: Any) -> Any:
    """A restore target shaped like ``tree``: host arrays of its leaves."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return to_host(tree)


@dataclass
class ElasticRunner:
    """Drives step_fn under failure injection with checkpoint/restart.

    make_state:   (mesh) -> state          (fresh init, sharded)
    make_step:    (mesh) -> step_fn        (re-jit after resize)
    save/restore: checkpoint manager hooks
    meshes:       ladder of (n_data,...) meshes to fall back through
    """

    make_mesh: Callable[[int], Any]         # n_data -> mesh
    make_state: Callable[[Any], Any]        # mesh -> state
    make_step: Callable[[Any], Any]         # mesh -> step_fn(state, batch)
    data_shards: int
    injector: FailureInjector = field(default_factory=FailureInjector)
    checkpoint_every: int = 10
    manager: Any = None                     # CheckpointManager-compatible
    events: List[dict] = field(default_factory=list)

    def run(self, batches, n_steps: int) -> Any:
        n_data = self.data_shards
        mesh = self.make_mesh(n_data)
        state = self.make_state(mesh)
        step_fn = self.make_step(mesh)
        last_ckpt = 0
        it = iter(batches)
        step = 0
        while step < n_steps:
            lost = self.injector.check(step)
            if lost:
                # -- failure: shrink, restore, re-jit, replay ----------
                n_data = max(1, n_data - lost)
                mesh = self.make_mesh(n_data)
                step_fn = self.make_step(mesh)
                restored_step = last_ckpt
                if self.manager is not None:
                    s, tree = self.manager.restore_latest(
                        _host(state))
                    if tree is not None:
                        state = tree
                        restored_step = s
                self.events.append({
                    "type": "resize", "step": step, "lost": lost,
                    "n_data": n_data, "resume_from": restored_step,
                })
                step = restored_step
                it = iter(batches)  # deterministic source: reseek
                for _ in range(step):
                    next(it)
                continue
            batch = next(it)
            state = step_fn(state, batch)
            step += 1
            if self.manager is not None and step % self.checkpoint_every == 0:
                self.manager.save(step, state)
                last_ckpt = step
        if self.manager is not None:
            self.manager.wait()
        return state
