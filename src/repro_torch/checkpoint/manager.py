"""Checkpoint save/restore (PyTorch), the reference's on-disk format.

Counterpart of ``repro.checkpoint.manager``.  Layout per step:

    <dir>/step_<n>/
        manifest.json       leaf names, shapes, dtypes, spec strings
        arrays.npz          one entry per leaf (host copies)

Leaf names join the path's keys with ``::`` (dict keys in sorted order,
list and tuple positions as their index), as ``jax.tree_util``'s paths do,
so a tree of the reference's structure gets the reference's names.  npz
has no bfloat16: such a leaf is written as its ``uint16`` bits with the
tag ``"bfloat16"`` and read back with ``Tensor.view(torch.bfloat16)`` (the
reference reads it through ``ml_dtypes``, a JAX dependency the port does
not use).  Saves are atomic (a ``.tmp`` directory renamed into place) and
optionally asynchronous: :meth:`CheckpointManager.save` copies every leaf
to host memory before it returns (the caller may update its tensors in
place at the next step) and writes in a background thread; ``keep`` bounds
the checkpoints kept.  :func:`restore_pytree` places each leaf on the
device of the target's leaf (or on ``device``); with ``shardings`` (a tree
of ``runtime.sharding.NamedSharding``, the target's structure) it keeps
only this rank's block of each leaf under its spec, on the mesh's device:
the reference's re-sharding on restore, topology-free (a checkpoint holds
whole arrays; any mesh restores it).

The training driver (``repro_torch.launch.train``) saves its parameters
and optimizer state in the reference's stacked layout
(``convert.params_to_jax``, ``convert.opt_state_to_jax``), so a checkpoint
written by either package restores in the other.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..convert import BF16Bits, to_host
from ..device import DeviceLike
from ..runtime.collectives import mesh_device
from ..runtime.sharding import NamedSharding, shard_local

__all__ = ["CheckpointManager", "save_pytree", "restore_pytree",
           "latest_step"]

_SEP = "::"


def _flatten_with_names(tree: Any, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    if isinstance(tree, NamedSharding):
        return [(_SEP.join(prefix), tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten_with_names(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _flatten_with_names(t, prefix + (str(i),))]
    return [(_SEP.join(prefix), tree)]


def _unflatten_like(target: Any, leaves: Dict[str, Any],
                    prefix: Tuple[str, ...] = ()) -> Any:
    if isinstance(target, dict):
        return {k: _unflatten_like(v, leaves, prefix + (str(k),))
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_unflatten_like(t, leaves, prefix + (str(i),))
                            for i, t in enumerate(target))
    return leaves[_SEP.join(prefix)]


def _npz_entry(arr: np.ndarray) -> Tuple[np.ndarray, str]:
    """(what npz stores, the manifest's dtype tag)."""
    if isinstance(arr, BF16Bits):
        return arr.view(np.ndarray), "bfloat16"
    tag = str(arr.dtype)
    if tag == "bfloat16":
        return arr.view(np.uint16), tag
    return arr, tag


def save_pytree(tree: Any, directory: str, *, specs: Any = None) -> None:
    os.makedirs(directory + ".tmp", exist_ok=True)
    arrays = {}
    manifest: Dict[str, Any] = {"leaves": {}, "version": 1,
                                "time": time.time()}
    spec_named = dict(_flatten_with_names(specs)) if specs is not None \
        else {}
    for name, leaf in _flatten_with_names(tree):
        arr, tag = _npz_entry(to_host(leaf))
        arrays[name] = arr
        manifest["leaves"][name] = {
            "shape": list(arr.shape),
            "dtype": tag,
            "spec": str(spec_named.get(name, "")),
        }
    np.savez(os.path.join(directory + ".tmp", "arrays.npz"), **arrays)
    with open(os.path.join(directory + ".tmp", "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.isdir(directory):
        shutil.rmtree(directory)
    os.rename(directory + ".tmp", directory)


def restore_pytree(target: Any, directory: str, *, shardings: Any = None,
                   device: DeviceLike = None) -> Any:
    """Restore into the structure of ``target`` (names and shapes must
    match): tensors of the saved dtypes, each on ``device`` or else on the
    device of the target's leaf (the CPU for a non-tensor leaf); with
    ``shardings``, each leaf this rank's block under its spec, on
    ``device`` or else the mesh's device."""
    shard_named = dict(_flatten_with_names(shardings)) \
        if shardings is not None else {}
    data = np.load(os.path.join(directory, "arrays.npz"))
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    for name, leaf in _flatten_with_names(target):
        if name not in manifest["leaves"]:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = data[name]
        if tuple(arr.shape) != tuple(np.shape(leaf)):
            raise ValueError(
                f"{name}: checkpoint shape {arr.shape} != {np.shape(leaf)}")
        if manifest["leaves"][name]["dtype"] == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                 .copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        sharding = shard_named.get(name)
        if sharding is not None:
            where = device if device is not None else \
                mesh_device(sharding.mesh)
            leaves[name] = shard_local(t, sharding.spec, sharding.mesh).to(
                where, copy=True)
            continue
        where = device if device is not None else (
            leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
        leaves[name] = t.to(where)
    return _unflatten_like(target, leaves)


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(root)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _host_tree(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(t) for t in tree)
    return to_host(tree)


class CheckpointManager:
    """Async, bounded-retention checkpointing for the train loop."""

    def __init__(self, root: str, *, keep: int = 3, async_save: bool = True):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(root, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step}")

    def save(self, step: int, tree: Any, *, specs: Any = None) -> None:
        self.wait()
        # snapshot to host *synchronously* (the caller updates its tensors
        # in place at the next step), then write in the background
        host_tree = _host_tree(tree)

        def work():
            try:
                save_pytree(host_tree, self._dir(step), specs=specs)
                self._gc()
            except BaseException as e:  # raised again by wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self.wait()

    def wait(self) -> None:
        """Join the background write; raise what it raised, if anything."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(s for s in (
            int(d.split("_")[1]) for d in os.listdir(self.root)
            if d.startswith("step_") and not d.endswith(".tmp")))
        for s in steps[:-self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    def restore_latest(self, target: Any, *, shardings: Any = None,
                       device: DeviceLike = None):
        self.wait()
        step = latest_step(self.root)
        if step is None:
            return None, None
        return step, restore_pytree(target, self._dir(step),
                                    shardings=shardings, device=device)
