"""Carry workload state and model weights between the reference and the port.

The irregular algorithms' "weights" are their workload state: a UTS
frontier (``Bag``) and a Mariani-Silver dwell image.  The reference
package holds them as numpy uint32/int32 arrays; the port holds a
frontier as int32 device tensors with the uint32 bit pattern.  The model
stack's weights and KV caches are pytrees of arrays in the reference,
with every stage's leaves stacked on a leading ``n_periods`` axis (the
``jax.vmap`` of its init); the port keeps one dict per period in a list.
These converters move state across bit for bit (bfloat16 included), so
both packages can run the same weights and the results be compared.

The way back (:func:`params_to_jax`, :func:`opt_state_to_jax`) stacks each
stage's periods again into the reference's leading ``n_periods`` axis and
returns host numpy arrays; numpy has no bfloat16 without ``ml_dtypes`` (a
JAX dependency the port does not import), so a bfloat16 leaf comes back as
:class:`BF16Bits`, its ``uint16`` bits, which the checkpoint manager tags
``"bfloat16"`` and which ``.view(ml_dtypes.bfloat16)`` turns into the
reference's array.  The training driver saves its checkpoints through
these, in the reference's layout and names.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .algorithms.uts import Bag
from .device import DeviceLike, resolve_device

__all__ = ["bag_from_reference", "bag_to_reference",
           "image_from_reference", "image_to_reference",
           "params_from_jax", "cache_from_jax", "params_to_jax",
           "opt_state_from_jax", "opt_state_to_jax", "BF16Bits", "to_host"]


def bag_from_reference(digests_u32: np.ndarray, depths: np.ndarray,
                       device: DeviceLike = None) -> Bag:
    """[5, n] uint32 digests + [n] int32 depths -> the port's ``Bag``."""
    digests_u32 = np.asarray(digests_u32)
    if digests_u32.dtype != np.uint32 or digests_u32.ndim != 2 or \
            digests_u32.shape[0] != 5:
        raise ValueError(
            f"digests must be [5, n] uint32, got {digests_u32.shape} "
            f"{digests_u32.dtype}")
    depths = np.asarray(depths, np.int32)
    if depths.shape != (digests_u32.shape[1],):
        raise ValueError(f"depths must be [{digests_u32.shape[1]}], "
                         f"got {depths.shape}")
    device = resolve_device(device)
    dig = np.ascontiguousarray(digests_u32).view(np.int32)
    return Bag(torch.from_numpy(dig.copy()).to(device),
               torch.from_numpy(depths.copy()).to(device))


def bag_to_reference(bag: Bag) -> Tuple[np.ndarray, np.ndarray]:
    """The port's ``Bag`` -> ([5, n] uint32 digests, [n] int32 depths)."""
    dig = bag.digests.contiguous().cpu().numpy().view(np.uint32)
    return dig, bag.depths.cpu().numpy().astype(np.int32, copy=False)


def image_to_reference(image) -> np.ndarray:
    """A dwell image (tensor or array) -> numpy int32 [H, W]."""
    if isinstance(image, torch.Tensor):
        image = image.cpu().numpy()
    image = np.asarray(image)
    if image.ndim != 2:
        raise ValueError(f"a dwell image is [H, W], got {image.shape}")
    return image.astype(np.int32, copy=False)


def image_from_reference(image: np.ndarray,
                         device: DeviceLike = None) -> torch.Tensor:
    """A numpy dwell image -> int32 tensor on ``device``."""
    return torch.from_numpy(image_to_reference(image).copy()).to(
        resolve_device(device))


class BF16Bits(np.ndarray):
    """A host copy of a bfloat16 tensor: its ``uint16`` bits, marked as
    bfloat16 (numpy has no bfloat16 of its own)."""

    def __new__(cls, bits: np.ndarray) -> "BF16Bits":
        return np.asarray(bits, np.uint16).view(cls)


def to_host(leaf: Any) -> np.ndarray:
    """A tensor (any device), array or scalar -> a host numpy array with
    the same bits; a bfloat16 tensor -> :class:`BF16Bits`."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        # a copy, also of a CPU tensor, whose numpy() would share its memory
        t = t.to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return BF16Bits(t.view(torch.int16).numpy().view(np.uint16))
        return t.numpy()
    if isinstance(leaf, np.ndarray):
        return leaf
    return np.asarray(leaf)


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    """A tensor, a numpy array (bfloat16 from ``ml_dtypes`` or as
    :class:`BF16Bits` included) -> a tensor of the same dtype and bits on
    ``device``."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device)
    if isinstance(a, BF16Bits):
        bits = np.array(a.view(np.ndarray), order="C")
        return torch.from_numpy(bits.view(np.int16)).view(
            torch.bfloat16).to(device)
    a = np.array(a, order="C")     # a copy; 0-d stays 0-d
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _period(a: Any, p: int) -> Any:
    """Period ``p`` of a stacked leaf (tensor, numpy or JAX array)."""
    return a[p] if isinstance(a, (torch.Tensor, np.ndarray)) \
        else np.asarray(a)[p]


def _unstack(cfg, tree: dict, device: DeviceLike) -> dict:
    device = resolve_device(device)
    out = {}
    for key, sub in tree.items():
        if key.startswith("stage"):
            n = cfg.stages[int(key[len("stage"):])].n_periods
            out[key] = [_map(sub, lambda a, p=p: _tensor(_period(a, p),
                                                          device))
                        for p in range(n)]
        else:
            out[key] = _map(sub, lambda a: _tensor(a, device))
    return out


def _stack(periods: list) -> Any:
    """One dict per period -> one dict of leaves stacked on a new axis 0."""
    first = periods[0]
    if isinstance(first, dict):
        return {k: _stack([p[k] for p in periods]) for k in first}
    return to_host(torch.stack([t.detach() for t in periods]))


def params_to_jax(cfg, params: dict) -> dict:
    """The port's parameters -> the reference's pytree as host numpy arrays
    (bfloat16 leaves as :class:`BF16Bits`): each stage's periods stacked on
    a leading ``n_periods`` axis, every leaf the same dtype and bits."""
    del cfg  # the stage lists carry their own lengths
    return {k: (_stack(v) if k.startswith("stage") else _map(v, to_host))
            for k, v in params.items()}


def opt_state_to_jax(cfg, state: dict) -> dict:
    """The port's AdamW state ``{"m", "v", "step"}`` -> the reference's
    (moments stacked as :func:`params_to_jax` stacks parameters)."""
    return {"m": params_to_jax(cfg, state["m"]),
            "v": params_to_jax(cfg, state["v"]),
            "step": to_host(state["step"])}


def opt_state_from_jax(cfg, tree: dict, device: DeviceLike = None) -> dict:
    """The reference's ``init_opt_state`` / ``adamw_update`` state (leaves
    as arrays) -> the port's, moments unstacked per period."""
    device = resolve_device(device)
    return {"m": _unstack(cfg, tree["m"], device),
            "v": _unstack(cfg, tree["v"], device),
            "step": _tensor(tree["step"], device)}


def params_from_jax(cfg, tree: dict, device: DeviceLike = None) -> dict:
    """The reference's ``init_params`` pytree (leaves as numpy arrays) ->
    the port's parameters: stage leaves unstacked into one dict per
    period, every leaf the same dtype and bits."""
    return _unstack(cfg, tree, device)


def cache_from_jax(cfg, tree: dict, device: DeviceLike = None) -> dict:
    """The reference's decode cache (from ``init_cache`` or ``prefill``,
    leaves as numpy arrays) -> the port's per-period cache."""
    return _unstack(cfg, tree, device)
