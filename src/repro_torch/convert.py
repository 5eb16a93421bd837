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
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .algorithms.uts import Bag
from .device import DeviceLike, resolve_device

__all__ = ["bag_from_reference", "bag_to_reference",
           "image_from_reference", "image_to_reference",
           "params_from_jax", "cache_from_jax"]


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


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    """A numpy array (bfloat16 from ``ml_dtypes`` included) -> a tensor of
    the same dtype and bits on ``device``."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unstack(cfg, tree: dict, device: DeviceLike) -> dict:
    device = resolve_device(device)
    out = {}
    for key, sub in tree.items():
        if key.startswith("stage"):
            n = cfg.stages[int(key[len("stage"):])].n_periods
            out[key] = [_map(sub, lambda a, p=p: _tensor(np.asarray(a)[p],
                                                          device))
                        for p in range(n)]
        else:
            out[key] = _map(sub, lambda a: _tensor(a, device))
    return out


def params_from_jax(cfg, tree: dict, device: DeviceLike = None) -> dict:
    """The reference's ``init_params`` pytree (leaves as numpy arrays) ->
    the port's parameters: stage leaves unstacked into one dict per
    period, every leaf the same dtype and bits."""
    return _unstack(cfg, tree, device)


def cache_from_jax(cfg, tree: dict, device: DeviceLike = None) -> dict:
    """The reference's decode cache (from ``init_cache`` or ``prefill``,
    leaves as numpy arrays) -> the port's per-period cache."""
    return _unstack(cfg, tree, device)
