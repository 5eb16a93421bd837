"""Carry workload state between the reference package and the port.

The port's "weights" are its workload state: a UTS frontier (``Bag``)
and a Mariani-Silver dwell image.  The reference package holds them as
numpy uint32/int32 arrays; the port holds a frontier as int32 device
tensors with the uint32 bit pattern.  These converters move state across
bit-for-bit, so a frontier produced by one package can be expanded by
the other and the results compared.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .algorithms.uts import Bag
from .device import DeviceLike, resolve_device

__all__ = ["bag_from_reference", "bag_to_reference",
           "image_from_reference", "image_to_reference"]


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
