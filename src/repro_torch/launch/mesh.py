"""Device meshes of the port (counterpart of ``repro.launch.mesh``).

Functions, never module constants: importing this module touches no
process group.  A mesh is a ``torch.distributed.device_mesh.DeviceMesh``
with the reference's axis names, ``("data", "model")`` or, for multi-pod,
``("pod", "data", "model")``; the port runs one process a device and
each rank's collectives over the mesh's per-axis groups
(``runtime/collectives.py``).

* :func:`make_host_mesh` is a small mesh over the caller's world.  A world
  of 1 with no process group yet gets one here, over an in-process
  ``HashStore`` (no network): ``nccl`` for the card, ``gloo`` for
  ``device="cpu"``.  A larger world must have initialised its process
  group (one process a device, as ``torch.distributed`` launchers do), and
  ``data * model`` must equal its size.
* :func:`make_production_mesh` is the reference's TPU v5e pod layout:
  16 x 16 = 256 devices, "data" x "model", or 2 x 16 x 16 = 512 with an
  outer "pod" axis (a pure data-parallel axis).  It needs a world of that
  size and raises on any other, as the reference does without the devices.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike, resolve_device
from ..runtime.collectives import (axis_group, axis_index, axis_size,
                                   mesh_device, mesh_shape)

__all__ = ["make_production_mesh", "make_host_mesh", "axis_size",
           "axis_index", "axis_group", "mesh_device", "mesh_shape"]


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
          device: DeviceLike) -> DeviceMesh:
    dev = resolve_device(device)
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"a {'x'.join(map(str, shape))} mesh needs a world of {n} "
                "processes: initialise torch.distributed's process group "
                "(one process a device) before making it")
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh {dict(zip(axes, shape))} has {n} devices; "
                         f"the world has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = _mesh(shape, axes, device)
    if multi_pod:
        axis_group(mesh, ("pod", "data"))   # every rank makes it, now
    return mesh


def make_host_mesh(data: int = 1, model: int = 1, *, pods: int = 1,
                   device: DeviceLike = None) -> DeviceMesh:
    """Small ("data", "model") mesh over the caller's world (tests, one
    card); ``pods > 1`` adds the outer "pod" axis."""
    if pods == 1:
        return _mesh((data, model), ("data", "model"), device)
    mesh = _mesh((pods, data, model), ("pod", "data", "model"), device)
    axis_group(mesh, ("pod", "data"))
    return mesh
