"""Mesh axes and differentiable collectives over ``torch.distributed``.

The port runs a mesh as explicit SPMD: one process a device, each holding
its local shards as plain tensors, with every collective written out.  A
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dimension
names are the reference's axes (``"data"``, ``"model"``, ``"pod"``).
``axis_size``, ``axis_index`` and ``axis_group`` take one axis name or a
tuple of them; a tuple is linearised with its first axis major, as a
``PartitionSpec`` entry ``("pod", "data")`` is in JAX, and its group is
made once per mesh (a collective call: every rank makes it at the same
point of the program, as SPMD code does).

The autograd functions follow Megatron's convention: the objective is the
same on every rank (replicated), so

* :func:`copy_to` (identity forward, all-reduce backward) enters a region
  whose ranks each hold part of a gradient (a column-parallel product's
  input, a parameter used on a rank's own tokens), and :func:`reduce_from`
  (all-reduce forward, identity backward) leaves it;
* :func:`gather_rep` (all-gather forward, this rank's block backward) and
  :func:`split_rep` (this rank's block forward, all-gather backward) move
  between split and replicated layouts of a replicated computation;
* :func:`fsdp_gather` (all-gather forward, reduce-scatter of the sum
  backward) is ZeRO-3's gather of a parameter: each data rank's gradient
  is its own batch's part;
* :func:`mean_rep` (all-reduce mean forward, gradient / n backward) makes
  one replicated value of a per-rank one (the loss over data ranks, the
  MoE aux loss over the model axis);
* :func:`all_to_all` sends block ``i`` of dim 0 to rank ``i``; its
  backward sends the gradients back the same way.

Every collective runs also on a group of one rank, so a world of 1
exercises the same code (and gives the same bits: a one-rank all-reduce
or all-gather copies).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["Axes", "mesh_shape", "axis_size", "axis_index", "axis_group",
           "mesh_device", "copy_to", "reduce_from", "gather_rep",
           "split_rep", "fsdp_gather", "mean_rep", "all_to_all",
           "all_gather_dim", "reduce_scatter_dim", "all_reduce"]

Axes = Union[str, Tuple[str, ...], None]


def _axes(axes: Axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of anything with a dict
    ``shape``, such as the rule engine's stand-in meshes)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axes: Axes) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in _axes(axes))


def axis_index(mesh, axes: Axes) -> int:
    """This rank's index along ``axes`` (first axis major)."""
    shape = mesh_shape(mesh)
    ix = 0
    for a in _axes(axes):
        ix = ix * shape[a] + mesh.get_local_rank(a)
    return ix


def axis_group(mesh, axes: Axes):
    """The process group of this rank's line along ``axes``, its ranks in
    ``axis_index`` order."""
    axes = _axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_repro_groups", {})
    if axes not in cache:
        names = list(mesh.mesh_dim_names)
        grid = mesh.mesh.permute(
            [names.index(a) for a in names if a not in axes]
            + [names.index(a) for a in axes])
        lines = grid.reshape(-1, math.prod(grid.shape[len(names)
                                                      - len(axes):]))
        # every rank makes every line's group, in the same order
        mine, _ = dist.new_subgroups_by_enumeration(
            [[int(r) for r in line] for line in lines])
        cache[axes] = mine
    return cache[axes]


def mesh_device(mesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


#: the one-tensor all-gather and reduce-scatter (renamed in newer torch)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _size(group) -> int:
    return dist.get_world_size(group)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A reduced copy of ``x`` (``x`` itself is left alone)."""
    y = x.clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim``, in rank
    order (contiguous: a gathered weight has the layout of a whole one, so
    its products run as the meshless ones do).  NCCL gathers the blocks
    whole, one after another; along another dim than the first, one copy
    then interleaves them (none for a group of one)."""
    n = _size(group)
    dim = dim % x.dim()
    xs = x.contiguous()
    out = xs.new_empty((n * xs.shape[0],) + tuple(xs.shape[1:]))
    _ALL_GATHER(out, xs, group=group)
    out = out.unflatten(0, (n, xs.shape[0]))
    return out.movedim(0, dim).flatten(dim, dim + 1).contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block along ``dim`` of the group's sum of ``x`` (along
    another dim than the first, one copy first puts each rank's block
    whole; none for a group of one)."""
    n = _size(group)
    dim = dim % x.dim()
    xs = x.unflatten(dim, (n, x.shape[dim] // n)).movedim(dim, 0)
    xs = xs.contiguous()
    out = xs.new_empty(tuple(xs.shape[1:]))
    _REDUCE_SCATTER(out, xs.flatten(0, 1), group=group)
    return out


def _block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    k = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * k, k).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.group), None, None


class _SplitRep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


class _MeanRep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = _size(group)
        return all_reduce(x, group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def gather_rep(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _GatherRep.apply(x, dim, group)


def split_rep(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _SplitRep.apply(x, dim, group)


def fsdp_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _FSDPGather.apply(x, dim, group)


def mean_rep(x: torch.Tensor, group) -> torch.Tensor:
    return _MeanRep.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block ``i`` of ``x``'s dim 0 (``x.shape[0]`` = group size) to rank
    ``i``; the result's block ``j`` came from rank ``j``."""
    return _AllToAll.apply(x, group)
