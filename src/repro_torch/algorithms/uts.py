"""Unbalanced Tree Search on the elastic executor (paper §4.1.1, Listing 2).

Counterpart of ``repro.algorithms.uts``.  UTS counts the nodes of a tree
generated on the fly from SHA-1 digests: child ``i`` of a node is
``SHA1(parent || be32(i))`` and the number of children is
Geometric(mean b0) with a depth cutoff.

* a ``Bag`` is a frontier of unexplored subtrees, kept on the device;
* each task traverses at most ``iters`` nodes of its bag and returns the
  leftover bag; ``run_irregular`` re-splits leftovers with the current
  split factor (``uts_spec``);
* a task's traversal is generation-vectorized: a whole chunk of the
  frontier advances one generation per step.  On the card every
  generation of a task runs inside one launch of the ``uts_expand``
  kernel (child counts, their scan, the SHA-1 of every child and the LIFO
  stack stay on the device); the host reads two integers per launch.

Node counts, leftover frontiers and WAL encodings are bit-identical to
the reference package's.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import TaskShape, WorkSpec
from ..device import DeviceLike, resolve_device
from ..kernels.uts_hash.ops import root_digest, uts_expand

__all__ = ["Bag", "UTSParams", "expand_bag", "uts_spec", "uts_sequential",
           "expected_tree_size", "encode_bag", "decode_bag"]


@dataclass(frozen=True)
class UTSParams:
    seed: int = 19
    b0: float = 4.0
    max_depth: int = 18
    #: nodes expanded per vectorized generation step inside a task
    chunk: int = 8192


@dataclass
class Bag:
    """A frontier of unexplored nodes on one device: digests [5, n] int32
    (uint32 bits), depths [n] int32."""

    digests: torch.Tensor
    depths: torch.Tensor

    @property
    def size(self) -> int:
        return int(self.depths.shape[0])

    @property
    def device(self) -> torch.device:
        return self.depths.device

    @staticmethod
    def empty(device: torch.device) -> "Bag":
        return Bag(torch.zeros((5, 0), dtype=torch.int32, device=device),
                   torch.zeros((0,), dtype=torch.int32, device=device))

    @staticmethod
    def root(params: UTSParams, device: torch.device) -> "Bag":
        return Bag(root_digest(params.seed, device),
                   torch.zeros((1,), dtype=torch.int32, device=device))

    def split(self, k: int) -> List["Bag"]:
        """Resize into <= k sub-bags (paper's ``resizeBag``); the part
        sizes are ``np.array_split``'s, as in the reference."""
        if self.size == 0:
            return []
        k = max(1, min(k, self.size))
        return [Bag(d, p) for d, p in
                zip(torch.tensor_split(self.digests, k, dim=1),
                    torch.tensor_split(self.depths, k))]

    @staticmethod
    def merge(bags: List["Bag"]) -> "Bag":
        """Concatenate ``bags`` (at least one, possibly empty) in order."""
        full = [b for b in bags if b.size]
        if not full:
            return Bag.empty(bags[0].device)
        if len(full) == 1:
            return full[0]
        return Bag(torch.cat([b.digests for b in full], dim=1),
                   torch.cat([b.depths for b in full]))


def expand_bag(bag: Bag, iters: int,
               params: UTSParams) -> Tuple[int, Bag]:
    """Traverse up to ``iters`` nodes of ``bag``; return (count, leftover).

    The task body (``RemoteUTSCallable.call`` in Listing 2): a pure
    function of its inputs.  LIFO order (children pushed on top) keeps
    the open frontier bounded the way the canonical DFS does.
    """
    count, digests, depths = uts_expand(
        bag.digests, bag.depths, iters, b0=params.b0,
        max_depth=params.max_depth, chunk=params.chunk)
    return count, Bag(digests, depths)


def uts_sequential(params: UTSParams,
                   node_limit: Optional[int] = None,
                   device: DeviceLike = None) -> int:
    """Single-threaded reference count (paper's 'Sequential' row)."""
    device = resolve_device(device)
    count, leftover = expand_bag(Bag.root(params, device),
                                 node_limit or 2**62, params)
    if leftover.size:
        raise RuntimeError("node_limit hit before traversal finished")
    return count


def encode_bag(bag: Bag) -> dict:
    """WAL encoding of a bag: the reference package's JSON exactly
    (digests as non-negative uint32 ints, word-major)."""
    dig = bag.digests.cpu().numpy().view(np.uint32)
    return {"d": dig.tolist(), "p": bag.depths.cpu().numpy().tolist()}


def decode_bag(enc: dict, device: torch.device) -> Bag:
    dig = np.asarray(enc["d"], np.uint32).reshape(5, -1).view(np.int32)
    return Bag(torch.from_numpy(np.ascontiguousarray(dig)).to(device),
               torch.as_tensor(np.asarray(enc["p"], np.int32)).to(device))


def uts_spec(params: UTSParams, device: DeviceLike = None) -> WorkSpec:
    """UTS as a declarative ``WorkSpec`` for ``run_irregular``.

    Work items are ``Bag`` frontiers on ``device``; the task body
    traverses at most ``shape.iters`` nodes and returns
    ``(count, leftover)``; leftovers are re-split with the live split
    factor (paper's ``resizeBag``)."""
    device = resolve_device(device)

    def _resize(bag: Bag, shape: TaskShape) -> List[Bag]:
        return bag.split(shape.split_factor if bag.size > 1 else 1)

    def execute(bag: Bag, shape: TaskShape) -> Tuple[int, Bag]:
        return expand_bag(bag, shape.iters, params)

    def execute_batch(bags: List[Bag],
                      shape: TaskShape) -> List[Tuple[int, Bag]]:
        """Fused task body: the queued bags are merged into one frontier
        and expanded with the batch's combined iteration budget; the
        leftover comes back on the first slot."""
        merged = Bag.merge(list(bags))
        count, leftover = expand_bag(merged, shape.iters * len(bags),
                                     params)
        return ([(count, leftover)]
                + [(0, Bag.empty(device))] * (len(bags) - 1))

    def split(result: Tuple[int, Bag], shape: TaskShape) -> List[Bag]:
        _, leftover = result
        return _resize(leftover, shape) if leftover.size else []

    return WorkSpec(
        name="uts",
        execute=execute,
        execute_batch=execute_batch,
        seed=lambda shape: _resize(Bag.root(params, device), shape),
        split=split,
        reduce=lambda total, result: total + result[0],
        init=lambda: 0,
        # int node counts: exact under any grouping, so sharded runs
        # (shards=K) are bit-identical to the single master
        merge=lambda a, b: a + b,
        cost_hint=lambda bag: float(bag.size),
        encode_item=encode_bag,
        encode_result=lambda r: {"c": int(r[0]), **encode_bag(r[1])},
        decode_result=lambda e: (e["c"], decode_bag(e, device)),
        decode_item=lambda e: decode_bag(e, device),
        encode_state=lambda s: int(s),
        decode_state=lambda e: int(e),
        shape=TaskShape(split_factor=8, iters=50_000),
    )


def expected_tree_size(b0: float, depth: int) -> float:
    """E[#nodes] = sum_{l=0}^{depth} b0^l — the Table 1 growth law."""
    return (b0 ** (depth + 1) - 1) / (b0 - 1)
