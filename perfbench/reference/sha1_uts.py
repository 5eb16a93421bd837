"""Plain UTS: SHA-1 child digests, the geometric child count and a task's
traversal, written from the UTS benchmark's definition (Olivier et al.,
LCPC 2006) in plain PyTorch, for the benchmark's check of the port.

It imports nothing of the program.  Words are int64 tensors holding
uint32 values (every result is masked to 32 bits), so the same code runs
on the CPU and on the card.  A node is its 20-byte digest, five words, and
its depth.  The root of tree ``seed`` is SHA1(twenty zero bytes ||
be32(seed)); child ``i`` of a node is SHA1(digest || be32(i)).  A node's
child count is Geometric with mean ``b0``: the float32 map
``floor(log(u) / log(1 - p))`` of ``u = (u31 + 1) / (2**31 + 1)``, ``u31``
the top 31 bits of the digest's first word, ``p = 1 / (1 + b0)``, clipped
to ``max_children``; a node at ``max_depth`` has none.

A task traverses at most ``iters`` nodes of its bag LIFO by generations:
each generation takes the top ``min(S, iters - count, chunk)`` nodes of
the stack of ``S`` and pushes their children, parent-major and child index
minor, in their place.  Its answer is the count and the stack left.

``precision="bfloat16"`` computes the child-count map in bfloat16: the
control that the benchmark's check must reject.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["M32", "sha1_child", "root_digest", "child_counts", "traverse",
           "traverse_many", "tree_size"]

M32 = 0xFFFFFFFF
_H = (0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0)
_K = (0x5A827999, 0x6ED9EBA1, 0x8F1BBCDC, 0xCA62C1D6)


def _rotl(x, n: int):
    """Rotate a uint32 left; ``x`` a Python int or an int64 tensor."""
    return ((x << n) & M32) | (x >> (32 - n))


def sha1_child(parent: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """SHA1(parent digest || be32(index)) of a batch.

    parent [5, N] and index [N], int64 holding uint32 values; returns
    [5, N] int64.  The 24-byte message is one padded block: the five
    digest words, the index, the pad bit, zeros, and the bit length 192.
    Constant words stay Python ints, so the schedule folds them.
    """
    w: List = [parent[i] for i in range(5)] + [index, 0x80000000] + \
        [0] * 8 + [192]
    for i in range(16, 80):
        w.append(_rotl(w[i - 3] ^ w[i - 8] ^ w[i - 14] ^ w[i - 16], 1))
    a, b, c, d, e = _H
    for i in range(80):
        if i < 20:
            f, k = d ^ (b & (c ^ d)), _K[0]
        elif i < 40:
            f, k = b ^ c ^ d, _K[1]
        elif i < 60:
            f, k = (b & c) | (d & (b | c)), _K[2]
        else:
            f, k = b ^ c ^ d, _K[3]
        t = (_rotl(a, 5) + f + e + k + w[i]) & M32
        a, b, c, d, e = t, a, _rotl(b, 30), c, d
    out = [(v + h) & M32 for v, h in zip((a, b, c, d, e), _H)]
    return torch.stack(out)


def root_digest(seed: int, device: torch.device) -> torch.Tensor:
    """The root's digest, [5, 1] int64, of tree ``seed`` (a uint32)."""
    zero = torch.zeros((5, 1), dtype=torch.int64, device=device)
    return sha1_child(zero, torch.tensor([seed & M32], dtype=torch.int64,
                                         device=device))


def child_counts(first_word: np.ndarray, depth: np.ndarray, *, b0: float,
                 max_depth: int, max_children: int = 64,
                 precision: str = "float32") -> np.ndarray:
    """Children of each node from its first digest word and depth (host
    arrays, int64); int64 counts."""
    u31 = (first_word >> 1) & 0x7FFFFFFF
    p = 1.0 / (1.0 + b0)
    if precision == "float32":
        u = (u31.astype(np.float32) + np.float32(1.0)) / \
            np.float32(2147483648.0 + 1.0)
        m = np.floor(np.log(u) / np.float32(math.log(1.0 - p)))
    elif precision == "bfloat16":
        bf = torch.bfloat16
        u = (torch.from_numpy(u31).to(bf) + 1.0) / \
            torch.tensor(2147483648.0 + 1.0, dtype=bf)
        m = torch.floor(torch.log(u) /
                        torch.tensor(math.log(1.0 - p), dtype=bf))
        m = m.float().numpy()
    else:
        raise ValueError(f"unknown precision {precision!r}")
    m = np.clip(m.astype(np.int64), 0, max_children)
    return np.where(depth >= max_depth, 0, m)


class _Graphs:
    """``sha1_child`` on the card as one CUDA graph replay a batch: some
    1,700 small elementwise kernels a batch would otherwise each cost a
    launch from the host.  One graph a power-of-two lane count, its
    inputs padded with zeros; the same kernels either way."""

    def __init__(self) -> None:
        self._g: dict = {}

    def __call__(self, parent: torch.Tensor, index: torch.Tensor
                 ) -> torch.Tensor:
        n = index.shape[0]
        if parent.device.type != "cuda" or n == 0:
            return sha1_child(parent, index)
        lanes = max(4096, 1 << (n - 1).bit_length())
        if lanes not in self._g:
            p = torch.zeros((5, lanes), dtype=torch.int64,
                            device=parent.device)
            i = torch.zeros(lanes, dtype=torch.int64, device=parent.device)
            side = torch.cuda.Stream(parent.device)
            side.wait_stream(torch.cuda.current_stream(parent.device))
            with torch.cuda.stream(side):
                sha1_child(p, i)
            torch.cuda.current_stream(parent.device).wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = sha1_child(p, i)
            self._g[lanes] = (g, p, i, out)
        g, p, i, out = self._g[lanes]
        p[:, :n].copy_(parent)
        i[:n].copy_(index)
        g.replay()
        return out[:, :n].clone()


class _Task:
    """One bag under traversal: a stack of digests [5, S] and depths [S]."""

    def __init__(self, digests: torch.Tensor, depths: torch.Tensor,
                 iters: int):
        self.d, self.p, self.iters, self.count = digests, depths, iters, 0

    @property
    def take(self) -> int:
        return min(self.p.shape[0], self.iters - self.count)


def traverse_many(bags: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  iters: int, *, b0: float, max_depth: int, chunk: int,
                  max_children: int = 64, precision: str = "float32"
                  ) -> List[Tuple[int, torch.Tensor, torch.Tensor]]:
    """Traverse each bag (digests [5, S] and depths [S], any integer type
    holding uint32 bits) as one task of budget ``iters``; returns each
    task's (count, leftover digests [5, S'] int64, leftover depths [S']
    int64).  The tasks advance in lockstep, one SHA-1 batch a generation,
    which gives each the same answer as traversing it alone."""
    tasks = [_Task(d.to(torch.int64) & M32, p.to(torch.int64), iters)
             for d, p in bags]
    sha1 = _Graphs()
    while True:
        live = [t for t in tasks if t.take > 0]
        if not live:
            break
        takes = [min(t.take, chunk) for t in live]
        heads_d = torch.cat([t.d[:, t.p.shape[0] - k:]
                             for t, k in zip(live, takes)], dim=1)
        heads_p = torch.cat([t.p[t.p.shape[0] - k:]
                             for t, k in zip(live, takes)])
        counts = child_counts(heads_d[0].cpu().numpy(),
                              heads_p.cpu().numpy(), b0=b0,
                              max_depth=max_depth, max_children=max_children,
                              precision=precision)
        dev = heads_p.device
        parent = torch.repeat_interleave(
            torch.arange(len(counts), device=dev),
            torch.from_numpy(counts).to(dev))
        first = np.concatenate([[0], np.cumsum(counts)[:-1]])
        index = (torch.arange(parent.shape[0], device=dev)
                 - torch.from_numpy(first).to(dev)[parent])
        kids_d = sha1(heads_d[:, parent], index)
        kids_p = heads_p[parent] + 1
        per_task = np.add.reduceat(counts, np.cumsum([0] + takes[:-1]))
        at = 0
        for t, k, n_kids in zip(live, takes, per_task.tolist()):
            cut = t.p.shape[0] - k
            t.d = torch.cat([t.d[:, :cut], kids_d[:, at:at + n_kids]], dim=1)
            t.p = torch.cat([t.p[:cut], kids_p[at:at + n_kids]])
            t.count += k
            at += n_kids
    return [(t.count, t.d, t.p) for t in tasks]


def traverse(digests: torch.Tensor, depths: torch.Tensor, iters: int,
             **kw) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """One task: (count, leftover digests, leftover depths)."""
    return traverse_many([(digests, depths)], iters, **kw)[0]


def tree_size(seed: int, *, b0: float, max_depth: int,
              chunk: int = 65536, device: torch.device = torch.device("cpu")
              ) -> int:
    """Nodes of the whole tree ``seed`` (a count does not depend on
    ``chunk``)."""
    count, d, _ = traverse(root_digest(seed, device),
                           torch.zeros(1, dtype=torch.int64, device=device),
                           2**62, b0=b0, max_depth=max_depth, chunk=chunk)
    if d.shape[1]:
        raise RuntimeError("the traversal stopped before the tree's end")
    return count
