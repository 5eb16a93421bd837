"""Betweenness Centrality (SSCA2 kernel 4) on the elastic executor (§4.1.3).

Counterpart of ``repro.algorithms.betweenness``.  Brandes' algorithm over
an unweighted R-MAT digraph.  The vertex set is statically partitioned
into T tasks after a random permutation (paper: T=128, seed=2, R-MAT
probs (0.55, 0.1, 0.1, 0.25)); each task computes the dependency
contributions of its source block and the master sums the partial
betweenness maps.

The reference batches Brandes' forward and backward sweeps over sources
as two dense products per BFS level over a dense [N, N] float32
adjacency.  At the paper's scale 17 that matrix is 64 GiB and one level's
product 3.5e13 FLOP, for a graph with 5.8e-5 of its entries set.  The
port computes the same function, level for level, on a CSR graph
(:class:`CSRGraph`: int32 index lists of the out- and in-edges): each BFS
level is one launch of a hand-written CUDA kernel that pulls over the
edges (``kernels/bc``), deterministic and bit-equal to its plain PyTorch
version.  Nothing here builds a dense [N, N] matrix; ``to_dense`` exists
for the tests.  Each task re-generates the graph on the host (paper
Listing 4 line 44) behind ``regenerate_graph`` and uploads its CSR.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core import TaskShape, WorkSpec
from ..device import DeviceLike, resolve_device, task_stream
from ..kernels.bc.ops import (bc_backward_level, bc_forward_level,
                              sum_over_sources, sweep_state)
from ..kernels.dispatch import bucket

__all__ = ["RMATParams", "CSRGraph", "rmat_graph", "bc_batch",
           "bc_single_node", "bc_spec", "BCResult", "MAX_SOURCES"]

#: sources swept together at most (the kernels' most, 32 words of masks a
#: vertex): a sweep holds three [N, S] 32-bit arrays at once, 1.5 GiB at
#: the paper's N = 131,072 and S = 1,024, and a bit a pair a level
MAX_SOURCES = 1024


@dataclass(frozen=True)
class RMATParams:
    scale: int = 10                    # N = 2**scale vertices
    edge_factor: int = 8               # M = edge_factor * N edge samples
    a: float = 0.55
    b: float = 0.10
    c: float = 0.10
    d: float = 0.25
    seed: int = 2

    @property
    def n_vertices(self) -> int:
        return 1 << self.scale


@dataclass(frozen=True)
class CSRGraph:
    """An unweighted digraph as int32 CSR of its out-edges and of its
    in-edges, each row's neighbours ascending and distinct, no self-loops
    from :func:`rmat_graph`.  The four arrays are all numpy (on the host)
    or all torch tensors on one device (:meth:`to`)."""

    n: int
    out_indptr: Union[np.ndarray, torch.Tensor]
    out_indices: Union[np.ndarray, torch.Tensor]
    in_indptr: Union[np.ndarray, torch.Tensor]
    in_indices: Union[np.ndarray, torch.Tensor]

    @property
    def n_edges(self) -> int:
        return int(self.out_indices.shape[0])

    @classmethod
    def from_edges(cls, n: int, src: np.ndarray,
                   dst: np.ndarray) -> "CSRGraph":
        """The graph of edges ``src[i] -> dst[i]``, duplicates dropped."""
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if src.size and (min(src.min(), dst.min()) < 0 or
                         max(src.max(), dst.max()) >= n):
            raise ValueError(f"edge endpoints outside [0, {n})")
        key = np.unique(src * n + dst)              # by source, then target
        s, d = key // n, key % n
        rkey = np.sort(d * n + s)                   # by target, then source
        return cls(n, _indptr(s, n), d.astype(np.int32),
                   _indptr(rkey // n, n), (rkey % n).astype(np.int32))

    @classmethod
    def from_dense(cls, adj: np.ndarray) -> "CSRGraph":
        """The graph of a dense 0/1 adjacency ``adj[src, dst]``."""
        adj = np.asarray(adj)
        if adj.ndim != 2 or adj.shape[0] != adj.shape[1]:
            raise ValueError(f"square adjacency expected, got {adj.shape}")
        if not np.isin(adj, (0, 1)).all():
            raise ValueError("the graph is unweighted: adjacency entries "
                             "must be 0 or 1")
        src, dst = np.nonzero(adj)
        return cls.from_edges(adj.shape[0], src, dst)

    def to(self, device: DeviceLike) -> "CSRGraph":
        """The same graph as int32 tensors on ``device``."""
        device = torch.device(device)
        arrs = [torch.as_tensor(a).to(device) for a in
                (self.out_indptr, self.out_indices, self.in_indptr,
                 self.in_indices)]
        return CSRGraph(self.n, *arrs)

    def to_dense(self) -> np.ndarray:
        """Dense float32 [N, N] adjacency, as the reference's
        ``rmat_graph`` returns it; for the tests."""
        indptr, indices = (np.asarray(torch.as_tensor(a).cpu())
                           for a in (self.out_indptr, self.out_indices))
        adj = np.zeros((self.n, self.n), np.float32)
        adj[np.repeat(np.arange(self.n), np.diff(indptr)), indices] = 1.0
        return adj


def _indptr(rows: np.ndarray, n: int) -> np.ndarray:
    """int32 row pointers of sorted row ids."""
    out = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=out[1:])
    if out[-1] >= 2**31:
        raise ValueError(f"{out[-1]} edges do not fit int32 CSR")
    return out.astype(np.int32)


def rmat_graph(p: RMATParams, permute: bool = True) -> CSRGraph:
    """The R-MAT digraph as a :class:`CSRGraph`.

    Recursive-matrix sampling (Chakrabarti et al.), dedup'd, self-loops
    dropped, vertices permuted (paper §4.1.3: permutation makes the static
    partition more homogeneous — but still imbalanced).  The draws are the
    reference's, in its order, so the edge set is the reference's.
    """
    rng = np.random.RandomState(p.seed)
    n = p.n_vertices
    m = p.edge_factor * n
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for _ in range(p.scale):
        r = rng.rand(m)
        # quadrant choice per remaining bit
        q_b = (r >= p.a) & (r < p.a + p.b)
        q_c = (r >= p.a + p.b) & (r < p.a + p.b + p.c)
        q_d = r >= p.a + p.b + p.c
        src = 2 * src + (q_c | q_d)
        dst = 2 * dst + (q_b | q_d)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if permute:
        perm = rng.permutation(n)
        src, dst = perm[src], perm[dst]
    return CSRGraph.from_edges(n, src, dst)


def _as_graph(adj: Union[np.ndarray, CSRGraph]) -> CSRGraph:
    return adj if isinstance(adj, CSRGraph) else CSRGraph.from_dense(adj)


def bc_batch(graph: CSRGraph, sources: torch.Tensor,
             max_levels: Optional[int] = None, *,
             backend: Optional[str] = None,
             steps: Optional[Tuple[Callable, Callable]] = None
             ) -> torch.Tensor:
    """Brandes dependency sums for a batch of sources -> [N] partial BC.

    graph:   :class:`CSRGraph` (uploaded to ``sources``' device if needed)
    sources: [S] integer source vertex ids, on the device to run on
    returns  [N] float32 on that device — the sum over the batch of
             dependency scores delta, each source's own entry excluded.

    The reference's function, level for level, with its state kept
    vertex-major, [N, S], where the reference keeps [S, N]
    (``kernels/bc/ref.py``): bit-packed masks of 32 sources a word,
    ``on[L]`` for the pairs on each level (kept for the backward sweep)
    and ``visited``, so that a warp reads which of a neighbour's pairs
    are on the level, for the whole batch, in one coalesced 128-byte
    load; float32 ``sigma`` and ``coeff = (1 + delta) / sigma`` kept in
    level order, so that a level's values of a vertex lie together and a
    level writes whole runs of them; and ``delta`` in source order.  No
    BFS distance array is kept: the masks are the distances.  The source
    axis is padded to ``bucket(S, 32)`` with columns that never join and
    add exact zeros.  The forward sweep reads one answer a level from the
    device (did any pair join: the ``live`` words that tell the next level
    which sources still have a frontier), a sync with the device on the
    current stream.  The sum over sources is pairwise halving over the
    padded axis, one fixed order on every device.
    Sources are swept in chunks of at most ``MAX_SOURCES``, whose partials
    are added in chunk order, so a fused task's result depends on how its
    blocks were grouped.

    ``backend`` selects the level steps' bodies: "cuda" (the kernels),
    "ref" (plain PyTorch), None from the device.  ``steps``, a pair
    ``(forward, backward)`` with the signatures of
    :func:`~repro_torch.kernels.bc.ops.bc_forward_level` and
    :func:`~repro_torch.kernels.bc.ops.bc_backward_level` (those by
    default), lets a caller wrap each level, to check or time it.
    """
    g = graph.to(sources.device)
    levels = max_levels or g.n
    forward, backward = steps or (bc_forward_level, bc_backward_level)
    out = None
    for chunk in torch.split(sources.long(), MAX_SOURCES):
        part = _sweep(g, chunk, levels, backend, forward, backward)
        out = part if out is None else out + part
    if out is None:
        out = torch.zeros(g.n, dtype=torch.float32, device=sources.device)
    return out


def _sweep(g: CSRGraph, sources: torch.Tensor, levels: int,
           backend: Optional[str], forward: Callable,
           backward: Callable) -> torch.Tensor:
    """One forward and one backward sweep over at most ``MAX_SOURCES``."""
    st = sweep_state(g.n, sources, bucket(sources.shape[0], 32))
    sigma, coeff, visited, live = (
        st[k] for k in ("sigma", "coeff", "visited", "live"))
    # on[L], base[L]: the pairs on level L, bit-packed, and where their
    # values start in each row part
    on, base = [st["on"]], [st["base"]]
    del st

    # -- forward: level-synchronous BFS with path counting ----------------
    level, ran_out = 0, False
    while level < levels and not ran_out:
        nxt, at, live = forward(g.in_indptr, g.in_indices, sigma, visited,
                                on[level], base[level], live, level,
                                backend=backend)
        on.append(nxt)
        base.append(at)
        level += 1
        ran_out = not bool(live.any())
    del visited
    if not ran_out:
        # ``levels`` cut the BFS: an empty level past the cut, so that the
        # backward sweep starts, as it does where the BFS ran out, at an
        # empty level, whose launch writes the top pairs' coeff
        on.append(torch.zeros_like(on[-1]))
        base.append(base[-1])
        level += 1

    # -- backward: dependency accumulation --------------------------------
    delta = torch.zeros_like(sigma)
    for lvl in range(level, 0, -1):
        backward(g.out_indptr, g.out_indices, sigma, delta, coeff, on[lvl],
                 on[lvl - 1], base[lvl], base[lvl - 1], lvl, backend=backend)
    del sigma, coeff, on, base
    # exclude the source itself from its own dependency sum
    cols = torch.arange(sources.shape[0], device=sources.device)
    delta[sources, cols] = 0.0
    return sum_over_sources(delta)


def bc_single_node(adj: Union[np.ndarray, CSRGraph], n_tasks: int = 1,
                   device: DeviceLike = None) -> np.ndarray:
    """All-sources BC on one device (reference / 'parallel VM' baseline)."""
    device = resolve_device(device)
    g = _as_graph(adj).to(device)
    out = np.zeros(g.n, np.float64)
    for block in np.array_split(np.arange(g.n, dtype=np.int32),
                                max(1, n_tasks)):
        src = torch.from_numpy(block).to(device)
        out += bc_batch(g, src).cpu().numpy().astype(np.float64)
    return out


def _bc_task(p: RMATParams, sources: np.ndarray, graph: Optional[CSRGraph],
             device: torch.device) -> np.ndarray:
    """Task body (``ServerlessCallable`` of Listing 4).  On the card it
    runs on a side stream of its own and copies its [N] partial to the
    host before the stream's scope ends."""
    if graph is None:
        graph = rmat_graph(p)  # line 44: generateGraph() inside the function
    with task_stream(device):
        src = torch.from_numpy(np.asarray(sources, np.int32)).to(device)
        return bc_batch(graph.to(device), src).cpu().numpy()


@dataclass
class BCResult:
    betweenness: np.ndarray
    wall_time_s: float
    tasks: int

    @property
    def throughput(self) -> float:
        """Vertices (sources) processed per second."""
        return self.betweenness.shape[0] / self.wall_time_s \
            if self.wall_time_s else 0.0


def bc_spec(
    p: RMATParams,
    *,
    n_tasks: int = 128,
    regenerate_graph: bool = True,
    adj: Optional[Union[np.ndarray, CSRGraph]] = None,
    device: DeviceLike = None,
) -> WorkSpec:
    """BC as a declarative ``WorkSpec``: a static map-reduce.

    Paper Listing 4 — the vertex set is partitioned into ``n_tasks``
    source blocks; each task runs batched Brandes for its block and the
    master aggregates the ``globalBetweennessMap`` (line 34) in the
    ``reduce`` hook.  With ``regenerate_graph`` each function rebuilds
    the graph from the R-MAT parameters (line 44); else the graph (``adj``,
    a dense 0/1 array or a :class:`CSRGraph`, by default ``rmat_graph(p)``)
    is shipped to every task.  Partials are computed on ``device``."""
    device = resolve_device(device)
    graph = (_as_graph(adj) if adj is not None
             else None if regenerate_graph else rmat_graph(p))
    n = graph.n if graph is not None else p.n_vertices
    shipped = None if regenerate_graph else graph

    def seed(shape: TaskShape) -> List[np.ndarray]:
        return [block for block in
                np.array_split(np.arange(n, dtype=np.int32), n_tasks)
                if len(block)]

    def execute(block: np.ndarray,
                shape: TaskShape) -> Tuple[int, np.ndarray]:
        # keyed contribution: (first source id, partial map).  Floating
        # sums are order-sensitive, so partials are collected keyed and
        # summed in canonical key order by ``finalize`` — the final
        # betweenness is then bit-identical no matter which master
        # shard or completion order produced each partial.
        return int(block[0]), _bc_task(p, block, shipped, device)

    def execute_batch(blocks: List[np.ndarray],
                      shape: TaskShape) -> List[Tuple[int, np.ndarray]]:
        """Fused task body: the queued source blocks are stacked into
        one ``bc_batch`` call (swept ``MAX_SOURCES`` at a time).  The
        summed dependency map lands on the first slot keyed by the first
        block; the remaining slots carry exact zero contributions under
        their own keys."""
        sources = np.concatenate([np.asarray(b) for b in blocks])
        partial = _bc_task(p, sources, shipped, device)
        return ([(int(blocks[0][0]), partial)]
                + [(int(b[0]), np.zeros(n, partial.dtype))
                   for b in blocks[1:]])

    def finalize(parts: List[Tuple[int, np.ndarray]]) -> np.ndarray:
        out = np.zeros(n, np.float64)
        for _, partial in sorted(parts, key=lambda kp: kp[0]):
            out += partial
        return out

    # WAL codecs (crash recovery): blocks key on their int ids; a
    # partial's float values survive the JSON trip exactly (binary float
    # -> shortest-repr decimal -> same binary float), so recovered runs
    # stay bit-identical through ``finalize``'s canonical-order sum
    return WorkSpec(
        name="betweenness_centrality",
        execute=execute,
        execute_batch=execute_batch,
        seed=seed,
        reduce=lambda parts, keyed: parts + [keyed],
        init=list,
        finalize=finalize,
        merge=lambda a, b: a + b,
        cost_hint=lambda block: float(len(block)),
        encode_item=lambda block: np.asarray(block).tolist(),
        encode_result=lambda r: {"k": int(r[0]), "v": r[1].tolist(),
                                 "dt": str(r[1].dtype)},
        decode_result=lambda e: (e["k"],
                                 np.asarray(e["v"], np.dtype(e["dt"]))),
    )
