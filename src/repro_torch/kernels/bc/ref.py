"""Plain PyTorch versions of the betweenness-centrality level steps.

The plain versions of the two kernels of ``csrc/bc_level.cu``: the CPU
path of the port, and what the kernels are held against on the card, bit
for bit.  The state is vertex-major, ``[N, S]`` for N vertices and S
sources (the reference keeps ``[S, N]``), and is updated in place:

* ``dist``  int32, the BFS level of vertex v from source s, ``INF`` if
  not reached;
* ``sigma`` float32, the number of shortest paths from s to v;
* ``delta`` float32, the dependency of s on v;

and ``live`` int32 [S], 1 for a source whose frontier at the current
level is not empty (a pair of it joined at the level before; every real
source at level 0).  A source whose frontier is empty reaches no one, so
its pairs sit out the forward level.

A CSR graph is ``(indptr [N + 1], indices [E])``, int32, each row's
neighbours ascending.  Every sum over a row runs sequentially in that
order, starting from +0.0 (:func:`csr_pull`), which is what the kernels
do: so the two agree bit for bit, not merely within a tolerance.  A
neighbour that is not on the level adds +0.0 here and is skipped by the
kernel; both leave a sum of non-negative terms unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["INF", "csr_pull", "bc_forward_level_ref", "bc_backward_level_ref",
           "sum_over_sources"]

#: ``dist`` of a vertex not reached (the reference's ``_INF``)
INF = 2**30


def csr_pull(indptr: torch.Tensor, indices: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum(val[indices[j]] for j in row r)``, each row summed
    left to right in CSR order from +0.0; ``val`` is ``[N, S]``.

    Rows are visited in order of falling degree, so that step k adds the
    k-th neighbour of a prefix of them: one gather and one add per
    position, max degree steps in all.
    """
    n = indptr.shape[0] - 1
    deg = indptr[1:] - indptr[:-1]
    order = torch.argsort(deg, descending=True, stable=True)
    start = indptr[:-1][order].long()
    deg_np = deg.cpu().numpy()
    # rows of degree > k, for every k < max degree
    rows = n - np.cumsum(np.bincount(deg_np, minlength=1))
    acc = torch.zeros((n, val.shape[1]), dtype=val.dtype, device=val.device)
    idx = indices.long()
    for k in range(int(deg_np.max(initial=0))):
        r = int(rows[k])
        acc[:r] += val[idx[start[:r] + k]]
    out = torch.empty_like(acc)
    out[order] = acc
    return out


def bc_forward_level_ref(in_indptr: torch.Tensor, in_indices: torch.Tensor,
                         dist: torch.Tensor, sigma: torch.Tensor,
                         live: torch.Tensor, *, level: int) -> torch.Tensor:
    """One forward BFS level, in place: every unvisited (v, s) of a live
    source with ``reach = sum(sigma[u, s] for u in in(v) if dist[u, s] ==
    level) > 0`` joins at ``level + 1`` with ``sigma = reach``.  Returns
    the next level's ``live``: 1 for every source of which a pair
    joined."""
    reach = csr_pull(in_indptr, in_indices,
                     torch.where(dist == level, sigma, 0.0))
    joined = (dist == INF) & (live != 0) & (reach > 0)
    dist.masked_fill_(joined, level + 1)
    sigma.copy_(torch.where(joined, reach, sigma))
    return joined.any(dim=0).to(torch.int32)


def bc_backward_level_ref(out_indptr: torch.Tensor, out_indices: torch.Tensor,
                          dist: torch.Tensor, sigma: torch.Tensor,
                          delta: torch.Tensor, *, level: int) -> torch.Tensor:
    """One backward level, in place: with ``coeff[w] = (1 + delta[w]) /
    safe_sigma[w]`` where ``dist[w] == level`` (else 0), every u with
    ``dist[u] == level - 1`` gets ``delta[u] += sigma[u] * back[u]``,
    ``back[u] = sum(coeff[w] for w in out(u))``.  The reference multiplies
    by a 0/1 mask instead of selecting; the two agree wherever
    ``1 + delta`` is finite.  Returns ``delta``."""
    safe = torch.where(sigma > 0, sigma, 1.0)
    coeff = torch.where(dist == level, (1.0 + delta) / safe, 0.0)
    back = csr_pull(out_indptr, out_indices, coeff)
    delta.copy_(torch.where(dist == level - 1, delta + sigma * back, delta))
    return delta


def sum_over_sources(delta: torch.Tensor) -> torch.Tensor:
    """``[N, S]`` -> ``[N]``: pairwise halving over S, a power of two, so
    the sum has one fixed order on every device."""
    s = delta.shape[1]
    if s & (s - 1):
        raise ValueError(f"source axis {s} is not a power of two")
    while delta.shape[1] > 1:
        h = delta.shape[1] // 2
        delta = delta[:, :h] + delta[:, h:]
    return delta[:, 0]
