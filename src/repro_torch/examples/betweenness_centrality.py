"""Betweenness Centrality (SSCA2 kernel 4) on the elastic executor.

    PYTHONPATH=src python -m repro_torch.examples.betweenness_centrality [--device cpu]

Twin of the reference's ``examples/betweenness_centrality.py``: R-MAT
graph -> static source partition -> per-task batched Brandes (the BC
level kernels on the card) -> aggregated centrality map.  The reference
checks against networkx; this twin checks against a queue-based float64
Brandes on the host (:func:`brandes`), within the reference's test
tolerances, and reports the paper-style characterization.
"""
from __future__ import annotations

import argparse
import time
from collections import deque

import numpy as np

from ..algorithms import RMATParams, bc_spec, rmat_graph
from ..core import characterize, make_pool, run_irregular
from ..device import DeviceLike, resolve_device

__all__ = ["brandes", "main"]

#: the reference's BC test tolerances
RTOL, ATOL = 1e-4, 1e-3


def brandes(n: int, indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Unnormalized betweenness of every vertex of a digraph given as
    out-edge CSR: Brandes' dependencies summed over every source, each
    from a FIFO-queue BFS, in float64."""
    ip, ix = indptr.tolist(), indices.tolist()
    total = np.zeros(n, np.float64)
    for s in range(n):
        sigma = [0.0] * n
        dist = [-1] * n
        sigma[s], dist[s] = 1.0, 0
        order, queue = [], deque([s])
        while queue:
            v = queue.popleft()
            order.append(v)
            dv, sv = dist[v] + 1, sigma[v]
            for w in ix[ip[v]:ip[v + 1]]:
                if dist[w] < 0:
                    dist[w] = dv
                    queue.append(w)
                if dist[w] == dv:
                    sigma[w] += sv
        delta = [0.0] * n
        for v in reversed(order):
            dv, acc = dist[v] + 1, 0.0
            for w in ix[ip[v]:ip[v + 1]]:
                if dist[w] == dv:
                    acc += (1.0 + delta[w]) / sigma[w]
            delta[v] = sigma[v] * acc
        delta[s] = 0.0
        total += delta
    return total


def main(device: DeviceLike = None, *, scale: int = 8, edge_factor: int = 8,
         seed: int = 2, n_tasks: int = 16) -> dict:
    """BC of an R-MAT graph over ``n_tasks`` elastic tasks (each
    regenerating the graph), against :func:`brandes` on the host."""
    device = resolve_device(device)
    params = RMATParams(scale=scale, edge_factor=edge_factor, seed=seed)
    graph = rmat_graph(params)
    print(f"R-MAT graph: {params.n_vertices} vertices, "
          f"{graph.n_edges} edges (a={params.a}, skewed)")

    with make_pool("elastic", max_concurrency=8, invoke_overhead=1e-3,
                   invoke_rate_limit=None) as pool:
        res = run_irregular(pool, bc_spec(params, n_tasks=n_tasks,
                                          regenerate_graph=True,
                                          device=device))
        wall = res.wall_time_s
        ch = characterize(pool.records)

    print(f"our BC: {wall:.2f}s over {res.tasks} tasks "
          f"(each re-generates the graph, paper Listing 4 line 44)")
    print(f"task-duration CV: {ch.cv:.3f} "
          f"(paper reports 0.23 — most balanced of the three)")

    print("verifying against a float64 Brandes on the host ...")
    t0 = time.monotonic()
    ref = brandes(graph.n, graph.out_indptr, graph.out_indices)
    oracle_s = time.monotonic() - t0
    print(f"  host Brandes: {oracle_s:.2f}s")
    err = float(np.abs(res.output - ref).max())
    ok = bool(np.allclose(res.output, ref, rtol=RTOL, atol=ATOL))
    print(f"  max abs diff: {err:.2e}  ({'OK' if ok else 'MISMATCH'})")
    assert ok, f"BC differs from the host Brandes by up to {err}"

    top = np.argsort(res.output)[::-1][:5]
    print("top-5 central vertices:",
          [(int(v), round(float(res.output[v]), 1)) for v in top])
    return {"vertices": graph.n, "edges": graph.n_edges, "seconds": wall,
            "tasks": res.tasks, "cv": ch.cv, "max_abs_err": err,
            "oracle_s": oracle_s, "centrality": res.output}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--tasks", type=int, default=16)
    args = ap.parse_args()
    main(args.device, scale=args.scale, n_tasks=args.tasks)
