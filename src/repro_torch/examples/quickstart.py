"""Quickstart: count an unbalanced tree with the elastic executor.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Twin of the reference's ``examples/quickstart.py``: a wildly unbalanced
workload (UTS), a thread-pool-shaped API, and an elastic pool that
absorbs the irregularity without any static provisioning decisions.
Every task body expands its bag on ``device`` (``uts_expand`` on the
card).  The whole drive is two calls on the unified surface:

    pool   = make_pool("elastic", ...)
    result = run_irregular(pool, uts_spec(params))
"""
from __future__ import annotations

import argparse
import time

from ..algorithms import UTSParams, uts_sequential, uts_spec
from ..core import (StagedController, TaskShape, characterize, make_pool,
                    price_performance, run_irregular, serverless_cost)
from ..core.adaptive import Stage
from ..device import DeviceLike, resolve_device

__all__ = ["main"]


def main(device: DeviceLike = None, *, seed: int = 19, b0: float = 4.0,
         max_depth: int = 10, chunk: int = 4096) -> dict:
    """Sequential count, then the elastic pool with a static shape and
    with the paper's Listing-5 controller, then the paper's scale on a
    2,000-worker sim pool; every count must equal the sequential one."""
    device = resolve_device(device)
    # by default a tree of ~460k nodes whose shape is unknowable in
    # advance (geometric branching over SHA-1 digests, b0=4, depth 10)
    params = UTSParams(seed=seed, b0=b0, max_depth=max_depth, chunk=chunk)
    spec = uts_spec(params, device=device)
    out = {}

    print("sequential baseline ...")
    t0 = time.monotonic()
    expected = uts_sequential(params, device=device)
    out["sequential_s"] = t_seq = time.monotonic() - t0
    out["nodes"] = expected
    print(f"  {expected:,} nodes in {t_seq:.2f}s")

    print("elastic executor (16 workers, FaaS-style 1ms invoke) ...")
    with make_pool("elastic", max_concurrency=16, invoke_overhead=1e-3,
                   invoke_rate_limit=None) as pool:
        result = run_irregular(pool, spec,
                               shape=TaskShape(split_factor=8, iters=2000))
        assert result.output == expected, "parallel traversal must be exact"
        cost = serverless_cost(pool.records, wall_time_s=result.wall_time_s)
        ch = characterize(pool.records)
    out["elastic"] = {"seconds": result.wall_time_s, "tasks": result.tasks,
                      "cv": ch.cv, "usd": cost.total}
    print(f"  {result.output:,} nodes in {result.wall_time_s:.2f}s "
          f"({result.throughput/1e6:.2f} M nodes/s, "
          f"{result.tasks} tasks, peak concurrency "
          f"{result.peak_concurrency})")
    print(f"  task-duration CV (imbalance): {ch.cv:.2f} "
          f"(paper reports 1.20 at full scale)")
    print(f"  simulated cost: ${cost.total:.6f}  "
          f"price-performance: "
          f"{price_performance(result.throughput/1e6, cost):,.0f} "
          f"M nodes/s/$")

    print("with the paper's Listing-5 adaptive controller ...")
    ctrl = StagedController(initial=TaskShape(32, 500), stages=[
        Stage(8, "above", TaskShape(8, 4000)),
        Stage(13, "above", TaskShape(2, 8000)),
        Stage(11, "below", TaskShape(2, 4000)),
        Stage(2, "below", TaskShape(2, 1500)),
    ])
    with make_pool("elastic", max_concurrency=16, invoke_overhead=1e-3,
                   invoke_rate_limit=None) as pool:
        result = run_irregular(pool, spec, shape=TaskShape(32, 500),
                               controller=ctrl)
    assert result.output == expected
    out["controller"] = {
        "seconds": result.wall_time_s, "tasks": result.tasks,
        "transitions": len(result.controller_transitions)}
    print(f"  {result.wall_time_s:.2f}s with dynamic (split_factor, iters) "
          f"({len(result.controller_transitions)} stage transitions)")

    print("same drive at the paper's true scale (2000 virtual workers) ...")
    with make_pool("sim", max_concurrency=2000, invoke_overhead=13e-3,
                   duration_fn=lambda task, result: 1e-6 * result[0]) as pool:
        result = run_irregular(pool, spec, shape=TaskShape(50, 5000))
    assert result.output == expected
    out["sim"] = {"virtual_s": pool.virtual_time_s, "tasks": result.tasks,
                  "peak": result.peak_concurrency}
    print(f"  virtual makespan {pool.virtual_time_s:.2f}s, "
          f"peak concurrency {result.peak_concurrency} "
          f"(event-driven, one host core)")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    ap.add_argument("--depth", type=int, default=10)
    args = ap.parse_args()
    main(args.device, max_depth=args.depth)
