"""Mariani-Silver Mandelbrot rendering on three executors (paper §5.3).

    PYTHONPATH=src python -m repro_torch.examples.mandelbrot_render [--device cpu]

Twin of the reference's ``examples/mandelbrot_render.py``: renders the
set with the recursive adjacency optimization, compares local, serverless
and hybrid executors, verifies each image against the naive per-pixel
oracle, and writes the dwell map as a ``.npy`` dump and ASCII art.  The
dwell of every pixel a task evaluates comes from the ``mandelbrot``
kernel on the card.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np

from ..algorithms import MSParams, ms_spec, naive_render
from ..core import (VMPrice, make_pool, price_performance, run_irregular,
                    serverless_cost, vm_cost)
from ..device import DeviceLike, resolve_device

__all__ = ["main"]


def main(device: DeviceLike = None, *, side: int = 256, max_dwell: int = 96,
         initial_subdivision: int = 4, max_depth: int = 4,
         out: Optional[str] = "mandelbrot_dwell.npy") -> dict:
    """Render ``side`` x ``side`` pixels on the local, elastic and hybrid
    pools; each image must equal ``naive_render``'s.  Saves the oracle's
    dwell map to ``out`` (nothing when ``None``)."""
    device = resolve_device(device)
    params = MSParams(width=side, height=side, max_dwell=max_dwell,
                      initial_subdivision=initial_subdivision,
                      max_depth=max_depth)
    spec = ms_spec(params, device=device)
    report = {}

    print("naive per-pixel oracle ...")
    t0 = time.monotonic()
    oracle = naive_render(params, device=device)
    report["oracle_s"] = time.monotonic() - t0
    print(f"  {report['oracle_s']:.2f}s")

    for name, kind, cfg in (
        ("parallel (local pool)", "local",
         dict(max_concurrency=2, invoke_overhead=0.0)),
        ("serverless (elastic)", "elastic",
         dict(max_concurrency=16, invoke_overhead=2e-3,
              invoke_rate_limit=None)),
        ("hybrid (local + elastic)", "hybrid",
         dict(local_concurrency=2, elastic_concurrency=16)),
    ):
        with make_pool(kind, **cfg) as pool:
            res = run_irregular(pool, spec)
            wall = res.wall_time_s
            image = res.output["image"]
            assert np.array_equal(image, oracle), "must match the oracle"
            saved = res.output["filled"] / image.size
            if kind == "local":
                cost = vm_cost(wall, VMPrice.named("c5.12xlarge"))
            else:
                cost = serverless_cost(pool.records, wall_time_s=wall)
        mps = image.size / 1e6 / wall
        report[kind] = {"seconds": wall, "tasks": res.tasks,
                        "filled": saved, "usd": cost.total}
        print(f"{name:26s} {wall:6.2f}s  tasks={res.tasks:5d}  "
              f"filled={saved:5.1%}  {mps:6.2f} MP/s  "
              f"${cost.total:.6f}  "
              f"{price_performance(mps, cost):8.2f} MP/s/$")

    chars = " .:-=+*#%@"
    step_y = max(1, oracle.shape[0] // 32)
    step_x = max(1, oracle.shape[1] // 64)
    for row in oracle[::step_y, ::step_x]:
        print("".join(chars[min(int(v) * len(chars) // (max_dwell + 1),
                                len(chars) - 1)] for v in row))
    if out is not None:
        np.save(out, oracle)
        print(f"dwell map saved to {out}")
    report["out"] = out
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    ap.add_argument("--side", type=int, default=256)
    ap.add_argument("--out", default="mandelbrot_dwell.npy")
    args = ap.parse_args()
    main(args.device, side=args.side, out=args.out)
