"""Arithmetic the metric readers share, over a run's ``harness.Context``.

Every figure is over the window's tasks (bodies that ended inside it),
except the rooflines, which set the work of every task the profile saw
against the kernels' device time in the same profile.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

from .tracelib import union_s


def work_per_s(ctx) -> Optional[float]:
    """The window's tasks' work over the whole window."""
    tasks = ctx.window_tasks
    return sum(r.work for r in tasks) / ctx.window_s if tasks else None


def p95_ms(ctx) -> Optional[float]:
    """95th percentile (nearest rank) of the window's task bodies."""
    v = sorted(r.seconds for r in ctx.window_tasks)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)] * 1e3 if v else None


def pool_overhead_ms(ctx) -> Optional[float]:
    """Mean time the pool's records give a task that completed in the
    window (``pool.events``: invocation start to completion) less the mean,
    over the window's tasks, of the benchmark's span around the task body
    and of the check's hooks beside it."""
    pool = [p.end_time - p.start_time for p in ctx.pool_records
            if ctx.t0 <= p.end_time <= ctx.t1]
    bodies = [r.seconds + r.hook_s for r in ctx.window_tasks]
    if not pool or not bodies:
        return None
    return (sum(pool) / len(pool) - sum(bodies) / len(bodies)) * 1e3


def launches_per_task(ctx, ops: Sequence[str]) -> Optional[float]:
    """Kernel launches of ``ops`` over the window, a task counted."""
    n = len(ctx.window_tasks)
    return sum(ctx.launches.get(op, 0) for op in ops) / n if n else None


def idle_share(ctx) -> Optional[float]:
    """1 - (device busy in the window) / window, from the profiler."""
    if ctx.trace is None:
        return None
    return 1.0 - union_s(ctx.trace.spans(), ctx.t0, ctx.t1) / ctx.window_s


def roofline_pct(ctx, kernels: Sequence[str], least_s: float
                 ) -> Optional[float]:
    """``least_s`` over the union of the named kernels' device time in the
    profile, in percent."""
    if ctx.trace is None:
        return None
    busy = union_s([s for k in kernels for s in ctx.trace.spans(k)])
    return 100.0 * least_s / busy if busy > 0 and least_s > 0 else None
