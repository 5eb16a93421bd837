"""Readers of the program's spans over a run's ``harness.Context``: the
master loop's, the pool's, the dispatch path's and the device's share of
the window, and the device's idle time put down to what the host was
doing.

The program records spans in ``repro_torch.core.telemetry`` (``Span``:
name, start, end, task id, thread) on ``time.monotonic``, the clock that
``tracelib.DeviceTrace`` ties the device's times to.  A reader finds them
as ``ctx.spans``; where that is missing or None (a harness that records
none, a program with no recorder) every reader returns None.

The trace's marker kernels do not tie the clocks closely enough to set a
span beside a device gap, both of about a millisecond: on an H100 the
trace's times came out 0.4-0.5 ms early, and in some runs the error grew
by up to 0.35 ms a second for several seconds, to 2.8 ms, before it fell
back.  So the readers that set spans against device intervals first
shift the intervals onto the spans' clock by :func:`clock_shift`, bounded
on both sides by the program's own spans, stretch by stretch of the
trace: the k-th ``uts_expand_kernel`` to start cannot start before k
``uts.launch`` spans have begun, and the j-th to end cannot end after the
j-th ``uts.wait`` has ended.

Spans nest on a thread: ``master.fold`` holds the ``master.split`` and
``master.dispatch`` of its completion, a task body (between a worker's
``pool.invoke`` and ``pool.settle``) holds its ``uts.*`` launch spans.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .tracelib import Span, gaps, merge, union_s

__all__ = ["IDLE_ORDER", "LAUNCH_PATH", "KERNEL", "SHIFT_WINDOW",
           "SHIFT_BRACKET", "clock_shift",
           "idle_in_sync_share", "launch_host_ms", "pool_settle_ms",
           "master_busy_share", "idle_by_span", "with_idle_by_span"]

#: the order in which an instant of device idle is put down to a span:
#: the first of these that some thread is inside
IDLE_ORDER = ("uts.wait", "uts.stage_in", "uts.launch", "uts.leftover",
              "pool.settle", "pool.invoke", "master.close", "master.seed",
              "master.split", "master.dispatch", "master.fold")
#: a UTS launch's host work, its wait for the card left out
LAUNCH_PATH = ("uts.stage_in", "uts.launch", "uts.leftover")
#: the kernel each ``uts.launch`` launches once
KERNEL = "uts_expand_kernel"
#: seconds of trace over which :func:`clock_shift` bounds the shift at
#: once: short against the drift above, long enough to hold some
#: hundred launches of the UTS cell
SHIFT_WINDOW = 0.25
#: widest gap between a stretch's two bounds for its middle to be taken
#: (the UTS cell's are 0.05-1 ms wide; wider ones come from stretches
#: with few launches, and the clock's jumps make them cross)
SHIFT_BRACKET = 1e-3


def _spans(ctx) -> Optional[list]:
    return getattr(ctx, "spans", None)


def _intervals(spans, names: Sequence[str]) -> List[Span]:
    return [(s[1], s[2]) for s in spans if s[0] in names]


def _intersect(a: List[Span], b: List[Span]) -> List[Span]:
    """The overlap of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _seconds(spans: List[Span]) -> float:
    return sum(b - a for a, b in spans)


def _window_ids(ctx) -> set:
    """Task ids of the pool's records that ended in the window."""
    return {p.task_id for p in ctx.pool_records
            if ctx.t0 <= p.end_time <= ctx.t1}


def clock_shift(ctx) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """``(times, shifts)``: the seconds to add to the trace's times to put
    them on the spans' clock, at the middles of the stretches of
    :data:`SHIFT_WINDOW` seconds (from the trace's first
    ``uts_expand_kernel``) whose kernels bound it on both sides within
    :data:`SHIFT_BRACKET`, by the counting argument of the module's
    docstring: the middle of the two bounds.  None where no stretch does,
    or where the kernels and the ``uts.launch`` and ``uts.wait`` spans
    differ in number, as when spans were recorded over part of the trace
    only."""
    spans = _spans(ctx)
    if spans is None or ctx.trace is None:
        return None
    kernels = np.array(ctx.trace.spans(KERNEL), float).reshape(-1, 2)
    launched = np.sort([s[1] for s in spans if s[0] == "uts.launch"])
    waited = np.sort([s[2] for s in spans if s[0] == "uts.wait"])
    if not len(kernels) or not len(kernels) == len(launched) == len(waited):
        return None
    starts, ends = np.sort(kernels[:, 0]), np.sort(kernels[:, 1])
    first, window = starts[0], SHIFT_WINDOW
    n = int((ends[-1] - first) // window) + 1
    lo, hi = np.full(n, -np.inf), np.full(n, np.inf)
    np.maximum.at(lo, ((starts - first) // window).astype(int),
                  launched - starts)
    np.minimum.at(hi, ((ends - first) // window).astype(int), waited - ends)
    good = np.abs(hi - lo) <= SHIFT_BRACKET
    if not good.any():
        return None
    times = first + window * (np.arange(n) + 0.5)
    return times[good], (lo[good] + hi[good]) / 2


def _device_idle(ctx) -> Optional[List[Span]]:
    """The window's device gaps, each device interval shifted by
    :func:`clock_shift` at its start (taken between the stretches that
    give it); None where that cannot be had."""
    shift = clock_shift(ctx)
    if shift is None:
        return None
    dev = np.array(ctx.trace.spans(), float).reshape(-1, 2)
    dev += np.interp(dev[:, 0], *shift)[:, None]
    return gaps(dev.tolist(), ctx.t0, ctx.t1)


def idle_in_sync_share(ctx) -> Optional[float]:
    """Seconds of the window in which the device is idle while some thread
    is inside ``uts.wait`` (the card done, the host not yet back), over
    the window."""
    idle = _device_idle(ctx)
    if idle is None:
        return None
    waits = merge(_intervals(ctx.spans, ("uts.wait",)))
    return _seconds(_intersect(idle, waits)) / ctx.window_s


def launch_host_ms(ctx) -> Optional[float]:
    """Mean over the window's tasks (pool records that ended in the
    window) of the summed ``uts.stage_in``, ``uts.launch`` and
    ``uts.leftover`` of each, in ms."""
    spans = _spans(ctx)
    if spans is None:
        return None
    ids = _window_ids(ctx)
    own = [s[2] - s[1] for s in spans
           if s[0] in LAUNCH_PATH and s[3] in ids]
    return sum(own) / len(ids) * 1e3 if own else None


def pool_settle_ms(ctx) -> Optional[float]:
    """Mean ``pool.settle`` of the window's tasks, in ms: a body's return
    to its future settled (slot released, record and event written, the
    master woken)."""
    spans = _spans(ctx)
    if spans is None:
        return None
    ids = _window_ids(ctx)
    own = [s[2] - s[1] for s in spans
           if s[0] == "pool.settle" and s[3] in ids]
    return sum(own) / len(own) * 1e3 if own else None


def master_busy_share(ctx) -> Optional[float]:
    """The union of the master's spans but its wait on completions,
    within the window, over the window."""
    spans = _spans(ctx)
    if spans is None:
        return None
    busy = [(s[1], s[2]) for s in spans
            if s[0].startswith("master.") and s[0] != "master.wait"]
    if not busy:
        return None
    return union_s(busy, ctx.t0, ctx.t1) / ctx.window_s


def idle_by_span(ctx) -> Optional[Dict[str, float]]:
    """The window's device idle in seconds by the first span of
    :data:`IDLE_ORDER` some thread is inside at each instant, and under
    ``none`` where no thread is inside any; the values sum to the idle."""
    left = _device_idle(ctx)
    if left is None:
        return None
    out: Dict[str, float] = {}
    for name in IDLE_ORDER:
        cover = merge(_intervals(ctx.spans, (name,)))
        out[name] = _seconds(_intersect(left, cover))
        left = _intersect(left, gaps(cover, ctx.t0, ctx.t1))
    out["none"] = _seconds(left)
    return out


def with_idle_by_span(breakdown: Dict[str, list], ctx,
                      most: int = 10) -> Dict[str, list]:
    """``breakdown`` (the harness's: ``all:`` totals first, then the
    longest gaps) with ``span:<name>`` entries, largest first, after the
    ``all:`` ones, and the longest gaps after them up to ``most`` entries
    in all.  Unchanged where :func:`idle_by_span` finds nothing."""
    by_span = idle_by_span(ctx)
    if by_span is None:
        return breakdown
    idle = breakdown["idle_gaps"]
    head = [e for e in idle if e[0].startswith("all:")]
    longest = [e for e in idle if not e[0].startswith("all:")]
    head += [[f"span:{k}", v] for k, v in
             sorted(by_span.items(), key=lambda kv: -kv[1]) if v > 0]
    return {**breakdown,
            "idle_gaps": head + longest[:max(0, most - len(head))]}
