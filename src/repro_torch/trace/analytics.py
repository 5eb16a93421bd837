"""Incremental, single-pass timeline analytics (tentpole part 2).

``EventLog.concurrency_series`` used to be recomputed from scratch —
sort all events by timestamp, replay the +1/-1 counter — on *every*
call: O(n log n) per read, O(n) resident.  At the ROADMAP's
million-task scale that recompute is what made timelines unusable.

:class:`TraceAnalytics` maintains every derived view **as events
append**, in one pass and O(1) amortized work per event:

* ``concurrency``   — the (t, active) curve (paper Fig. 4), capped by
  pairwise decimation past ``max_series_points`` (peaks preserved);
* ``capacity``      — the (t, capacity) resize staircase;
* ``counts`` / ``cold_starts`` / ``peak_concurrency`` / ``span``;
* per-worker utilization (busy seconds and task counts per worker).

The engine is *order-sensitive*: it folds events in arrival order, which
equals timestamp order whenever the writing clock is monotone (always
true for ``VirtualClock`` pools; true for wall-clock pools up to
scheduler jitter between ``now()`` and the log append).  ``monotone``
records whether that held; when it did not, readers fall back to the
sorted recompute so results never silently diverge.  The parity of the
two paths on monotone streams is covered by property tests.

``render_concurrency_figure`` turns any set of traces into the paper's
Fig. 4 artifact set — static-vs-dynamic concurrency curves plus the
capacity staircase — as PNG when matplotlib is importable, with CSV and
ASCII fallbacks always written (headless CI never loses the figure).
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

from ..core.telemetry import (CAPACITY_GROW, CAPACITY_SHRINK, COLD_START,
                              COMPLETE, EVENT_KINDS, REQUEUE, START,
                              Event, EventLog)

__all__ = ["TraceAnalytics", "render_concurrency_figure"]


class TraceAnalytics:
    """Running derived views over an event stream, fed one event at a
    time via :meth:`observe`.

    ``valid(n_events)`` tells a reader whether the incremental state
    covers exactly the log it is attached to (every event observed, in
    monotone timestamp order); when it does, the pre-folded series are
    the answer and no recompute happens.
    """

    def __init__(self, max_series_points: int = 1 << 20) -> None:
        if max_series_points < 4:
            raise ValueError("max_series_points must be >= 4")
        self.max_series_points = max_series_points
        self.n_observed = 0
        self.monotone = True
        self._last_t = -math.inf
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.active = 0
        self._peak: Optional[int] = None
        self.counts: Dict[str, int] = {k: 0 for k in EVENT_KINDS}
        #: (t, active) after every start/requeue/complete — decimated
        #: pairwise once past ``max_series_points`` (see ``decimated``)
        self.concurrency: List[Tuple[float, int]] = []
        self.capacity: List[Tuple[float, int]] = []
        self.decimated = False
        self._worker_started: Dict[str, float] = {}
        self.worker_busy_s: Dict[str, float] = {}
        self.worker_tasks: Dict[str, int] = {}

    # -- write side --------------------------------------------------------
    def observe(self, ev: Event) -> None:
        self.n_observed += 1
        if ev.t < self._last_t:
            self.monotone = False
        else:
            self._last_t = ev.t
        if self.t_first is None:
            self.t_first = ev.t
        self.t_last = ev.t if self.t_last is None else max(self.t_last,
                                                           ev.t)
        self.counts[ev.kind] = self.counts.get(ev.kind, 0) + 1
        if ev.kind == START:
            self.active += 1
            self._append_concurrency(ev.t)
            if ev.worker is not None:
                self._worker_started[ev.worker] = ev.t
                self.worker_tasks[ev.worker] = \
                    self.worker_tasks.get(ev.worker, 0) + 1
        elif ev.kind in (COMPLETE, REQUEUE):
            self.active -= 1
            self._append_concurrency(ev.t)
            if ev.worker is not None:
                t0 = self._worker_started.pop(ev.worker, None)
                if t0 is not None:
                    self.worker_busy_s[ev.worker] = \
                        self.worker_busy_s.get(ev.worker, 0.0) \
                        + max(0.0, ev.t - t0)
        elif ev.kind in (CAPACITY_GROW, CAPACITY_SHRINK):
            if ev.capacity is not None:
                self.capacity.append((ev.t, ev.capacity))
                if len(self.capacity) > self.max_series_points:
                    self.capacity = _decimate(self.capacity)

    @property
    def peak_concurrency(self) -> int:
        """Max over the series points — matches the recompute exactly
        (0 on an empty timeline)."""
        return 0 if self._peak is None else self._peak

    def _append_concurrency(self, t: float) -> None:
        # the peak is over *series points*, exactly like the recompute
        self._peak = (self.active if self._peak is None
                      else max(self._peak, self.active))
        self.concurrency.append((t, self.active))
        if len(self.concurrency) > self.max_series_points:
            # halve resolution, keeping each pair's extremum so the
            # envelope (what Fig. 4 shows) survives the decimation
            self.concurrency = _decimate(self.concurrency)
            self.decimated = True

    # -- read side ---------------------------------------------------------
    def valid(self, n_events: int) -> bool:
        """True when the incremental series answer for a log of
        ``n_events`` events: everything observed, timestamps monotone."""
        return self.monotone and self.n_observed == n_events

    def span(self) -> Tuple[float, float]:
        if self.t_first is None:
            return (0.0, 0.0)
        return (self.t_first, self.t_last)

    @property
    def cold_starts(self) -> int:
        return self.counts.get(COLD_START, 0)

    def utilization(self) -> Dict[str, float]:
        """Busy fraction per worker over the trace span (workers still
        mid-task contribute their completed attempts only)."""
        t0, t1 = self.span()
        dt = t1 - t0
        if dt <= 0:
            return {w: 0.0 for w in self.worker_busy_s}
        return {w: busy / dt for w, busy in self.worker_busy_s.items()}

    def summary(self) -> dict:
        util = self.utilization()
        return {
            "events": self.n_observed,
            "monotone": self.monotone,
            "span_s": round(self.span()[1] - self.span()[0], 6),
            "peak_concurrency": self.peak_concurrency,
            "cold_starts": self.cold_starts,
            "workers": len(self.worker_tasks),
            "mean_utilization": (sum(util.values()) / len(util)
                                 if util else 0.0),
            "series_points": len(self.concurrency),
            "decimated": self.decimated,
        }


def _decimate(series: List[Tuple[float, int]]) -> List[Tuple[float, int]]:
    """Halve a series pairwise, keeping each pair's extremum (the point
    farther from zero change — preserves peaks and troughs)."""
    out = []
    for i in range(0, len(series) - 1, 2):
        a, b = series[i], series[i + 1]
        out.append(b if abs(b[1]) >= abs(a[1]) else a)
    if len(series) % 2:
        out.append(series[-1])
    return out


def _minmax_decimate(series: Sequence[Tuple[float, int]],
                     buckets: int) -> List[Tuple[float, int]]:
    """Windowed min-max decimation: split the series' time span into
    ``buckets`` windows and keep each window's minimum AND maximum
    point (in chronological order, one point if they coincide).

    A pixel column of the rendered figure can show at most the
    min..max band of the samples it covers, so with ``buckets`` = the
    pixel budget the drawn envelope is EXACT while the point count
    drops from O(events) to O(2 * buckets) — billion-event renders
    stop materializing full series.  Series already within budget
    (``len <= 2 * buckets``) pass through untouched."""
    if buckets <= 0:
        raise ValueError("buckets must be positive")
    n = len(series)
    if n <= 2 * buckets:
        return list(series)
    t0 = series[0][0]
    t1 = series[-1][0]
    dt = (t1 - t0) or 1.0
    out: List[Tuple[float, int]] = []
    i = 0
    for b in range(buckets):
        # bucket b covers [t0 + b*dt/buckets, t0 + (b+1)*dt/buckets)
        end = t0 + (b + 1) * dt / buckets
        lo = hi = None
        lo_i = hi_i = -1
        j = i
        while j < n and (series[j][0] < end or b == buckets - 1):
            v = series[j][1]
            if lo is None or v < lo:
                lo, lo_i = v, j
            if hi is None or v > hi:
                hi, hi_i = v, j
            j += 1
        if lo is not None:
            if lo_i == hi_i:
                out.append(series[lo_i])
            else:
                first, second = sorted((lo_i, hi_i))
                out.append(series[first])
                out.append(series[second])
        i = j
    return out


# -- Fig. 4 renderer ----------------------------------------------------------

#: categorical palette (validated colorblind-safe order; see the repo's
#: dataviz conventions — blue/orange lead, fixed assignment, never cycled)
_SERIES_COLORS = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100",
                  "#e87ba4", "#008300", "#4a3aa7", "#e34948"]

TraceLike = Union[EventLog, Sequence[Tuple[float, int]]]


def _series_of(trace: TraceLike) -> Tuple[List[Tuple[float, int]],
                                          List[Tuple[float, int]]]:
    if hasattr(trace, "concurrency_series"):
        return (list(trace.concurrency_series()),
                list(trace.capacity_series()))
    return list(trace), []


def render_concurrency_figure(
    traces: Mapping[str, TraceLike],
    out_base: str,
    *,
    title: str = "Concurrency over time (Fig. 4)",
    ascii_width: int = 72,
    ascii_height: int = 14,
    pixel_budget: int = 2048,
) -> Dict[str, str]:
    """Emit the paper's Fig. 4 artifact set from recorded traces.

    ``traces`` maps a label (e.g. ``"static"`` / ``"dynamic"``) to an
    :class:`EventLog`/``TraceStore`` or a raw ``(t, active)`` series.
    Always writes ``<out_base>.csv`` (tidy long format) and
    ``<out_base>.txt`` (ASCII overview); additionally writes
    ``<out_base>.png`` — concurrency curves over the capacity staircase,
    one axis, direct-labeled — when matplotlib is importable.  Returns
    ``{kind: path}`` for whatever was written.

    Series longer than ``pixel_budget`` are windowed-min-max decimated
    (:func:`_minmax_decimate`) to at most 2 points per pixel column, so
    the drawn envelope stays exact while huge traces never materialize
    into the artifacts.
    """
    if not traces:
        raise ValueError("need at least one trace to render")
    data = {}
    for label, tr in traces.items():
        conc, cap = _series_of(tr)
        data[label] = (_minmax_decimate(conc, pixel_budget) if conc
                       else conc,
                       _minmax_decimate(cap, pixel_budget) if cap
                       else cap)
    os.makedirs(os.path.dirname(os.path.abspath(out_base)) or ".",
                exist_ok=True)
    artifacts: Dict[str, str] = {}

    csv_path = out_base + ".csv"
    with open(csv_path, "w") as f:
        f.write("label,series,t,value\n")
        for label, (conc, cap) in data.items():
            for t, v in conc:
                f.write(f"{label},concurrency,{t!r},{v}\n")
            for t, v in cap:
                f.write(f"{label},capacity,{t!r},{v}\n")
    artifacts["csv"] = csv_path

    txt_path = out_base + ".txt"
    with open(txt_path, "w") as f:
        f.write(title + "\n")
        for label, (conc, cap) in data.items():
            f.write(f"\n[{label}] "
                    f"peak={max((v for _, v in conc), default=0)} "
                    f"points={len(conc)} resizes={max(0, len(cap) - 1)}\n")
            f.write(_ascii_curve(conc, ascii_width, ascii_height))
    artifacts["txt"] = txt_path

    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # pragma: no cover - matplotlib genuinely absent
        return artifacts

    fig, (ax, axc) = plt.subplots(
        2, 1, figsize=(8, 5.4), sharex=True, dpi=150,
        gridspec_kw={"height_ratios": [2.4, 1.0]})
    for i, (label, (conc, cap)) in enumerate(data.items()):
        color = _SERIES_COLORS[i % len(_SERIES_COLORS)]
        if conc:
            ts = [t for t, _ in conc]
            vs = [v for _, v in conc]
            ax.plot(ts, vs, color=color, linewidth=1.4, label=label)
            k = max(range(len(vs)), key=vs.__getitem__)
            # stagger per-series annotations so equal peaks don't collide
            ax.annotate(f"{label} peak {vs[k]}", (ts[k], vs[k]),
                        textcoords="offset points",
                        xytext=(4, 4 - 12 * i),
                        fontsize=8, color="#52514e")
        if cap:
            ts = [t for t, _ in cap] + [conc[-1][0] if conc else cap[-1][0]]
            vs = [v for _, v in cap]
            axc.step(ts, vs + [vs[-1]], where="post", color=color,
                     linewidth=1.4, label=label)
    ax.set_ylabel("active tasks")
    ax.set_title(title, fontsize=10, color="#0b0b0b")
    axc.set_ylabel("capacity")
    axc.set_xlabel("time (s)")
    for a in (ax, axc):
        a.grid(True, color="#e5e4e0", linewidth=0.6)
        a.spines[["top", "right"]].set_visible(False)
        a.tick_params(labelsize=8, colors="#52514e")
    if len(data) >= 2:
        ax.legend(fontsize=8, frameon=False)
    fig.tight_layout()
    png_path = out_base + ".png"
    fig.savefig(png_path)
    plt.close(fig)
    artifacts["png"] = png_path
    return artifacts


def _ascii_curve(series: Sequence[Tuple[float, int]],
                 width: int, height: int) -> str:
    if not series:
        return "(empty trace)\n"
    t0, t1 = series[0][0], series[-1][0]
    vmax = max(v for _, v in series) or 1
    dt = (t1 - t0) or 1.0
    # max active per column — the envelope, which is what Fig. 4 shows
    cols = [0] * width
    for t, v in series:
        c = min(width - 1, int((t - t0) / dt * (width - 1)))
        cols[c] = max(cols[c], v)
    lines = []
    for row in range(height, 0, -1):
        cut = vmax * (row - 0.5) / height
        lines.append("".join("#" if c >= cut else " " for c in cols))
    lines.append("-" * width)
    lines.append(f"0..{dt:.3g}s  peak={vmax}")
    return "\n".join(lines) + "\n"
