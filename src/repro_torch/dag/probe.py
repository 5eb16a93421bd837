"""The Barcelona-Pons parallelism probe (``faas_parallelism``).

Barcelona-Pons & García-López benchmark a FaaS platform's *usable*
parallelism by firing simultaneous-invocation bursts at geometrically
increasing widths and recording how much concurrency the platform
actually delivers, how fast it ramps there, and how much of the burst
paid a cold start.  This module is that methodology as a first-class
experiment over any :class:`~repro_torch.core.pool.Pool`:

    pool = make_pool("sim", max_concurrency=4096,
                     provider=ProviderModel.gcf())
    profile = run_parallelism_probe(pool, max_width=1024)
    profile.achieved            # requested -> delivered, per burst
    fitted = profile.fit()      # ProviderModel via fit_provider

Every burst is measured from the pool's own :class:`EventLog` window —
achieved concurrency is the window's peak active count, ramp latency
the first-submit→peak delay, cold-start share the window's provision
count over the burst width.  The profile accumulates the raw events of
all bursts, so it IS an event-shaped trace: ``fit_provider(profile)``
consumes it directly, recovering the platform's burst capacity and scaling ramp from
the probe alone.

On virtual-time pools bursts are modelled no-ops of ``task_s`` virtual
seconds (cost-hint scaled); on wall pools they sleep for real.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Iterator, List, Optional

from ..core.telemetry import Event

__all__ = ["BurstMeasurement", "ParallelismProfile",
           "run_parallelism_probe", "probe_widths"]


@dataclass(frozen=True)
class BurstMeasurement:
    """One simultaneous-invocation burst, measured from the event
    window it produced."""

    requested: int          # invocations fired at once
    achieved: int           # peak concurrently-active tasks delivered
    ramp_latency_s: float   # first submit -> peak active
    cold_start_share: float  # cold provisions / requested
    t_start: float          # burst start on the pool's clock
    makespan_s: float       # burst drain time


@dataclass
class ParallelismProfile:
    """Probe output: per-burst measurements plus the raw event stream
    (iterable as events, so ``fit_provider(profile)`` works as-is)."""

    pool: str = ""
    bursts: List[BurstMeasurement] = field(default_factory=list)
    events: List[Event] = field(default_factory=list)

    @property
    def requested(self) -> List[int]:
        return [b.requested for b in self.bursts]

    @property
    def achieved(self) -> List[int]:
        return [b.achieved for b in self.bursts]

    def envelope_monotone(self) -> bool:
        """True when delivered concurrency never shrinks as requested
        width grows — the sanity shape of every real platform (allowed
        concurrency only ramps up over a probe's lifetime)."""
        ach = self.achieved
        return all(b >= a for a, b in zip(ach, ach[1:]))

    def iter_events(self) -> Iterator[Event]:
        return iter(self.events)

    def __iter__(self) -> Iterator[Event]:
        return iter(self.events)

    def fit(self, *, base: Optional[Any] = None,
            name: str = "probe-fit"):
        """Calibrate a ``ProviderModel`` from the probe's own events —
        the probe→``fit_provider`` recipe in one call."""
        from ..trace.calibrate import fit_provider
        return fit_provider(self, base=base, name=name)


def probe_widths(max_width: int, *, start: int = 1,
                 factor: int = 2) -> List[int]:
    """Geometric burst schedule: ``start, start*factor, ...`` capped at
    (and always including) ``max_width``."""
    if max_width < 1 or start < 1 or factor < 2:
        raise ValueError("probe_widths needs max_width/start >= 1 "
                         "and factor >= 2")
    widths = []
    w = start
    while w < max_width:
        widths.append(w)
        w *= factor
    widths.append(max_width)
    return widths


def _noop() -> None:
    return None


def run_parallelism_probe(
    pool: Any,
    *,
    max_width: int = 256,
    start: int = 1,
    factor: int = 2,
    repeats_at_max: int = 0,
    task_s: float = 0.25,
) -> ParallelismProfile:
    """Fire simultaneous-invocation bursts at geometrically increasing
    widths and measure delivered parallelism from the pool's timeline.

    Each burst submits ``width`` identical ``task_s``-second no-ops at
    once, drains them fully (closed measurement — the next burst never
    overlaps), and reads its own event window.  ``repeats_at_max``
    re-fires the widest burst that many extra times: on ramp-limited
    providers the extra bursts run later on the pool's clock, so the
    delivered-concurrency envelope keeps climbing the ramp — exactly
    the signal :func:`~repro_torch.trace.calibrate.fit_provider` needs to
    recover ``burst_concurrency``/``scaling_rate_per_min`` from the
    profile.  The pool's ``max_concurrency`` should exceed
    ``max_width`` so the platform model, not the pool cap, is the
    binding limit.
    """
    log = getattr(pool, "events", None)
    if log is None:
        raise ValueError("run_parallelism_probe needs a pool with an "
                         "event log")
    virtual = getattr(pool, "virtual_time_s", None) is not None
    alpha = getattr(pool, "alpha_s_per_node", 0.0) or 0.0
    if virtual and alpha > 0:
        body, hint = _noop, task_s / alpha
    elif virtual:
        body, hint = _noop, task_s
    else:
        body, hint = (lambda: time.sleep(task_s)), task_s

    profile = ParallelismProfile(
        pool=getattr(pool, "name", type(pool).__name__))
    widths = probe_widths(max_width, start=start, factor=factor)
    widths += [max_width] * repeats_at_max
    for width in widths:
        ev_start = len(pool.events)
        t_start = pool.events.clock.now()
        futures = [pool.submit(body, cost_hint=hint)
                   for _ in range(width)]
        for f in futures:
            f.result()
        window = pool.events.tail(ev_start)
        series = window.concurrency_series()
        peak = max((v for _, v in series), default=0)
        t_first, t_last = window.span()
        t_peak = next((t for t, v in series if v == peak), t_first)
        profile.bursts.append(BurstMeasurement(
            requested=width,
            achieved=peak,
            ramp_latency_s=max(0.0, t_peak - t_first),
            cold_start_share=window.cold_starts() / width,
            t_start=t_start,
            makespan_s=max(0.0, t_last - t_first)))
        profile.events.extend(window.events())
    return profile
