"""Provider calibration — fit a :class:`ProviderModel` from a pool's own
timeline.

Barcelona-Pons & García-López (PAPERS.md) characterize FaaS platforms
entirely from recorded invocation timelines — cold-start distributions,
burst size, ramp slope.  :func:`fit_provider` runs the same estimators
over *our* traces, so a pool can be driven once against a real (or
simulated) platform and every later run — and every :mod:`.replay`
what-if — uses the fitted model instead of vendor folklore:

* **warm / cold overhead** — per-attempt duration is
  ``overhead + body``; regressing duration on ``cost_hint`` separately
  for cold-started and warm attempts gives two intercepts: the warm
  intercept is ``warm_overhead_s``, the cold-warm intercept gap is
  ``cold_start_s``.
* **burst + ramp** — under saturating demand the running maximum of
  active tasks hugs the platform envelope
  ``allowed(t) = burst + ramp/60 * t``; a least-squares line through
  the new-maximum points recovers both.  (With demand that never
  saturates, the envelope is workload-shaped — the fit reports what it
  saw, so calibrate from a saturating run.)
* **keep-alive** — the largest idle gap that still produced a warm
  reuse on the same container label is a lower bound on the platform's
  keep-alive window (observable on traces whose worker labels carry
  container identity, e.g. ``sim-pool-c17``).

Estimates that a timeline cannot witness (billing granularity, memory)
keep the default platform values.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

from ..core.provider import ProviderModel
from ..core.telemetry import (COLD_START, COMPLETE, REQUEUE, START,
                              Event, EventLog)
from .store import iter_trace_events

__all__ = ["ProviderFit", "calibrate", "fit_provider"]


@dataclass
class ProviderFit:
    """A fitted model plus the evidence behind each estimate."""

    model: ProviderModel
    n_tasks: int = 0
    n_cold: int = 0
    n_warm: int = 0
    warm_overhead_s: float = 0.0
    cold_start_s: float = 0.0
    burst_concurrency: int = 0
    scaling_ramp_per_min: float = 0.0
    keep_alive_lower_bound_s: Optional[float] = None
    envelope_points: int = 0

    def as_dict(self) -> dict:
        return {
            "n_tasks": self.n_tasks, "n_cold": self.n_cold,
            "n_warm": self.n_warm,
            "warm_overhead_s": self.warm_overhead_s,
            "cold_start_s": self.cold_start_s,
            "burst_concurrency": self.burst_concurrency,
            "scaling_ramp_per_min": self.scaling_ramp_per_min,
            "keep_alive_lower_bound_s": self.keep_alive_lower_bound_s,
            "envelope_points": self.envelope_points,
        }


def _intercept(hints: List[float], durs: List[float]) -> Optional[float]:
    """Least-squares intercept of duration ~ cost_hint; falls back to
    the minimum duration when the hints carry no spread."""
    if not durs:
        return None
    if len(durs) >= 2 and max(hints) > min(hints):
        slope, intercept = np.polyfit(np.asarray(hints, float),
                                      np.asarray(durs, float), 1)
        if math.isfinite(intercept):
            return float(intercept)
    return float(min(durs))


def calibrate(trace: Union[EventLog, Iterable[Event]], *,
              base: Optional[ProviderModel] = None,
              name: str = "fitted") -> ProviderFit:
    """Estimate a provider model from a timeline.  ``base`` supplies the
    unobservable fields (billing granularity, memory, rate limit);
    defaults to :meth:`ProviderModel.aws_lambda`."""
    base = base or ProviderModel.aws_lambda()
    cold_ids = set()
    cold_pts: Tuple[List[float], List[float]] = ([], [])
    warm_pts: Tuple[List[float], List[float]] = ([], [])
    # envelope of active tasks: new running maxima (t - t0, active)
    active = 0
    run_max = 0
    t0: Optional[float] = None
    env: Dict[float, int] = {}
    # per-container reuse gaps: worker -> last completion time
    last_release: Dict[str, float] = {}
    max_warm_gap: Optional[float] = None
    n_tasks = 0
    for ev in iter_trace_events(trace):
        if ev.kind == COLD_START and ev.task_id is not None:
            cold_ids.add(ev.task_id)
        elif ev.kind == START:
            if t0 is None:
                t0 = ev.t
            active += 1
            if active > run_max:
                run_max = active
                t = ev.t - t0
                env[t] = max(env.get(t, 0), active)
            if ev.worker is not None:
                rel = last_release.pop(ev.worker, None)
                if rel is not None and ev.task_id not in cold_ids:
                    gap = ev.t - rel
                    if gap > 0 and (max_warm_gap is None
                                    or gap > max_warm_gap):
                        max_warm_gap = gap
        elif ev.kind == REQUEUE:
            # a transient attempt freed its slot (telemetry counts it
            # as a decrement too); ignoring it would drift the active
            # counter up and inflate the fitted burst/ramp envelope
            active -= 1
            if ev.worker is not None:
                last_release[ev.worker] = ev.t
        elif ev.kind == COMPLETE:
            active -= 1
            if ev.worker is not None:
                last_release[ev.worker] = ev.t
            if ev.record is not None:
                n_tasks += 1
                grp = (cold_pts if ev.record.task_id in cold_ids
                       else warm_pts)
                grp[0].append(ev.record.cost_hint)
                grp[1].append(ev.record.duration)

    warm_int = _intercept(*warm_pts)
    cold_int = _intercept(*cold_pts)
    warm_overhead = max(0.0, warm_int) if warm_int is not None \
        else base.warm_overhead_s
    cold_start = (max(0.0, cold_int - (warm_int or 0.0))
                  if cold_int is not None else 0.0)

    pts = sorted(env.items())
    burst = pts[0][1] if pts else 0
    ramp_per_min = 0.0
    if len(pts) >= 3:
        ts = np.asarray([t for t, _ in pts], float)
        ms = np.asarray([m for _, m in pts], float)
        slope, intercept = np.polyfit(ts, ms, 1)
        if math.isfinite(slope) and slope > 1e-9:
            ramp_per_min = float(slope * 60.0)
            burst = max(1, int(round(intercept)))
    peak = max((m for _, m in pts), default=1)
    burst = max(1, min(int(burst) or peak, peak))

    keep_alive = base.keep_alive_s
    if max_warm_gap is not None:
        # lower bound: the platform kept containers at least this long
        keep_alive = max(max_warm_gap, 0.0)

    from dataclasses import replace
    model = replace(
        base, name=name,
        cold_start_s=cold_start,
        warm_overhead_s=warm_overhead,
        keep_alive_s=keep_alive,
        burst_concurrency=burst,
        scaling_ramp_per_min=ramp_per_min,
    )
    return ProviderFit(
        model=model, n_tasks=n_tasks,
        n_cold=len(cold_pts[1]), n_warm=len(warm_pts[1]),
        warm_overhead_s=warm_overhead, cold_start_s=cold_start,
        burst_concurrency=burst, scaling_ramp_per_min=ramp_per_min,
        keep_alive_lower_bound_s=max_warm_gap,
        envelope_points=len(pts),
    )


def fit_provider(trace: Union[EventLog, Iterable[Event]], *,
                 base: Optional[ProviderModel] = None,
                 name: str = "fitted") -> ProviderModel:
    """``fit_provider(trace) -> ProviderModel`` — the calibration entry
    point (see :func:`calibrate` for the fit diagnostics)."""
    return calibrate(trace, base=base, name=name).model
