"""Hybrid executor (paper §3.2, Listing 1).

Combines a local pool (the donor VM / host slice: constant, low cost) with
the elastic pool (serverless analogue: instant vertical scaling).  The
scheduling policy is the paper's naive-but-effective rule, verbatim:

    if isLocalExecutorIdle():   run locally
    else:                       run as an elastic (remote) task

Transparency: callers submit to the HybridExecutor exactly as to any other
executor; placement is invisible (Coulouris's *scaling transparency*).
Satisfies the unified ``Pool`` contract (``make_pool("hybrid", ...)``);
both sub-pools notify one shared ``ConcurrencyTracker``, so the combined
``peak_concurrency`` is the true simultaneous maximum, and ``events``
exposes a merged view of the two sub-pools' timelines — one combined
event history for characterization and cost accounting.

Elasticity follows the paper's asymmetry: the local donor VM is fixed
hardware, so ``resize`` adjusts only the elastic (serverless) side —
total capacity is ``local + elastic`` and the spill pool absorbs every
grow/shrink decision.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

from .executor import (BaseExecutor, ConcurrencyTracker, ElasticExecutor,
                       LocalExecutor)
from .futures import ElasticFuture
from .pool import Pool, register_pool
from .telemetry import CAPACITY_GROW, CAPACITY_SHRINK, EventLog

__all__ = ["HybridExecutor"]


@register_pool("hybrid")
class HybridExecutor(Pool):
    """Paper's ``ServerlessHybridExecutorService`` (Listing 1)."""

    kind = "hybrid"
    remote = True  # spill tasks are billed as remote invocations

    def __init__(
        self,
        local: Optional[LocalExecutor] = None,
        elastic: Optional[ElasticExecutor] = None,
        *,
        local_concurrency: int = 8,
        elastic_concurrency: int = 1000,
        policy: Optional[Any] = None,
        trace=None,
        faults=None,
    ) -> None:
        # a caller-supplied trace backend (repro_torch.trace.TraceStore) is
        # SHARED by both sub-pools: their lifecycles interleave on one
        # spilled timeline, which is exactly the combined history the
        # merged view reconstructs for per-log pools.  Caveat: .events
        # still materializes that timeline per access (the merged view
        # must splice aggregate capacity events in) — recording stays
        # bounded-memory, full-history *reads* do not (ROADMAP: lazy
        # merged views).  Note the raw store's capacity_series mixes
        # sub-pool widths and lacks the aggregate announcements — only
        # .events carries the combined capacity staircase
        self._shared_trace = trace
        if trace is not None and (local is not None
                                  or elastic is not None):
            raise ValueError(
                "trace= applies only to sub-pools the hybrid constructs "
                "itself; pre-built pools already own their logs")
        # faults (a repro_torch.chaos.FaultPlan) applies to sub-pools the
        # hybrid constructs itself, like trace=; pre-built pools carry
        # their own
        self.local = local or LocalExecutor(local_concurrency,
                                            trace=trace, faults=faults)
        self.elastic = elastic or ElasticExecutor(elastic_concurrency,
                                                  trace=trace,
                                                  faults=faults)
        # Placement policy, chosen per task: either a
        # repro_torch.chaos.routing.RoutingPolicy (object with
        # ``route(hybrid, cost_hint=...) -> bool``, True = local) or a
        # legacy plain callable ``policy(hybrid) -> bool``.
        # Default = paper's Listing-1 rule.
        self._policy = policy or (lambda h: h.local.idle_capacity() > 0)
        self._lock = threading.Lock()
        self._submitted: List[ElasticFuture] = []
        # shared notification layer -> true combined active/peak
        self._tracker = ConcurrencyTracker()
        self._tracker.active = (self.local.stats.active
                                + self.elastic.stats.active)
        self.local.stats.trackers.append(self._tracker)
        self.elastic.stats.trackers.append(self._tracker)
        # aggregate capacity announcements live on the hybrid's own log
        # (sub-pool events carry sub-pool capacities); merged after the
        # sub-logs so the combined capacity is the series' last word
        self._log = EventLog()
        self._log.emit(CAPACITY_GROW, capacity=self.capacity)

    # -- the paper's submit(), lines 7-27 of Listing 1 ---------------------
    def submit(self, fn: Callable[..., Any], *args: Any,
               cost_hint: float = 1.0, **kwargs: Any) -> ElasticFuture:
        if fn is None:
            raise TypeError("task must not be None")
        with self._lock:  # placement decision must see a consistent view
            route = getattr(self._policy, "route", None)
            if route is not None:
                # first-class RoutingPolicy: per-task decision with the
                # task's cost_hint in hand
                run_local = route(self, cost_hint=cost_hint)
            else:
                run_local = self._policy(self)  # legacy plain callable
            pool: BaseExecutor = self.local if run_local else self.elastic
            f = pool.submit(fn, *args, cost_hint=cost_hint, **kwargs)
            self._submitted.append(f)
            return f

    # -- introspection -----------------------------------------------------
    @property
    def stats(self) -> "_CombinedStats":
        return _CombinedStats(self.local.stats, self.elastic.stats,
                              self._tracker)

    @property
    def events(self) -> EventLog:
        """Merged timeline over the local + elastic sub-pools — the
        true combined concurrency/cost history.  Sub-pool capacity
        events are dropped (they carry sub-pool widths); the hybrid's
        own aggregate announcements stand in for them, keeping
        ``capacity_series()`` in one unit."""
        if self._shared_trace is not None:
            # one interleaved timeline already: just drop the sub-pool
            # capacity announcements and splice in the aggregate ones
            merged = EventLog.merged(
                [self._shared_trace],
                exclude_kinds=(CAPACITY_GROW, CAPACITY_SHRINK))
        else:
            merged = EventLog.merged(
                [self.local.stats.log, self.elastic.stats.log],
                exclude_kinds=(CAPACITY_GROW, CAPACITY_SHRINK))
        return EventLog.merged([merged, self._log])

    @property
    def capacity(self) -> int:
        return self.local.max_concurrency + self.elastic.max_concurrency

    def resize(self, capacity: int) -> None:
        """Resize total capacity; the local donor VM is fixed hardware,
        so the elastic side absorbs the whole delta (floor 1)."""
        old = self.capacity
        self.elastic.resize(max(1, capacity - self.local.max_concurrency))
        new = self.capacity
        if new != old:
            self._log.emit(CAPACITY_GROW if new > old else CAPACITY_SHRINK,
                           capacity=new)

    def placement_counts(self) -> dict:
        return {
            "local": self.local.stats.submitted,
            "elastic": self.elastic.stats.submitted,
        }

    def idle_capacity(self) -> int:
        return self.local.idle_capacity() + self.elastic.idle_capacity()

    def pending(self) -> int:
        return self.local.pending() + self.elastic.pending()

    def shutdown(self, wait: bool = True) -> None:
        self.local.shutdown(wait=wait)
        self.elastic.shutdown(wait=wait)


class _CombinedStats:
    """Aggregate stats view over the local + elastic pools."""

    def __init__(self, a, b, tracker: Optional[ConcurrencyTracker] = None):
        self._a, self._b = a, b
        self._tracker = tracker

    @property
    def submitted(self):
        return self._a.submitted + self._b.submitted

    @property
    def completed(self):
        return self._a.completed + self._b.completed

    @property
    def failed(self):
        return self._a.failed + self._b.failed

    @property
    def retries(self):
        return self._a.retries + self._b.retries

    @property
    def active(self):
        return self._a.active + self._b.active

    @property
    def invocations(self):
        return self._a.invocations + self._b.invocations

    @property
    def cold_starts(self):
        return self._a.cold_starts + self._b.cold_starts

    @property
    def worker_deaths(self):
        return self._a.worker_deaths + self._b.worker_deaths

    @property
    def throttled(self):
        return self._a.throttled + self._b.throttled

    @property
    def cancelled(self):
        return self._a.cancelled + self._b.cancelled

    @property
    def peak_concurrency(self):
        if self._tracker is not None:
            # true combined peak via the shared notification layer
            return self._tracker.peak
        return self._a.peak_concurrency + self._b.peak_concurrency

    @property
    def records(self):
        return self._a.records + self._b.records

    def snapshot(self) -> dict:
        return {
            "submitted": self.submitted, "completed": self.completed,
            "failed": self.failed, "retries": self.retries,
            "active": self.active,
            "invocations": self.invocations,
            "cold_starts": self.cold_starts,
            "worker_deaths": self.worker_deaths,
            "throttled": self.throttled,
            "cancelled": self.cancelled,
            "peak_concurrency": self.peak_concurrency,
        }
