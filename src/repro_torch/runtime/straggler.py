"""Straggler mitigation by speculative re-dispatch.

Stateless tasks (the paper's §3.3 property) make duplication free of
coordination: if a task exceeds an adaptive deadline (p50 x factor, or
an absolute floor while quantiles warm up), clone it onto another
worker; ``ElasticFuture`` keeps the first completion and ignores the
rest.  This is the executor-level twin of backup tasks in MapReduce —
and on a pod it is how the elastic batcher sheds slow serving replicas.

A copy of ``repro.runtime.straggler`` with one fix: ``submit`` keeps the
driver's ``parent=`` tag out of the arguments a clone passes to the task
function.  The reference passes it on, so under ``run_irregular`` every
clone raises ``TypeError`` (its retries then fail it) and only the
original can win.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

from ..core.executor import BaseExecutor
from ..core.futures import ElasticFuture
from ..core.pool import Pool

__all__ = ["SpeculativeExecutor"]


@dataclass
class _Watch:
    future: ElasticFuture
    fn: Callable
    args: tuple
    kwargs: dict
    submitted: float
    duplicated: bool = False


@dataclass
class _BatchWatch:
    """A fused ``submit_batch`` carrier under watch: if the carrier
    straggles, the *remaining items* (children not yet settled) are
    re-dispatched individually (ROADMAP: batch-remainder
    speculation)."""

    children: List[ElasticFuture]
    items: list
    item_fn: Callable
    submitted: float
    respawned: bool = False

    def remaining(self):
        return [(c, it) for c, it in zip(self.children, self.items)
                if not c.done()]


class SpeculativeExecutor(Pool):
    """Wraps any pool with deadline-based task duplication.

    Satisfies the unified ``Pool`` contract itself (registered with
    ``make_pool`` as ``"speculative"``), so it composes transparently
    with ``run_irregular`` and the stats/records/events surface of the
    inner backend.  Batching, capacity, and resize forward to the
    inner pool — ``speculative(sim)`` / ``speculative(local)`` still
    fuse batches instead of silently decomposing, and the driver's
    chunk sizing sees the true inner width rather than a
    ``max_concurrency`` fallback of 1."""

    kind = "speculative"

    def __init__(self, inner: BaseExecutor, *,
                 factor: float = 3.0, floor_s: float = 0.5,
                 poll_s: float = 0.05, max_duplicates: int = 1):
        self.inner = inner
        self.remote = getattr(inner, "remote", False)
        self.factor = factor
        self.floor_s = floor_s
        self.poll_s = poll_s
        self.max_duplicates = max_duplicates
        self.duplicates = 0
        self.wins_by_clone = 0
        self.batch_respawns = 0   # straggling carriers re-dispatched
        self._watches: List[_Watch] = []
        self._batch_watches: List[_BatchWatch] = []
        self._durations: List[float] = []
        self._lock = threading.Lock()
        self._stop = False
        self._thread = threading.Thread(target=self._watchdog, daemon=True)
        self._thread.start()

    # -- public API ---------------------------------------------------------
    def submit(self, fn: Callable, *args: Any, cost_hint: float = 1.0,
               parent: Optional[int] = None, **kwargs: Any) -> ElasticFuture:
        # ``parent`` tags the task on the pool's timeline and is not an
        # argument of ``fn``: the watch keeps it out, so that a clone calls
        # ``fn`` as the inner pool does
        f = self.inner.submit(fn, *args, cost_hint=cost_hint, parent=parent,
                              **kwargs)
        with self._lock:
            self._watches.append(_Watch(f, fn, args, kwargs,
                                        time.monotonic()))
        return f

    @property
    def stats(self):
        return self.inner.stats

    @property
    def events(self):
        return self.inner.events

    @property
    def supports_batching(self) -> bool:
        return self.inner.supports_batching

    @property
    def max_concurrency(self) -> int:
        return self.inner.capacity

    @property
    def capacity(self) -> int:
        return self.inner.capacity

    @property
    def provider(self):
        return getattr(self.inner, "provider", None)

    @property
    def virtual_time_s(self):
        """Virtual makespan when wrapping a sim pool (None otherwise),
        so the driver bills speculative(sim) in virtual time too."""
        return getattr(self.inner, "virtual_time_s", None)

    def resize(self, capacity: int) -> None:
        self.inner.resize(capacity)

    def submit_batch(self, batch_fn, items, **kw):
        """Fusing inner pools take the whole batch as one invocation;
        the *carrier* goes under batch watch: when it straggles, the
        remaining (unsettled) items are re-dispatched individually —
        fused items no longer escape speculation, they just speculate
        at remainder granularity.  Decomposing inners fall back to the
        per-item path through ``self.submit`` so every item stays under
        the ordinary per-task watchdog."""
        items = list(items)
        if self.inner.supports_batching and len(items) > 1:
            children = self.inner.submit_batch(batch_fn, items, **kw)
            item_fn = kw.get("item_fn")
            if item_fn is None:
                def item_fn(item):
                    return batch_fn([item])[0]
            with self._lock:
                self._batch_watches.append(_BatchWatch(
                    children, items, item_fn, time.monotonic()))
            return children
        # decomposed (or single-item) path goes through self.submit, so
        # every item is individually watched
        return super().submit_batch(batch_fn, items, **kw)

    def pending(self) -> int:
        return self.inner.pending()

    def idle_capacity(self) -> int:
        return self.inner.idle_capacity()

    def shutdown(self, wait: bool = True) -> None:
        self._stop = True
        self.inner.shutdown(wait=wait)

    # -- watchdog -------------------------------------------------------------
    def _clone_penalty(self) -> float:
        """Expected extra overhead a speculative duplicate pays before
        it can race: on a provider-modelled pool with no warm container
        idle, the full cold-start latency (ROADMAP: provider-aware
        speculation).  Added to the deadline so clones only launch when
        they can still win."""
        provider = self.provider
        if provider is None:
            return 0.0
        fleet = getattr(self.inner, "_fleet", None)
        if fleet is None:
            warm = 0
        else:
            # ask in the inner pool's time domain: a virtual fleet holds
            # virtual release timestamps, so a wall timestamp would make
            # every warm container look keep-alive-expired
            clock = getattr(self.inner, "clock", None)
            now = clock.now() if clock is not None else time.monotonic()
            warm = fleet.warm_count(now)
        return provider.expected_clone_overhead(warm_available=warm > 0)

    def _base_deadline(self) -> float:
        """Quantile-derived per-task deadline, without the clone
        penalty (which is a one-time cost and must not be scaled by
        batch size)."""
        with self._lock:
            if len(self._durations) < 5:
                return max(self.floor_s, 1e9 if not self._durations
                           else self.factor * max(self._durations))
            xs = sorted(self._durations)
            p50 = xs[len(xs) // 2]
            return max(self.floor_s, self.factor * p50)

    def _deadline(self) -> float:
        return self._base_deadline() + self._clone_penalty()

    def _watchdog(self) -> None:
        while not self._stop:
            time.sleep(self.poll_s)
            now = time.monotonic()
            base = self._base_deadline()
            penalty = self._clone_penalty()
            deadline = base + penalty
            with self._lock:
                live = []
                to_clone = []
                for w in self._watches:
                    if w.future.done():
                        self._durations.append(now - w.submitted)
                        if len(self._durations) > 512:
                            del self._durations[:256]
                        continue
                    if (not w.duplicated
                            and now - w.submitted > deadline):
                        w.duplicated = True
                        to_clone.append(w)
                    live.append(w)
                self._watches = live
                live_b = []
                to_respawn = []
                for bw in self._batch_watches:
                    n_items = max(1, len(bw.items))
                    if all(c.done() for c in bw.children):
                        # feed the quantiles a per-item sample so
                        # pure-batch workloads still learn a deadline
                        self._durations.append(
                            (now - bw.submitted) / n_items)
                        if len(self._durations) > 512:
                            del self._durations[:256]
                        continue
                    # a fused carrier runs its items serially — the
                    # per-item bar scales with the batch — but the
                    # clone penalty is a one-time cost, added once
                    if (not bw.respawned
                            and now - bw.submitted
                            > base * n_items + penalty):
                        bw.respawned = True
                        to_respawn.append(bw)
                    live_b.append(bw)
                self._batch_watches = live_b
            for w in to_clone:
                if self.duplicates - self.wins_by_clone \
                        >= self.max_duplicates * 8:
                    continue  # bound clone storms
                self.duplicates += 1
                self._clone(w)
            for bw in to_respawn:
                self._respawn_remainder(bw)

    def _clone(self, w: _Watch) -> None:
        target = w.future

        def run_clone():
            result = w.fn(*w.args, **w.kwargs)
            if not target.done():
                self.wins_by_clone += 1
                target._set_result(result)
            return result

        try:
            self.inner.submit(run_clone)
        except RuntimeError:
            pass  # executor shutting down

    def _respawn_remainder(self, bw: _BatchWatch) -> None:
        """Re-dispatch the unsettled items of a straggling fused batch
        as individual tasks.  Each clone resolves its own child future;
        first settlement wins, so a late carrier fan-out is a no-op for
        items the remainder already delivered (and vice versa)."""
        remaining = bw.remaining()
        if not remaining:
            return
        issued = 0
        for child, item in remaining:
            # same clone-storm bound as per-task speculation, enforced
            # per clone — a huge remainder must not flood the pool
            if self.duplicates - self.wins_by_clone \
                    >= self.max_duplicates * 8:
                break
            self.duplicates += 1
            issued += 1

            def run_clone(child=child, item=item):
                result = bw.item_fn(item)
                if not child.done():
                    self.wins_by_clone += 1
                    child._set_result(result)
                return result

            try:
                self.inner.submit(run_clone)
            except RuntimeError:
                break  # executor shutting down
        if issued:
            self.batch_respawns += 1
