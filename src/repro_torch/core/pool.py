"""Unified executor-pool abstraction and backend registry.

The paper's claim is that *one* serverless executor-pool abstraction
suffices to run all three irregular workloads with no user-facing
tuning.  This module is that abstraction's single public surface:

* :class:`Pool` — the lifecycle contract every backend satisfies:
  ``submit`` / ``map`` / ``pending`` / ``idle_capacity`` / ``resize`` /
  ``capacity`` / ``stats`` / ``events`` / ``records`` / ``snapshot`` /
  ``shutdown`` / context manager.
* :func:`make_pool` — construct any registered backend by name::

      with make_pool("elastic", max_concurrency=16) as pool:
          pool.map(fn, items)

Registered backends:

==============  ====================================================
``local``       host thread pool (paper's "parallel VM", ~18 us)
``elastic``     ServerlessExecutor analogue (FaaS overhead + limits)
``hybrid``      local-first spill-to-elastic (Listing 1)
``sim``         virtual-time discrete-event pool (paper-scale figs)
``speculative`` straggler-duplicating wrapper around any of the above
==============  ====================================================

Drive any of them with ``repro_torch.core.run_irregular`` and a ``WorkSpec``.
"""
from __future__ import annotations

import abc
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence

from .futures import (CompletionQueue, ElasticFuture, Task, TaskRecord,
                      TaskState)

__all__ = ["Pool", "ShardView", "make_pool", "register_pool",
           "registered_pools"]


class Pool(abc.ABC):
    """Contract shared by every executor backend.

    Subclasses provide ``submit``/``shutdown``/``pending``/
    ``idle_capacity`` and a ``stats`` object exposing ``records`` and
    ``snapshot()``; everything else (``map``, ``submit_batch``,
    ``records``, ``snapshot``, context management) is inherited.

    ``submit_batch`` is part of the contract: backends that set
    ``supports_batching`` (``local``, ``sim`` — one worker can run a
    fused body) execute the whole batch as ONE submission and fan the
    per-item results out; the rest (``elastic``, ``hybrid``,
    ``speculative`` — each FaaS invocation is a separate function)
    decompose into per-item submissions, which is exactly the per-task
    path.
    """

    #: human-readable backend kind ("local" | "elastic" | ...)
    kind: str = "abstract"
    #: whether completions are billed as remote (FaaS) invocations
    remote: bool = False
    #: whether ``submit_batch`` fuses items into one invocation natively
    supports_batching: bool = False

    @abc.abstractmethod
    def submit(self, fn: Callable[..., Any], *args: Any,
               cost_hint: float = 1.0, **kwargs: Any) -> ElasticFuture:
        """Submit a stateless task; returns its future."""

    @abc.abstractmethod
    def shutdown(self, wait: bool = True) -> None:
        """Stop accepting work; with ``wait`` drain what is queued."""

    @abc.abstractmethod
    def pending(self) -> int:
        """Tasks queued but not yet running."""

    @abc.abstractmethod
    def idle_capacity(self) -> int:
        """Free worker slots right now (drives hybrid placement)."""

    # -- elasticity surface ------------------------------------------------
    @property
    def capacity(self) -> int:
        """Current worker-slot capacity (the ``resize`` target).
        Composite pools override with their aggregate."""
        return getattr(self, "max_concurrency", 1)

    def resize(self, capacity: int) -> None:
        """Set the pool's capacity; logs a ``capacity_grow`` /
        ``capacity_shrink`` timeline event.  Every registered backend
        implements this — it is the mechanism under
        ``run_irregular``'s ``AutoscalePolicy`` hook."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support resize")

    @property
    def events(self):
        """The pool's :class:`~repro_torch.core.telemetry.EventLog` timeline
        (composite pools return a merged view)."""
        return self.stats.log

    # -- shared surface ----------------------------------------------------
    def map(self, fn: Callable[[Any], Any],
            items: Sequence[Any]) -> List[Any]:
        """Submit ``fn`` over ``items`` and return results in order.

        Failure is fail-fast but never orphaning: the first exception
        cancels every not-yet-started sibling, the already-running ones
        are drained to settlement, and only then is the exception
        re-raised — no submitted future outlives the call."""
        futures = [self.submit(fn, item) for item in items]
        cq = CompletionQueue(futures)
        first_exc: Optional[BaseException] = None
        unsettled = len(futures)
        while unsettled:
            # batched pop: one lock acquisition per ready wave, not per
            # completion (CompletionQueue.drain)
            for f in cq.drain():
                unsettled -= 1
                if first_exc is None and f.state is TaskState.FAILED:
                    first_exc = f._exc
                    # no-op on settled/running futures; each future
                    # actually cancelled lands a typed cancel event
                    self._cancel_pending(futures,
                                         parent=f._task.task_id)
        if first_exc is not None:
            raise first_exc
        return [f.result() for f in futures]

    def _cancel_pending(self, futures: Sequence[ElasticFuture],
                        parent: Optional[int] = None) -> int:
        """Cancel every not-yet-started future, stamping a ``cancel``
        timeline event (with the cancelling context's task id as
        ``parent``) per future actually cancelled — so replay /
        ``extract_workload`` see a deliberate cancellation, not a lost
        task.  Settled and running futures are untouched.  Returns how
        many were cancelled."""
        cb = getattr(self.stats, "on_cancel", None)
        n = 0
        for f in futures:
            if f.cancel():
                n += 1
                if cb is not None:
                    cb(f._task.task_id, parent)
        return n

    def _make_future(self, task: Task) -> ElasticFuture:
        """Future constructor hook — virtual-time pools override this so
        fan-out futures integrate with their event pump."""
        return ElasticFuture(task)

    def submit_batch(
        self,
        batch_fn: Callable[[List[Any]], List[Any]],
        items: Sequence[Any],
        *,
        item_fn: Optional[Callable[[Any], Any]] = None,
        cost_hints: Optional[Sequence[float]] = None,
        parent: Optional[int] = None,
    ) -> List[ElasticFuture]:
        """Submit ``items`` as one logical batch; one future per item.

        ``batch_fn(items) -> results`` is the fused body (must return
        one result per item, in order).  Backends with
        ``supports_batching`` run it as a SINGLE submission — one
        invocation billed, one worker slot — and resolve the per-item
        futures from its return value.  Backends without it decompose
        into per-item submissions of ``item_fn`` (default:
        ``batch_fn([item])[0]``), preserving exact per-task semantics.
        ``parent`` stamps the submit events' dispatch-DAG parentage
        (see ``telemetry.Event.parent``) on whichever path runs.
        """
        items = list(items)
        if not items:
            return []
        hints = (list(cost_hints) if cost_hints is not None
                 else [1.0] * len(items))
        if len(hints) != len(items):
            raise ValueError(
                f"cost_hints ({len(hints)}) and items ({len(items)}) "
                f"must align")
        if not self.supports_batching or len(items) == 1:
            if item_fn is None:
                def item_fn(item: Any) -> Any:
                    return batch_fn([item])[0]
            futures: List[ElasticFuture] = []
            try:
                for item, h in zip(items, hints):
                    futures.append(self.submit(item_fn, item,
                                               cost_hint=h,
                                               parent=parent))
            except BaseException:
                # a mid-batch throttle/shutdown must not orphan the
                # futures already submitted: cancel what never started
                # (stateless tasks — running ones just finish into the
                # stats log) before surfacing the error
                self._cancel_pending(futures, parent=parent)
                raise
            return futures

        # fused path: one carrier task, per-item futures resolved by its
        # done-callback (first settlement wins, as everywhere else)
        children = [
            # fn=None: never run — resolved by the carrier's fan-out
            self._make_future(Task(fn=None, cost_hint=h))
            for h in hints
        ]

        def carrier() -> List[Any]:
            return batch_fn(items)
        # batch-carrier marker read by fault injectors (kill_batch_rate
        # targets fused carriers; set on the fn because sim pools start
        # the task synchronously inside submit)
        carrier._repro_is_batch = True

        def fan_out(f: ElasticFuture) -> None:
            if f.state is TaskState.FAILED:
                for c in children:
                    c._set_exception(f._exc)
                return
            if f.state is TaskState.CANCELLED:
                for c in children:
                    c.cancel()
                return
            results = f._result
            if (not isinstance(results, (list, tuple))
                    or len(results) != len(items)):
                got = (len(results) if isinstance(results, (list, tuple))
                       else type(results).__name__)
                exc = TypeError(
                    f"batch body must return {len(items)} results, "
                    f"got {got}")
                for c in children:
                    c._set_exception(exc)
                return
            for c, r in zip(children, results):
                c._set_result(r)

        cf = self.submit(carrier, cost_hint=float(sum(hints)),
                         parent=parent)
        cf.add_done_callback(fan_out)
        return children

    def submit_gather(
        self,
        batch_fn: Callable[[List[Any]], List[Any]],
        items: Sequence[Any],
        *,
        item_fn: Optional[Callable[[Any], Any]] = None,
        cost_hints: Optional[Sequence[float]] = None,
        parent: Optional[int] = None,
    ) -> ElasticFuture:
        """Submit ``items`` as one batch delivered as ONE completion.

        Where :meth:`submit_batch` fans a fused carrier back out into
        one future per item (N wakeups, N completion records),
        ``submit_gather`` keeps the carrier *as* the completion: the
        returned future settles once with the ordered list of per-item
        results.  This is the batched completion-delivery primitive
        under the sharded ``run_irregular`` driver — one master wakeup
        and one event triple per wave instead of per item.

        Fusing backends (``supports_batching``) run a single carrier
        submission of ``batch_fn``; decomposing backends submit
        ``item_fn`` per item and aggregate with a countdown callback,
        so the caller still sees a single settlement.  The first item
        failure settles the gather with that exception and cancels
        not-yet-started siblings (stateless tasks — running ones just
        finish into the stats log).
        """
        items = list(items)
        if not items:
            raise ValueError("submit_gather needs at least one item")
        hints = (list(cost_hints) if cost_hints is not None
                 else [1.0] * len(items))
        if len(hints) != len(items):
            raise ValueError(
                f"cost_hints ({len(hints)}) and items ({len(items)}) "
                f"must align")

        if self.supports_batching:
            def carrier() -> List[Any]:
                results = batch_fn(items)
                if (not isinstance(results, (list, tuple))
                        or len(results) != len(items)):
                    got = (len(results)
                           if isinstance(results, (list, tuple))
                           else type(results).__name__)
                    raise TypeError(
                        f"batch body must return {len(items)} results, "
                        f"got {got}")
                return list(results)

            carrier._repro_is_batch = True  # fault injectors' marker
            return self.submit(carrier, cost_hint=float(sum(hints)),
                               parent=parent)

        # decomposing path: per-item submissions, one aggregated wakeup
        if item_fn is None:
            def item_fn(item: Any) -> Any:
                return batch_fn([item])[0]
        children: List[ElasticFuture] = []
        try:
            for item, h in zip(items, hints):
                children.append(self.submit(item_fn, item, cost_hint=h,
                                            parent=parent))
        except BaseException:
            self._cancel_pending(children, parent=parent)
            raise
        gather = self._make_future(Task(fn=None,
                                        cost_hint=float(sum(hints))))
        remaining = [len(children)]
        lock = threading.Lock()

        def on_child(f: ElasticFuture) -> None:
            if f.state is TaskState.FAILED:
                # fail-fast sibling cancel, stamped on the timeline
                # with the failing task as parent (no-op on settled/
                # running futures)
                self._cancel_pending(children, parent=f._task.task_id)
                gather._set_exception(f._exc)  # first settlement wins
            elif f.state is TaskState.CANCELLED:
                gather._set_exception(
                    RuntimeError("gathered task was cancelled"))
            with lock:
                remaining[0] -= 1
                last = remaining[0] == 0
            if last and not gather.done():
                gather._set_result([c._result for c in children])

        for c in children:
            c.add_done_callback(on_child)
        return gather

    def shard_views(self, shards: int) -> List["ShardView"]:
        """Partition this pool's capacity into ``shards`` per-shard
        views over the ONE underlying pool — and, when the pool carries
        a ``ProviderModel``, the one admission/scaling ramp.  View ``i``
        owns ``capacity/shards`` worker slots (re-sliced dynamically on
        every read, so ``resize`` redistributes across shards), and its
        submissions route trace events to shard ``i``'s segment when
        the pool records to a
        :class:`~repro_torch.trace.store.ShardedTraceStore`."""
        if shards <= 0:
            raise ValueError("shards must be positive")
        return [ShardView(self, i, shards) for i in range(shards)]

    @property
    def records(self) -> List[TaskRecord]:
        """Completion log (characterization + cost accounting)."""
        return self.stats.records

    def snapshot(self) -> dict:
        """Point-in-time counters (submitted/completed/failed/...)."""
        return self.stats.snapshot()

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.shutdown()


class ShardView:
    """One master shard's view of a shared :class:`Pool`.

    The sharded ``run_irregular`` driver partitions the frontier across
    K shards; each shard dispatches through its own view so that (a)
    its slot budget is a slice of the ONE pool's capacity — there is a
    single provider ramp and a single billing timeline, exactly as if
    one master drove the pool — and (b) its submissions are routed to
    its own trace segment when the pool records to a
    :class:`~repro_torch.trace.store.ShardedTraceStore`.

    ``slots`` is re-derived from ``pool.capacity`` on every read:
    capacity % shards extra slots go to the lowest-indexed views, and a
    ``resize`` (autoscale) redistributes automatically.  Every view
    always owns at least one slot so no shard can deadlock with work it
    cannot dispatch.
    """

    __slots__ = ("pool", "index", "shards")

    def __init__(self, pool: Pool, index: int, shards: int):
        self.pool = pool
        self.index = index
        self.shards = shards

    @property
    def slots(self) -> int:
        base, extra = divmod(max(self.pool.capacity, 1), self.shards)
        return max(1, base + (1 if self.index < extra else 0))

    def _bind(self) -> None:
        bind = getattr(self.pool.events, "bind_shard", None)
        if bind is not None:
            bind(self.index)

    def submit(self, fn: Callable[..., Any], *args: Any,
               **kwargs: Any) -> ElasticFuture:
        self._bind()
        return self.pool.submit(fn, *args, **kwargs)

    def submit_gather(self, *args: Any, **kwargs: Any) -> ElasticFuture:
        self._bind()
        return self.pool.submit_gather(*args, **kwargs)

    def __repr__(self) -> str:
        return (f"ShardView({self.pool.kind}, {self.index}/{self.shards}, "
                f"slots={self.slots})")


_REGISTRY: Dict[str, Callable[..., Pool]] = {}


def register_pool(kind: str) -> Callable:
    """Class/factory decorator adding a backend to :func:`make_pool`."""
    def deco(factory: Callable[..., Pool]) -> Callable[..., Pool]:
        _REGISTRY[kind] = factory
        return factory
    return deco


def registered_pools() -> List[str]:
    _ensure_backends()
    return sorted(_REGISTRY)


def _ensure_backends() -> None:
    # Backends self-register at import; importing the package normally
    # pulls them all in, but guard direct `repro_torch.core.pool` users too.
    if {"local", "elastic", "hybrid", "sim"} <= _REGISTRY.keys():
        return
    from . import executor, hybrid, simpool  # noqa: F401


def make_pool(kind: str, **cfg: Any) -> Pool:
    """Construct an executor pool by backend name.

    ``cfg`` is forwarded to the backend constructor, e.g.
    ``make_pool("elastic", max_concurrency=16, invoke_overhead=1e-3)``.
    """
    _ensure_backends()
    try:
        factory = _REGISTRY[kind]
    except KeyError:
        raise ValueError(
            f"unknown pool kind {kind!r}; registered: "
            f"{', '.join(sorted(_REGISTRY))}") from None
    return factory(**cfg)


@register_pool("speculative")
def _make_speculative(inner: Any = "elastic",
                      inner_cfg: Dict[str, Any] = None,
                      **kw: Any) -> Pool:
    """Wrap an inner backend (instance or kind name) with deadline-based
    straggler duplication (``repro_torch.runtime.straggler``)."""
    from ..runtime.straggler import SpeculativeExecutor
    pool = inner if isinstance(inner, Pool) \
        else make_pool(inner, **(inner_cfg or {}))
    return SpeculativeExecutor(pool, **kw)
