"""Elastic executor middleware — the paper's primary contribution (§3.1).

The paper's ``ServerlessExecutor`` (borrowed from Crucial) runs Java
``Callable`` tasks as stateless cloud functions under a master-worker
model.  We reproduce that abstraction for a TPU/JAX framework:

* ``LocalExecutor``       — the paper's local thread pool (18 us overhead).
* ``ElasticExecutor``     — the ServerlessExecutor analogue: an elastic
                            pool of stateless workers with FaaS-style
                            invocation overhead (~13 ms, Table 4), a hard
                            concurrency limit (Lambda: 1 000/2 000) and an
                            invocation-frequency limit (10 000/s on AWS).
* worker backends         — ``inline`` (deterministic, for tests),
                            ``thread`` (real host threads; on a pod each
                            worker owns a mesh slice).

Every pool writes one :class:`~repro.core.telemetry.EventLog` timeline
(``pool.events``): submit / cold_start / start / requeue / complete /
capacity_grow / capacity_shrink.  ``characterization.py`` (C_L,
task-rate, CDF — paper §4.2) and ``costmodel.py`` (Eq. 3-7) read that
timeline; ``ExecutorStats`` is the running-counter view over it.

Platform dynamics are data, not code: pass a
:class:`~repro.core.provider.ProviderModel` and the executor models
cold starts vs. warm-container reuse (keep-alive window, LIFO reuse),
admission beyond the burst waits on the provider's per-minute scaling
ramp, and the rate limit comes from the model.  The *same* model drives
the virtual-time ``SimPool``, so real and simulated runs are billed and
characterized identically.

Pools are resizable: ``resize(capacity)`` grows the worker set
immediately and shrinks it gracefully (retire sentinels behind queued
work), logging ``capacity_grow`` / ``capacity_shrink`` events — the
mechanism under ``run_irregular``'s ``AutoscalePolicy`` hook.

Semantics intentionally mirrored from the paper:
  * tasks are stateless ⇒ re-execution is safe (used for straggler
    re-dispatch and fault recovery, `speculative_deadline`);
  * the client enforces the concurrency limit, never the platform;
  * results flow back through a queue drained by the master
    (``as_completed`` / ``run_irregular``), event-driven via the
    future-callback layer in ``futures.CompletionQueue``.

Both executors satisfy the unified ``repro.core.pool.Pool`` contract
and are registered with ``make_pool`` as ``"local"`` / ``"elastic"``.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional

from .futures import (CompletionQueue, ElasticFuture, Task, TaskRecord,
                      TaskState, WorkerKilledError)
from . import telemetry
from .pool import Pool, register_pool
from .provider import Backoff, ContainerFleet, ProviderModel
from .telemetry import (CANCEL, CAPACITY_GROW, CAPACITY_SHRINK,
                        COLD_START, COMPLETE, REQUEUE, START, SUBMIT,
                        THROTTLED, WORKER_KILLED, Clock, EventLog)

__all__ = [
    "ConcurrencyTracker",
    "ExecutorStats",
    "BaseExecutor",
    "LocalExecutor",
    "ElasticExecutor",
    "FunctionThrottledError",
    "as_completed",
]


class FunctionThrottledError(RuntimeError):
    """Raised when the platform's hard concurrency limit would be exceeded
    *and* the executor was configured to reject rather than queue
    (mirrors AWS Lambda's throttling exception, paper §3.1)."""


class ConcurrencyTracker:
    """Shared active/peak counter several stats objects can notify.

    ``HybridExecutor`` attaches one tracker to both its sub-pools'
    stats, yielding the *true* combined peak concurrency as a cheap
    running counter (the full combined curve lives in the merged
    event timeline, ``HybridExecutor.events``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.active = 0
        self.peak = 0

    def task_started(self) -> None:
        with self._lock:
            self.active += 1
            self.peak = max(self.peak, self.active)

    def task_finished(self) -> None:
        with self._lock:
            self.active -= 1


class ExecutorStats:
    """Running-counter view over a pool's :class:`EventLog` timeline.

    Every mutation both bumps the thread-safe counters (cheap O(1)
    reads for schedulers: ``active``, ``peak_concurrency``) and appends
    the corresponding typed event to :attr:`log` — the single artifact
    characterization and cost accounting consume.  ``records`` is
    derived from the timeline's ``complete`` events.

    ``failed`` counts *terminal* failures only; transient attempts that
    are requeued for retry show up in ``retries`` (and as extra
    billable ``invocations``), never in ``failed``."""

    def __init__(self, clock: Optional[Clock] = None,
                 log: Optional[EventLog] = None) -> None:
        self._lock = threading.Lock()
        self.log = log if log is not None else EventLog(clock)
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.retries = 0
        self.active = 0
        self.peak_concurrency = 0
        self.invocations = 0  # billable invocations (includes retries)
        self.cold_starts = 0
        self.worker_deaths = 0  # injected container kills (repro.chaos)
        self.throttled = 0      # admission backoff episodes (storms)
        self.cancelled = 0      # explicit future cancellations
        self.trackers: List[ConcurrencyTracker] = []

    @property
    def records(self) -> List[TaskRecord]:
        """Completion log, derived from the timeline."""
        return self.log.records

    def on_submit(self, task_id: Optional[int] = None,
                  parent: Optional[int] = None) -> None:
        """``parent`` is the task id of the completion that spawned
        this submit (``telemetry.PARENT_ROOT`` for seed/arrival
        dispatches) — recorded on the timeline so replays recover the
        dispatch DAG exactly instead of heuristically."""
        with self._lock:
            self.submitted += 1
        self.log.emit(SUBMIT, task_id=task_id, parent=parent)

    def on_cold_start(self, task_id: Optional[int] = None,
                      worker: Optional[str] = None) -> None:
        with self._lock:
            self.cold_starts += 1
        self.log.emit(COLD_START, task_id=task_id, worker=worker)

    def on_start(self, task_id: Optional[int] = None,
                 worker: Optional[str] = None) -> None:
        with self._lock:
            self.active += 1
            self.invocations += 1
            self.peak_concurrency = max(self.peak_concurrency, self.active)
        self.log.emit(START, task_id=task_id, worker=worker)
        for t in self.trackers:
            t.task_started()

    def on_finish(self, record: Optional[TaskRecord], ok: bool) -> None:
        with self._lock:
            self.active -= 1
            if ok:
                self.completed += 1
            else:
                self.failed += 1
        self.log.emit(
            COMPLETE, ok=ok, record=record,
            task_id=record.task_id if record is not None else None,
            worker=record.worker if record is not None else None)
        for t in self.trackers:
            t.task_finished()

    def on_requeue(self, task_id: Optional[int] = None,
                   worker: Optional[str] = None) -> None:
        """A transient attempt ended and the task went back on the
        queue: the slot frees up but neither ``completed`` nor
        ``failed`` moves (the retry-path double count of old)."""
        with self._lock:
            self.active -= 1
        self.log.emit(REQUEUE, task_id=task_id, worker=worker)
        for t in self.trackers:
            t.task_finished()

    def on_retry(self) -> None:
        with self._lock:
            self.retries += 1

    def on_worker_killed(self, task_id: Optional[int] = None,
                         worker: Optional[str] = None) -> None:
        """An injected fault killed the attempt's container mid-task
        (``repro.chaos``).  Informational — the slot itself is freed by
        the paired :meth:`on_requeue` / :meth:`on_finish`, so the
        concurrency series stays exact."""
        with self._lock:
            self.worker_deaths += 1
        self.log.emit(WORKER_KILLED, task_id=task_id, worker=worker)

    def on_throttled(self, task_id: Optional[int] = None,
                     worker: Optional[str] = None) -> None:
        """Admission hit a rate-limit storm and entered a backoff
        episode (one event per episode, not per retry sleep)."""
        with self._lock:
            self.throttled += 1
        self.log.emit(THROTTLED, task_id=task_id, worker=worker)

    def on_cancel(self, task_id: Optional[int] = None,
                  parent: Optional[int] = None) -> None:
        """A pending future was explicitly cancelled (fail-fast sibling
        cancel, ``Pool.map`` remainder-cancel).  ``parent`` is the
        cancelling context's task id so replays can distinguish a
        deliberate cancellation from a lost task."""
        with self._lock:
            self.cancelled += 1
        self.log.emit(CANCEL, task_id=task_id, parent=parent)

    def on_resize(self, old: int, new: int) -> None:
        self.log.emit(CAPACITY_GROW if new > old else CAPACITY_SHRINK,
                      capacity=new)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "retries": self.retries,
                "active": self.active,
                "peak_concurrency": self.peak_concurrency,
                "invocations": self.invocations,
                "cold_starts": self.cold_starts,
                "worker_deaths": self.worker_deaths,
                "throttled": self.throttled,
                "cancelled": self.cancelled,
            }


#: worker-loop sentinel: retire exactly one worker thread (resize down)
_RETIRE = object()


class BaseExecutor(Pool):
    """Common machinery: worker threads pulling from a bounded queue.

    ``shard_views(K)`` (inherited) slices this ONE pool for the sharded
    driver: all K views submit into the same queue, the same rate
    limiter, and — when a ``ProviderModel`` is attached — the same
    cold-start fleet and admission/scaling ramp, so sharding the master
    never multiplies the provider's concurrency grant."""

    #: human-readable pool kind ("local" | "elastic")
    kind: str = "base"
    #: whether completions are billed as remote invocations
    remote: bool = False

    def __init__(
        self,
        max_concurrency: int,
        *,
        provider: Optional[ProviderModel] = None,
        invoke_overhead: float = 0.0,
        invoke_rate_limit: Optional[float] = None,
        throttle_mode: str = "queue",  # "queue" | "reject"
        failure_rate: float = 0.0,
        max_attempts: int = 3,
        seed: int = 0,
        name: Optional[str] = None,
        trace: Optional[EventLog] = None,
        faults: Optional[Any] = None,
    ) -> None:
        if max_concurrency <= 0:
            raise ValueError("max_concurrency must be positive")
        self.max_concurrency = max_concurrency
        self.provider = provider
        if provider is not None:
            invoke_overhead = provider.warm_overhead_s
            invoke_rate_limit = provider.invoke_rate_limit
        self.invoke_overhead = invoke_overhead
        self.invoke_rate_limit = invoke_rate_limit
        self.throttle_mode = throttle_mode
        self.failure_rate = failure_rate
        self.max_attempts = max_attempts
        self.name = name or f"{self.kind}-pool"
        # trace: a caller-supplied EventLog backend — typically a
        # repro.trace.TraceStore, which spills to JSONL and keeps only a
        # ring of events resident (million-event runs)
        self.stats = ExecutorStats(log=trace)
        # faults: a repro.chaos.FaultPlan (duck-typed — core never
        # imports chaos).  Bound per pool so concurrent pools sharing
        # one plan draw independent decision streams.
        self._chaos = faults.bind() if faults is not None else None
        self._fleet = (ContainerFleet(provider)
                       if provider is not None else None)
        # seeded-jitter backoff for admission waits (ramp + storms);
        # only ever advanced under _admit_lock, so one stream suffices
        self._backoff = Backoff(base_s=1e-4, cap_s=0.05, seed=seed)
        self._admit_lock = threading.Lock()
        self._ramp_t0: Optional[float] = None
        self._queue: "queue.Queue" = queue.Queue()
        self._shutdown = False
        self._rng_state = seed or 0x9E3779B9
        self._rate_lock = threading.Lock()
        self._last_invoke = 0.0
        self._workers: List[threading.Thread] = []
        self._workers_lock = threading.Lock()
        self._started = False
        self._worker_seq = 0
        # announce the initial capacity on the timeline
        self.stats.on_resize(0, max_concurrency)

    # -- worker management ------------------------------------------------
    def _spawn_worker(self) -> None:
        t = threading.Thread(
            target=self._worker_loop,
            args=(f"{self.name}-w{self._worker_seq}",),
            daemon=True,
        )
        self._worker_seq += 1
        t.start()
        self._workers.append(t)

    def _ensure_workers(self) -> None:
        with self._workers_lock:
            if self._started:
                return
            self._started = True
            for _ in range(self.max_concurrency):
                self._spawn_worker()

    def _worker_loop(self, worker_name: str) -> None:
        while True:
            item = self._queue.get()
            if item is None:  # shutdown sentinel
                self._queue.task_done()
                return
            if item is _RETIRE:  # resize-down sentinel
                self._queue.task_done()
                return
            task, future = item
            try:
                self._run_one(task, future, worker_name)
            finally:
                self._queue.task_done()

    def resize(self, capacity: int) -> None:
        """Set the pool's worker capacity.

        Growing spawns workers immediately; shrinking retires workers
        gracefully (a retire sentinel queued behind current work — no
        running task is interrupted).  Logged as a ``capacity_grow`` /
        ``capacity_shrink`` timeline event either way."""
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        with self._workers_lock:
            old = self.max_concurrency
            if capacity == old:
                return
            self.max_concurrency = capacity
            self.stats.on_resize(old, capacity)
            if not self._started:
                return  # workers spawn lazily at the new width
            if capacity > old:
                for _ in range(capacity - old):
                    self._spawn_worker()
            else:
                for _ in range(old - capacity):
                    self._queue.put(_RETIRE)

    def _next_rand(self) -> float:
        # xorshift — deterministic failure injection without global RNG.
        with self._rate_lock:
            x = self._rng_state & 0xFFFFFFFF
            x ^= (x << 13) & 0xFFFFFFFF
            x ^= x >> 17
            x ^= (x << 5) & 0xFFFFFFFF
            self._rng_state = x
            return x / 0xFFFFFFFF

    def _respect_rate_limit(self) -> None:
        if self.invoke_rate_limit is None:
            return
        min_gap = 1.0 / self.invoke_rate_limit
        with self._rate_lock:
            now = time.monotonic()
            wait = self._last_invoke + min_gap - now
            self._last_invoke = max(now, self._last_invoke + min_gap)
        if wait > 0:
            time.sleep(wait)

    def _admit(self, task: Task, worker: str):
        """Reserve an execution slot: rate limit, provider scaling
        ramp, then cold/warm container acquisition.  Returns
        ``(container_id, cold)`` — ``(None, False)`` without a provider
        model.  The admission lock serializes the allowed-concurrency
        check with the ``active`` bump, so the ramp is never
        overshot."""
        self._respect_rate_limit()
        if self.provider is None:
            self.stats.on_start(task.task_id, worker)
            return None, False
        with self._admit_lock:
            now = time.monotonic()
            if self._ramp_t0 is None:
                self._ramp_t0 = now
            throttled = False
            while not self._shutdown:
                elapsed = time.monotonic() - self._ramp_t0
                allowed = min(
                    self.max_concurrency,
                    self.provider.allowed_concurrency(elapsed))
                # injected rate-limit storm (repro.chaos): admission is
                # refused for the window regardless of the ramp.  Storm
                # windows are in pool time = seconds since first use.
                storm = (self._chaos.storm_until(elapsed)
                         if self._chaos is not None else None)
                if storm is None and self.stats.active < allowed:
                    break
                if storm is not None and not throttled:
                    # one event per backoff episode, not per sleep
                    self.stats.on_throttled(task.task_id, worker)
                    throttled = True
                # seeded exponential backoff with jitter instead of the
                # old fixed 100 us hot-spin — storms converge instead
                # of burning a core
                time.sleep(self._backoff.next())
            self._backoff.reset()
            cid, cold = self._fleet.acquire(time.monotonic())
            if cold:
                self.stats.on_cold_start(task.task_id, worker)
            self.stats.on_start(task.task_id, worker)
        return cid, cold

    def _run_one(self, task: Task, future: ElasticFuture, worker: str) -> None:
        if future.state is TaskState.CANCELLED:
            return  # never started: no invocation, no failure
        cid, cold = self._admit(task, worker)
        future._set_running()
        task.start_time = time.monotonic()
        task.worker = worker
        task.attempts += 1
        overhead = (self.provider.overhead_s(cold) if self.provider
                    else self.invoke_overhead)
        if cold and self._chaos is not None:
            # injected cold-start inflation (slow AZ, image-pull storm)
            overhead += self._chaos.extra_cold_start(self.provider)
        # spans: pool.invoke (the overhead's sleep) and pool.settle (the
        # body's return to the future settled); the task id is the
        # thread's current task while the body runs
        spans_on = telemetry.SPANS_ON
        if overhead > 0:
            t_in = time.monotonic() if spans_on else 0.0
            time.sleep(overhead)
            if spans_on:
                telemetry.add_span("pool.invoke", t_in, time.monotonic(),
                                   task.task_id)
        try:
            if self.failure_rate > 0 and self._next_rand() < self.failure_rate:
                raise RuntimeError(f"injected worker failure on {worker}")
            if self._chaos is not None and self._chaos.kills_attempt(
                    batch=getattr(task.fn, "_repro_is_batch", False)):
                raise WorkerKilledError(
                    f"injected container death on {worker}")
            if spans_on:
                telemetry.set_current_task(task.task_id)
            result = task.run()
        except BaseException as exc:  # noqa: BLE001 — report any failure
            task.end_time = time.monotonic()
            if spans_on:
                telemetry.set_current_task(None)
            killed = isinstance(exc, WorkerKilledError)
            if killed:
                # the whole container died: it never rejoins the fleet,
                # so the task's next attempt acquires cold
                self.stats.on_worker_killed(task.task_id, worker)
            else:
                self._release(cid)
            # injected kills retry on their own (deep) budget so N%
            # mortality alone can never exhaust a task into a terminal
            # failure — the chaos headline invariant
            budget = (self._chaos.retry_budget
                      if killed and self._chaos is not None
                      else self.max_attempts)
            if task.attempts < budget:
                # stateless ⇒ safe to re-invoke (paper §3.3); transient,
                # so it counts as a retry, not a failure
                self.stats.on_retry()
                self.stats.on_requeue(task.task_id, worker)
                self._queue.put((task, future))
                return
            self.stats.on_finish(self._record(task, worker), ok=False)
            future._set_exception(exc)
            if spans_on:
                telemetry.add_span("pool.settle", task.end_time,
                                   time.monotonic(), task.task_id)
            return
        task.end_time = time.monotonic()
        if spans_on:
            telemetry.set_current_task(None)
        self._release(cid)
        record = self._record(task, worker)
        self.stats.on_finish(record, ok=True)
        future._set_result(result)
        if spans_on:
            telemetry.add_span("pool.settle", task.end_time,
                               time.monotonic(), task.task_id)

    def _release(self, cid: Optional[int]) -> None:
        if self._fleet is not None and cid is not None:
            self._fleet.release(cid, time.monotonic())

    def _record(self, task: Task, worker: str) -> TaskRecord:
        return TaskRecord(
            task_id=task.task_id,
            worker=worker,
            submit_time=task.submit_time,
            start_time=task.start_time or 0.0,
            end_time=task.end_time or 0.0,
            cost_hint=task.cost_hint,
            remote=self.remote,
            attempts=task.attempts,
        )

    # -- public API (paper's ExecutorService surface) ----------------------
    def submit(self, fn: Callable[..., Any], *args: Any,
               cost_hint: float = 1.0, parent: Optional[int] = None,
               **kwargs: Any) -> ElasticFuture:
        if fn is None:
            raise TypeError("task must not be None")  # Listing 1 line 8
        if self._shutdown:
            raise RuntimeError("executor has been shut down")
        if (self.throttle_mode == "reject"
                and self._queue.qsize() + self.stats.active >= self.max_concurrency):
            raise FunctionThrottledError(
                f"{self.name}: concurrency limit {self.max_concurrency} reached")
        self._ensure_workers()
        task = Task(fn=fn, args=args, kwargs=kwargs, cost_hint=cost_hint)
        future = ElasticFuture(task)
        self.stats.on_submit(task.task_id, parent=parent)
        self._queue.put((task, future))
        return future

    def pending(self) -> int:
        return self._queue.qsize()

    def idle_capacity(self) -> int:
        """Free worker slots right now (used by HybridExecutor's policy)."""
        return max(0, self.max_concurrency - self.stats.active - self._queue.qsize())

    def shutdown(self, wait: bool = True) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        if wait and self._started:
            self._queue.join()
        if self._started:
            for _ in self._workers:
                self._queue.put(None)
            if wait:
                # a worker still unwinding when the interpreter exits is
                # killed inside torch's C++ frames, which aborts the
                # process after its work is done
                me = threading.current_thread()
                for t in self._workers:
                    if t is not me:
                        t.join()

@register_pool("local")
class LocalExecutor(BaseExecutor):
    """The paper's local thread pool: ~18 us submit overhead, bounded by
    host cores (or an explicit limit)."""

    kind = "local"
    remote = False
    # one host thread can run a fused batch body: submit_batch fuses
    supports_batching = True

    def __init__(self, max_concurrency: int = 8, **kw: Any) -> None:
        kw.setdefault("invoke_overhead", 18e-6)
        super().__init__(max_concurrency, **kw)


@register_pool("elastic")
class ElasticExecutor(BaseExecutor):
    """The ServerlessExecutor analogue: elastic stateless worker pool.

    Defaults model AWS Lambda as measured in the paper (Table 4):
    ~13 ms invocation overhead, 1 000 default concurrency (2 000 in the
    paper's region), 10 000 invocations/s rate limit.  Pass
    ``provider=ProviderModel.aws_lambda()`` (or any other model) to
    additionally simulate cold starts vs. warm-container reuse and the
    per-minute concurrency scaling ramp; overhead and rate limits then
    come from the model.
    """

    kind = "elastic"
    remote = True

    def __init__(
        self,
        max_concurrency: int = 1000,
        *,
        provider: Optional[ProviderModel] = None,
        invoke_overhead: float = 13e-3,
        invoke_rate_limit: Optional[float] = 10_000.0,
        **kw: Any,
    ) -> None:
        super().__init__(
            max_concurrency,
            provider=provider,
            invoke_overhead=invoke_overhead,
            invoke_rate_limit=invoke_rate_limit,
            **kw,
        )


def as_completed(futures: Iterable[ElasticFuture],
                 timeout: Optional[float] = None) -> Iterator[ElasticFuture]:
    """Yield futures as they complete (master-side result queue drain).

    Event-driven: blocks on the futures' shared condition variable via
    ``CompletionQueue`` instead of the old 100 us ``done()`` poll, and
    pops each ready wave in ONE lock acquisition
    (``CompletionQueue.drain``) instead of re-locking per future."""
    fs = list(futures)
    cq = CompletionQueue(fs)
    deadline = None if timeout is None else time.monotonic() + timeout
    done = 0
    while done < len(fs):
        remaining = (None if deadline is None
                     else deadline - time.monotonic())
        for f in cq.drain(timeout=remaining):
            done += 1
            yield f
