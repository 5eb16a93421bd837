"""Virtual-time executor-pool simulator (discrete-event).

One CPU core cannot *exhibit* concurrency effects, so figures whose
mechanism is scheduling (Fig. 4's concurrency ramp, pool saturation,
drain-phase tails) are reproduced under a virtual clock at the paper's
true scale (2 000 workers): task bodies run for real (the actual UTS
bags expand), but their *duration* is a calibrated model

    t_task = overhead + alpha * nodes_processed

and completions are ordered by an event heap.  The master logic —
result queue, controller update, bag resizing, re-dispatch — is the
same decision sequence as the real executor path, so the simulation
isolates exactly the scheduling policy (static vs Listing-5 dynamic).

The pool's clock is a shared :class:`~repro_torch.core.telemetry.VirtualClock`
and every lifecycle step lands on the same
:class:`~repro_torch.core.telemetry.EventLog` timeline the real executors
write — submit / cold_start / start / complete / capacity events with
*virtual* timestamps — so characterization, cost accounting, and the
concurrency-over-time series work identically on simulated runs.

Platform dynamics come from the same
:class:`~repro_torch.core.provider.ProviderModel` the real
``ElasticExecutor`` consumes: cold starts charge provision latency into
the modelled duration (warm containers are reused LIFO within the
keep-alive window), and virtual starts beyond the provider's burst wait
for the per-minute scaling ramp.  ``resize`` adjusts capacity at the
current virtual instant, releasing waiting tasks on growth.

Two surfaces:

* :class:`SimPool` — a virtual-time backend satisfying the unified
  ``Pool`` contract (``make_pool("sim", ...)``): task bodies run for
  real at submit time, completions are delivered in virtual order when
  the event heap is pumped (transparently, via the futures'
  ``CompletionQueue`` integration), so ``run_irregular`` drives it
  exactly like a live executor.
* :func:`simulate_uts_pool` — the original closed-loop UTS simulation
  kept for the Fig. 4 benchmark's exact decision sequence.
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

from .adaptive import StagedController, TaskShape
from .executor import ExecutorStats, FunctionThrottledError
from .futures import ElasticFuture, Task, TaskRecord, WorkerKilledError
from .pool import Pool, register_pool
from .provider import ContainerFleet, ProviderModel
from .telemetry import VirtualClock
from ..device import DeviceLike, resolve_device

__all__ = ["SimPool", "SimFuture", "SimPoolResult", "simulate_uts_pool"]


class SimFuture(ElasticFuture):
    """Future whose completion is an event on a virtual-time heap.

    ``result()`` advances the pool's virtual clock until this future's
    completion event fires; ``CompletionQueue`` recognizes the ``_sim``
    attribute and pumps instead of blocking on wall-clock time."""

    def __init__(self, task: Task, pool: "SimPool") -> None:
        super().__init__(task)
        self._sim = pool

    def result(self, timeout: Optional[float] = None) -> Any:
        while not self.done() and self._sim._pump_one():
            pass
        return super().result(timeout)

    def exception(self, timeout: Optional[float] = None):
        while not self.done() and self._sim._pump_one():
            pass
        return super().exception(timeout)


@register_pool("sim")
class SimPool(Pool):
    """Discrete-event executor pool under a virtual clock.

    Task bodies execute eagerly (side effects and return values are
    exact); their *duration* is modelled as

        t_task = invocation_overhead + duration_fn(task, result)

    (default ``alpha_s_per_node * cost_hint``) and completion order /
    concurrency honours ``max_concurrency`` at the paper's true scale
    (2 000 workers) on a single core.  The invocation overhead is
    either the flat ``invoke_overhead`` or, with a ``provider`` model,
    the cold/warm overhead of the container the virtual start lands on.
    The timeline (``events``) carries virtual timestamps, so
    characterization and cost accounting work unchanged.
    """

    kind = "sim"
    remote = True
    # a virtual worker can run a fused batch body: submit_batch fuses
    supports_batching = True

    def __init__(
        self,
        max_concurrency: int = 2000,
        *,
        provider: Optional[ProviderModel] = None,
        invoke_overhead: float = 13e-3,
        alpha_s_per_node: float = 1e-6,
        duration_fn: Optional[Callable[[Task, Any], float]] = None,
        throttle_mode: str = "queue",  # "queue" | "reject"
        name: Optional[str] = None,
        trace=None,
        faults: Optional[Any] = None,
    ) -> None:
        if max_concurrency <= 0:
            raise ValueError("max_concurrency must be positive")
        self.max_concurrency = max_concurrency
        self.provider = provider
        if provider is not None:
            invoke_overhead = provider.warm_overhead_s
        self.invoke_overhead = invoke_overhead
        self.alpha_s_per_node = alpha_s_per_node
        self.duration_fn = duration_fn
        self.throttle_mode = throttle_mode
        self.name = name or "sim-pool"
        self.clock = VirtualClock()
        if trace is not None:
            # adopt a caller-supplied timeline backend (typically a
            # spill-to-disk repro_torch.trace.TraceStore): rebind its clock so
            # spilled events carry *virtual* timestamps
            trace.clock = self.clock
            self.stats = ExecutorStats(log=trace)
        else:
            self.stats = ExecutorStats(clock=self.clock)
        # faults: a repro_torch.chaos.FaultPlan (duck-typed; bound per pool).
        # Kill decisions are drawn per virtual start in deterministic
        # order, so a seeded sim run has the same fault schedule — and
        # therefore the same makespan/cost — on every execution.
        self._chaos = faults.bind() if faults is not None else None
        self._fleet = (ContainerFleet(provider)
                       if provider is not None else None)
        # (end_vt, seq, container id, entry, killed)
        self._heap: List[Tuple[float, int, int, tuple, bool]] = []
        self._waiting: deque = deque()
        self._seq = itertools.count()
        self._shutdown = False
        self.stats.on_resize(0, max_concurrency)

    @property
    def virtual_time_s(self) -> float:
        """Current virtual clock (the makespan once drained)."""
        return self.clock.now()

    @property
    def trace(self) -> List[Tuple[float, int]]:
        """(virtual t, active) — derived from the timeline."""
        return self.stats.log.concurrency_series()

    def _make_future(self, task: Task) -> ElasticFuture:
        # batch fan-out futures must pump the event heap when waited on
        return SimFuture(task, self)

    def _allowed(self) -> int:
        """Capacity usable at the current virtual instant: the pool
        width, further clamped by the provider's scaling ramp."""
        cap = self.max_concurrency
        if self.provider is not None:
            cap = min(cap, self.provider.allowed_concurrency(
                self.clock.now()))
        # virtual time only advances on completions: one slot must
        # always be usable or a zero-burst ramp would deadlock the heap
        return max(1, cap)

    # -- Pool contract -----------------------------------------------------
    def submit(self, fn: Callable[..., Any], *args: Any,
               cost_hint: float = 1.0, parent: Optional[int] = None,
               **kwargs: Any) -> ElasticFuture:
        if fn is None:
            raise TypeError("task must not be None")
        if self._shutdown:
            raise RuntimeError("executor has been shut down")
        if (self.throttle_mode == "reject"
                and self.stats.active + len(self._waiting)
                >= self.max_concurrency):
            raise FunctionThrottledError(
                f"{self.name}: concurrency limit "
                f"{self.max_concurrency} reached")
        task = Task(fn=fn, args=args, kwargs=kwargs, cost_hint=cost_hint)
        task.submit_time = self.clock.now()
        future = SimFuture(task, self)
        self.stats.on_submit(task.task_id, parent=parent)
        # run the body now (exact results); only *time* is simulated
        task.attempts = 1
        try:
            result, exc = task.run(), None
        except BaseException as e:  # noqa: BLE001 — deliver at pump time
            result, exc = None, e
        # failed bodies have no result to model a duration from — bill
        # them the cost-hint default so the exception reaches pump time
        body_dur = (self.duration_fn(task, result)
                    if self.duration_fn is not None and exc is None
                    else self.alpha_s_per_node * cost_hint)
        entry = (future, task, result, exc, body_dur)
        if self.stats.active < self._allowed():
            self._start(entry)
        else:
            self._waiting.append(entry)
        return future

    def pending(self) -> int:
        return len(self._waiting)

    def idle_capacity(self) -> int:
        return max(0, self.max_concurrency - self.stats.active
                   - len(self._waiting))

    def resize(self, capacity: int) -> None:
        """Adjust capacity at the current virtual instant.  Growth
        starts waiting tasks immediately (subject to the provider
        ramp); shrink takes effect as running tasks drain."""
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        old = self.max_concurrency
        if capacity == old:
            return
        self.max_concurrency = capacity
        self.stats.on_resize(old, capacity)
        while self._waiting and self.stats.active < self._allowed():
            self._start(self._waiting.popleft())

    def shutdown(self, wait: bool = True) -> None:
        if wait:
            while self._pump_one():
                pass
        self._shutdown = True

    # -- open-loop driving -------------------------------------------------
    def next_event_t(self) -> Optional[float]:
        """Virtual timestamp of the next pending completion, ``None``
        when nothing is outstanding — lets an open-loop driver decide
        whether its next arrival lands before the next completion."""
        return self._heap[0][0] if self._heap else None

    def run_until(self, t: float) -> None:
        """Pump every completion event up to virtual time ``t``, then
        advance the clock to exactly ``t``.

        This is the open-loop surface: a traffic driver submits each
        request at its virtual *arrival* time by first running the pool
        to that instant, so idle gaps between arrivals appear on the
        timeline instead of being compressed away (the closed-loop
        ``result()``/``CompletionQueue`` pumps only move time on
        completions)."""
        while self._heap and self._heap[0][0] <= t:
            self._pump_one()
        self.clock.advance_to(t)

    def snapshot(self) -> dict:
        snap = self.stats.snapshot()
        snap["virtual_time_s"] = self.clock.now()
        return snap

    # -- event machinery ---------------------------------------------------
    def _start(self, entry: tuple) -> None:
        future, task, result, exc, body_dur = entry
        now = self.clock.now()
        start_t = now
        if self._chaos is not None:
            # injected rate-limit storm: admission waits out the window
            # (un-billed queueing — the attempt is not RUNNING during
            # the wait), recorded as one throttled event
            delay = self._chaos.storm_delay(now)
            if delay > 0.0:
                self.stats.on_throttled(task.task_id, self.name)
                start_t = now + delay
        task.start_time = start_t
        task.worker = self.name
        cold = False
        cid = -1
        if self._fleet is not None:
            cid, cold = self._fleet.acquire(start_t)
            task.worker = f"{self.name}-c{cid}"
            if cold:
                self.stats.on_cold_start(task.task_id, task.worker)
        overhead = (self.provider.overhead_s(cold)
                    if self.provider is not None else self.invoke_overhead)
        if cold and self._chaos is not None:
            # injected cold-start inflation (slow AZ, image-pull storm)
            overhead += self._chaos.extra_cold_start(self.provider)
        self.stats.on_start(task.task_id, task.worker)
        future._set_running()
        # injected container death: the attempt bills its overhead plus
        # kill_fraction of the body, then requeues at pump time.  The
        # body already ran at submit — only the *schedule* takes the
        # fault, which is exactly why N% mortality cannot change results
        killed = (self._chaos is not None and exc is None
                  and self._chaos.kills_attempt(
                      batch=getattr(task.fn, "_repro_is_batch", False)))
        billed = (self._chaos.plan.kill_fraction * body_dur
                  if killed else body_dur)
        # the container id rides the heap tuple so the pump releases it
        # without re-parsing the worker-name string per completion
        heapq.heappush(self._heap,
                       (start_t + overhead + billed, next(self._seq),
                        cid, entry, killed))

    def _pump_one(self) -> bool:
        """Advance virtual time by one completion event.  Returns False
        when the heap is drained (nothing outstanding)."""
        if not self._heap:
            return False
        end_vt, _, cid, entry, killed = heapq.heappop(self._heap)
        future, task, result, exc, _dur = entry
        self.clock.advance_to(end_vt)
        if killed:
            # the container died mid-body: it is NOT released back to
            # the fleet (the next acquire provisions cold) and the task
            # retries on the chaos budget — mortality can only ever
            # cost time/money, never results
            self.stats.on_worker_killed(task.task_id, task.worker)
            if task.attempts < self._chaos.retry_budget:
                self.stats.on_retry()
                self.stats.on_requeue(task.task_id, task.worker)
                task.attempts += 1
                self._waiting.appendleft(entry)  # retry at queue head
            else:
                task.end_time = end_vt
                record = TaskRecord(
                    task_id=task.task_id, worker=task.worker,
                    submit_time=task.submit_time,
                    start_time=task.start_time, end_time=end_vt,
                    cost_hint=task.cost_hint, remote=self.remote,
                    attempts=task.attempts)
                self.stats.on_finish(record, ok=False)
                future._set_exception(WorkerKilledError(
                    f"container died {task.attempts} times running "
                    f"task {task.task_id}"))
            while self._waiting and self.stats.active < self._allowed():
                self._start(self._waiting.popleft())
            return True
        task.end_time = end_vt
        if self._fleet is not None:
            self._fleet.release(cid, end_vt)
        record = TaskRecord(
            task_id=task.task_id, worker=task.worker,
            submit_time=task.submit_time, start_time=task.start_time,
            end_time=end_vt, cost_hint=task.cost_hint,
            remote=self.remote, attempts=task.attempts)
        self.stats.on_finish(record, ok=exc is None)
        if exc is not None:
            future._set_exception(exc)
        else:
            future._set_result(result)
        while self._waiting and self.stats.active < self._allowed():
            self._start(self._waiting.popleft())
        return True


@dataclass
class SimPoolResult:
    count: int
    virtual_time_s: float
    tasks: int
    peak_concurrency: int
    concurrency_trace: List[Tuple[float, int]] = field(
        default_factory=list)


def simulate_uts_pool(
    params,
    *,
    workers: int = 2000,
    overhead_s: float = 13e-3,
    alpha_s_per_node: float = 1e-6,
    shape: TaskShape = TaskShape(50, 2_500_000),
    controller: Optional[StagedController] = None,
    device: DeviceLike = None,
) -> SimPoolResult:
    """Event-driven UTS over a virtual elastic pool.

    The tree is actually traversed (counts are exact) on ``device`` (the
    CUDA card by default); only time is simulated.  Returns the virtual
    makespan on a ``workers``-wide pool.
    """
    from ..algorithms.uts import Bag, expand_bag
    device = resolve_device(device)

    clock = 0.0
    active = 0
    peak = 0
    total = 0
    n_tasks = 0
    trace: List[Tuple[float, int]] = []
    counter = itertools.count()
    # running: (finish_time, seq, leftover_bag)
    heap: List[Tuple[float, int, object]] = []
    waiting: List[Tuple[float, object]] = []  # (duration, leftover)

    def run_task(sub, iters: int) -> Tuple[float, object]:
        nonlocal total, n_tasks
        count, leftover = expand_bag(sub, iters, params)
        total += count
        n_tasks += 1
        return overhead_s + alpha_s_per_node * count, leftover

    def dispatch(bag, shp: TaskShape) -> None:
        nonlocal active, peak
        subs = bag.split(shp.split_factor) if bag.size > 1 else [bag]
        for sub in subs:
            dur, leftover = run_task(sub, shp.iters)
            if active < workers:
                active += 1
                peak = max(peak, active)
                heapq.heappush(heap, (clock + dur, next(counter),
                                      leftover))
            else:
                waiting.append((dur, leftover))

    shp = shape
    dispatch(Bag.root(params, device), shp)
    while heap:
        clock, _, leftover = heapq.heappop(heap)
        active -= 1
        trace.append((clock, active))
        if controller is not None:
            shp = controller.update(active)
        if leftover.size:
            dispatch(leftover, shp)
        while waiting and active < workers:
            dur, left2 = waiting.pop()
            active += 1
            peak = max(peak, active)
            heapq.heappush(heap, (clock + dur, next(counter), left2))

    return SimPoolResult(count=total, virtual_time_s=clock,
                         tasks=n_tasks, peak_concurrency=peak,
                         concurrency_trace=trace[:10000])
