"""Future / task primitives for the elastic executor middleware.

Mirrors the paper's use of the Java concurrency library: tasks are
``Callable``-style zero-argument closures submitted to an executor which
returns a ``Future``.  Tasks are *stateless* (paper §3.3 Limitation #2):
all data in via the closure's bound arguments, all data out via the return
value.  This matches functional JAX perfectly — a jitted function plus its
operands is a serializable, idempotent unit of work, which is what makes
straggler re-dispatch and fault re-execution safe.

Completion is *event-driven*: every future carries done-callbacks, and
``CompletionQueue`` multiplexes any number of futures onto one
condition variable so masters (``as_completed``, ``run_irregular``)
block instead of busy-polling the result queue.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Iterable, List, Optional

_task_counter = itertools.count()


class TaskState(Enum):
    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    CANCELLED = "cancelled"


class WorkerKilledError(RuntimeError):
    """A worker (container) died mid-task.

    Raised inside an executing attempt by fault injection
    (``repro.chaos.FaultPlan``) and surfaced to the caller only when a
    task exhausts its kill-retry budget — under a plan's default budget
    the task is transparently re-executed on a fresh container, which
    is exactly the statelessness guarantee (paper §3.3) that makes
    re-dispatch safe.
    """


class ElasticFuture:
    """Result handle for a submitted task (paper's ``Future<T>``)."""

    def __init__(self, task: "Task"):
        self._task = task
        self._event = threading.Event()
        self._result: Any = None
        self._exc: Optional[BaseException] = None
        self._state = TaskState.PENDING
        self._lock = threading.Lock()
        self._callbacks: List[Callable[["ElasticFuture"], None]] = []

    # -- executor-side -------------------------------------------------
    def _set_running(self) -> None:
        with self._lock:
            if self._state is TaskState.PENDING:
                self._state = TaskState.RUNNING

    _SETTLED = (TaskState.DONE, TaskState.FAILED, TaskState.CANCELLED)

    def _set_result(self, value: Any) -> None:
        with self._lock:
            if self._state in self._SETTLED:
                return  # first settlement wins (speculative duplicates)
            self._result = value
            self._state = TaskState.DONE
        self._event.set()
        self._invoke_callbacks()

    def _set_exception(self, exc: BaseException) -> None:
        with self._lock:
            if self._state in self._SETTLED:
                return
            self._exc = exc
            self._state = TaskState.FAILED
        self._event.set()
        self._invoke_callbacks()

    def _invoke_callbacks(self) -> None:
        with self._lock:
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    # -- client-side ----------------------------------------------------
    def add_done_callback(self,
                          fn: Callable[["ElasticFuture"], None]) -> None:
        """Run ``fn(self)`` once the future settles (done / failed /
        cancelled); immediately if it already has.  The notification
        backbone of ``CompletionQueue`` — never called with the future's
        lock held."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def cancel(self) -> bool:
        with self._lock:
            if self._state is TaskState.PENDING:
                self._state = TaskState.CANCELLED
                self._event.set()
                cancelled = True
            else:
                cancelled = False
        if cancelled:
            self._invoke_callbacks()
        return cancelled

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"task {self._task.task_id} not done within {timeout}s")
        if self._exc is not None:
            raise self._exc
        if self._state is TaskState.CANCELLED:
            raise RuntimeError(f"task {self._task.task_id} was cancelled")
        return self._result

    def exception(self, timeout: Optional[float] = None) -> Optional[BaseException]:
        self._event.wait(timeout)
        return self._exc

    @property
    def state(self) -> TaskState:
        return self._state


@dataclass
class Task:
    """A stateless unit of work: ``fn(*args, **kwargs) -> result``.

    ``cost_hint`` lets callers pass an a-priori work estimate (e.g. UTS bag
    size) used by the characterization module and the adaptive controller.
    """

    fn: Callable[..., Any]
    args: tuple = ()
    kwargs: dict = field(default_factory=dict)
    cost_hint: float = 1.0
    task_id: int = field(default_factory=lambda: next(_task_counter))
    submit_time: float = field(default_factory=time.monotonic)
    # Filled in by the executor:
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    worker: Optional[str] = None
    attempts: int = 0

    def run(self) -> Any:
        return self.fn(*self.args, **self.kwargs)

    @property
    def duration(self) -> Optional[float]:
        if self.start_time is None or self.end_time is None:
            return None
        return self.end_time - self.start_time


@dataclass
class TaskRecord:
    """Immutable completion record for characterization & cost accounting."""

    task_id: int
    worker: str
    submit_time: float
    start_time: float
    end_time: float
    cost_hint: float
    remote: bool
    attempts: int = 1

    @property
    def duration(self) -> float:
        return self.end_time - self.start_time

    @property
    def queue_delay(self) -> float:
        return self.start_time - self.submit_time


class CompletionQueue:
    """Event-driven fan-in of future completions.

    Futures are registered with :meth:`add`; their done-callbacks push
    them onto an internal deque and notify a single condition variable,
    so consumers *block* in :meth:`next` instead of polling ``done()``
    at 100 us (the old ``as_completed`` hot loop).

    Virtual-time pools (``SimPool``) cannot rely on wall-clock wakeups:
    their futures complete only when the event heap is pumped.  A future
    exposing a ``_sim`` attribute enrolls its pool as an *advancer*;
    when nothing is done yet, :meth:`next` advances virtual time by one
    event instead of sleeping.
    """

    def __init__(self, futures: Iterable["ElasticFuture"] = ()) -> None:
        self._cond = threading.Condition()
        self._done: "collections.deque[ElasticFuture]" = collections.deque()
        self._pending: set = set()
        self._advancers: set = set()
        for f in futures:
            self.add(f)

    def add(self, future: "ElasticFuture") -> None:
        with self._cond:
            self._pending.add(future)
        sim = getattr(future, "_sim", None)
        if sim is not None:
            self._advancers.add(sim)
        future.add_done_callback(self._notify)

    def _notify(self, future: "ElasticFuture") -> None:
        with self._cond:
            self._pending.discard(future)
            self._done.append(future)
            self._cond.notify_all()

    def pending_count(self) -> int:
        with self._cond:
            return len(self._pending)

    def __len__(self) -> int:
        with self._cond:
            return len(self._pending) + len(self._done)

    def next(self, timeout: Optional[float] = None) -> "ElasticFuture":
        """Block until any registered future settles and return it.

        Raises ``TimeoutError`` after ``timeout`` seconds with futures
        still pending, and ``LookupError`` if called with nothing
        registered at all.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._cond:
                if self._done:
                    return self._done.popleft()
                if not self._pending:
                    raise LookupError("no futures registered")
                n_pending = len(self._pending)
            # virtual-time pools: advance one event instead of waiting
            if any(pool._pump_one() for pool in self._advancers):
                continue
            with self._cond:
                if self._done:
                    continue
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"{n_pending} futures still pending")
                self._cond.wait(remaining)

    def drain(self, max_items: Optional[int] = None,
              timeout: Optional[float] = None) -> List["ElasticFuture"]:
        """Pop *every* settled future under one lock acquisition.

        Blocks exactly like :meth:`next` until at least one future has
        settled, then returns the whole ready batch (oldest first, up
        to ``max_items``) instead of one item per lock round-trip —
        the batched completion delivery ``run_irregular`` amortizes its
        settle cost with.  Raises ``TimeoutError`` after ``timeout``
        seconds with nothing settled and ``LookupError`` when no future
        is registered at all, same as :meth:`next`.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._cond:
                if self._done:
                    if max_items is None or max_items >= len(self._done):
                        out = list(self._done)
                        self._done.clear()
                    else:
                        out = [self._done.popleft()
                               for _ in range(max_items)]
                    return out
                if not self._pending:
                    raise LookupError("no futures registered")
                n_pending = len(self._pending)
            # virtual-time pools: advance one event instead of waiting
            if any(pool._pump_one() for pool in self._advancers):
                continue
            with self._cond:
                if self._done:
                    continue
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"{n_pending} futures still pending")
                self._cond.wait(remaining)
