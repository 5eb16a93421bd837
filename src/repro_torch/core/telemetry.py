"""Unified execution timeline — one clock, one event log, all pools.

Before this module each backend kept its own partial view of a run:
``ExecutorStats`` held a completion-record list *and* an ad-hoc
``(t, active)`` trace, ``HybridExecutor`` bolted a shared
``ConcurrencyTracker`` on top to recover the true combined peak, and
``SimPool`` advanced a private ``_clock`` float nobody else could read.
Cost accounting and characterization then re-derived time series from
whichever fragment happened to survive.

Now there is a single source of truth:

* :class:`Clock` — the time protocol.  :class:`WallClock` is
  ``time.monotonic``; :class:`VirtualClock` is the discrete-event
  pool's settable clock.  Everything downstream (events, records,
  billing) is agnostic to which one stamped it.
* :class:`EventLog` — an append-only timeline of typed events::

      submit          task entered the pool
      cold_start      a new container was provisioned for this start
      start           a worker began executing an attempt
      requeue         a transient attempt failed; slot freed, task requeued
      complete        terminal settlement (carries the TaskRecord)
      capacity_grow   pool was resized up (carries the new capacity)
      capacity_shrink pool was resized down
      worker_killed   an injected fault killed the attempt's container
      throttled       admission backed off (rate limit / storm)
      cancel          a pending task was cancelled (fail-fast siblings)
      folded          master journaled a folded result (WAL entry)
      checkpoint      master journaled a WAL segment checkpoint
                      (encoded accumulator + pending multiset)

  Derived views — :attr:`EventLog.records`,
  :meth:`EventLog.concurrency_series`, :meth:`EventLog.capacity_series`,
  :meth:`EventLog.cold_starts` — are computed from the timeline, so
  ``characterization`` and ``costmodel`` read one artifact instead of
  three.  Since the ``repro.trace`` subsystem they are maintained
  *incrementally* as events append (a
  :class:`~repro.trace.analytics.TraceAnalytics` attached at
  construction): the old sort-the-whole-log recompute — O(n log n) per
  read — survives only as the fallback for timelines whose events were
  injected out-of-band (:meth:`tail` / :meth:`merged` views) or whose
  wall-clock timestamps landed out of order.

``EventLog.merged`` builds a read-only union timeline (used by
``HybridExecutor`` to expose its two sub-pools as one history).  For
bounded-memory recording at scale, use the ring-buffer + JSONL-spill
subclass :class:`repro.trace.store.TraceStore` (every pool accepts it
via the ``trace=`` constructor keyword).

Beside the timeline, on the same clock, a span recorder for host work
finer than a task (:class:`Span`; :func:`enable_spans`, :func:`spans`,
:func:`clear_spans`, :func:`spans_dropped`).  The event log is the
write-ahead log and the replay input, so spans stay out of its kinds.
The master loop (``master.*``), the pool's worker (``pool.*``) and the
UTS kernel's launch path (``uts.*``) record them; off, which is the
default, each site costs one test of :data:`SPANS_ON`.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass
from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

from .futures import TaskRecord

__all__ = [
    "Clock", "WallClock", "VirtualClock",
    "Event", "EventLog", "EVENT_KINDS", "PARENT_ROOT",
    "SUBMIT", "COLD_START", "START", "REQUEUE", "COMPLETE",
    "CAPACITY_GROW", "CAPACITY_SHRINK",
    "WORKER_KILLED", "THROTTLED", "CANCEL", "FOLDED", "CHECKPOINT",
    "Span", "SPAN_CAP", "enable_spans", "spans", "clear_spans",
    "spans_dropped", "add_span", "current_task", "set_current_task",
]

SUBMIT = "submit"
COLD_START = "cold_start"
START = "start"
REQUEUE = "requeue"
COMPLETE = "complete"
CAPACITY_GROW = "capacity_grow"
CAPACITY_SHRINK = "capacity_shrink"
WORKER_KILLED = "worker_killed"
THROTTLED = "throttled"
CANCEL = "cancel"
FOLDED = "folded"
CHECKPOINT = "checkpoint"

EVENT_KINDS = (SUBMIT, COLD_START, START, REQUEUE, COMPLETE,
               CAPACITY_GROW, CAPACITY_SHRINK,
               WORKER_KILLED, THROTTLED, CANCEL, FOLDED, CHECKPOINT)

#: ``Event.parent`` sentinel for an explicit root submit (no spawning
#: completion).  ``parent=None`` means the recording predates parent
#: tracking — consumers (trace replay) then fall back to the
#: attributed-to-last-completion heuristic.
PARENT_ROOT = -1

_ANALYTICS_CLS = None


def _new_analytics():
    """Lazily bind ``repro.trace.analytics.TraceAnalytics`` — imported
    at first :class:`EventLog` construction (never at module import) so
    the core<-trace layering carries no import cycle."""
    global _ANALYTICS_CLS
    if _ANALYTICS_CLS is None:
        try:
            from ..trace.analytics import TraceAnalytics
            _ANALYTICS_CLS = TraceAnalytics
        except ImportError:  # pragma: no cover - trace pkg stripped
            _ANALYTICS_CLS = False
    return _ANALYTICS_CLS() if _ANALYTICS_CLS else None


class Clock:
    """Time protocol: anything with a ``now() -> float`` method.

    Wall and virtual clocks are interchangeable everywhere a timestamp
    is taken, which is what lets one ``ProviderModel`` drive both the
    real ``ElasticExecutor`` and the discrete-event ``SimPool``.
    """

    def now(self) -> float:  # pragma: no cover - protocol
        raise NotImplementedError


class WallClock(Clock):
    """Real time (``time.monotonic``)."""

    def now(self) -> float:
        return time.monotonic()


class VirtualClock(Clock):
    """Settable clock for discrete-event simulation.

    ``advance_to`` never moves backwards — completion events may be
    popped with equal timestamps, and a monotone clock keeps the
    derived series well-ordered.
    """

    def __init__(self, start: float = 0.0) -> None:
        self._t = start

    def now(self) -> float:
        return self._t

    def advance_to(self, t: float) -> None:
        if t > self._t:
            self._t = t


@dataclass(frozen=True)
class Event:
    """One timeline entry.  Only the fields relevant to ``kind`` are
    set: ``record`` on ``complete``, ``capacity`` on ``capacity_*``,
    ``task_id``/``worker`` on task-lifecycle kinds.  ``parent`` (on
    ``submit``) records the task id of the completion that spawned this
    dispatch — :data:`PARENT_ROOT` for seeds/arrivals with no spawning
    completion, ``None`` when the emitter did not track parentage.
    ``payload`` is an opaque JSON-serializable blob for write-ahead-log
    kinds (``folded`` entries carry the encoded item + result)."""

    t: float
    kind: str
    task_id: Optional[int] = None
    worker: Optional[str] = None
    capacity: Optional[int] = None
    ok: Optional[bool] = None
    record: Optional[TaskRecord] = None
    parent: Optional[int] = None
    payload: Optional[object] = None


class EventLog:
    """Append-only, thread-safe execution timeline.

    One log per pool (``pool.events``); the hybrid pool exposes a
    merged view over its sub-pools' logs.  All derived series are
    recomputed from the event list on demand — the log itself stores
    nothing twice.
    """

    def __init__(self, clock: Optional[Clock] = None) -> None:
        self.clock = clock or WallClock()
        self._lock = threading.Lock()
        self._events: List[Event] = []
        self._analytics = _new_analytics()

    # -- write side --------------------------------------------------------
    def emit(self, kind: str, *, t: Optional[float] = None,
             task_id: Optional[int] = None, worker: Optional[str] = None,
             capacity: Optional[int] = None, ok: Optional[bool] = None,
             record: Optional[TaskRecord] = None,
             parent: Optional[int] = None,
             payload: Optional[object] = None) -> Event:
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r}")
        with self._lock:
            # stamp INSIDE the lock: arrival order then equals
            # timestamp order by construction, so concurrent wall-clock
            # emitters cannot race the analytics out of its monotone
            # fast path
            ev = Event(t=self.clock.now() if t is None else t, kind=kind,
                       task_id=task_id, worker=worker, capacity=capacity,
                       ok=ok, record=record, parent=parent,
                       payload=payload)
            self._events.append(ev)
            if self._analytics is not None:
                self._analytics.observe(ev)
        return ev

    def _valid_analytics(self):
        """(Caller holds the lock.)  The incremental engine, iff it has
        observed exactly this timeline in monotone order — the fast path
        for every derived series below."""
        a = self._analytics
        if a is not None and a.valid(len(self._events)):
            return a
        return None

    # -- read side ---------------------------------------------------------
    def events(self, kind: Optional[str] = None) -> List[Event]:
        with self._lock:
            evs = list(self._events)
        if kind is None:
            return evs
        return [e for e in evs if e.kind == kind]

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def __iter__(self):
        return iter(self.events())

    def counts(self) -> dict:
        """Event count per kind (quick structural check)."""
        with self._lock:
            a = self._valid_analytics()
            if a is not None:
                return dict(a.counts)
        out = {k: 0 for k in EVENT_KINDS}
        for e in self.events():
            out[e.kind] += 1
        return out

    @property
    def records(self) -> List[TaskRecord]:
        """Completion records, derived from ``complete`` events."""
        return [e.record for e in self.events(COMPLETE)
                if e.record is not None]

    def iter_records(self):
        """Stream completion records (single pass, no second list —
        what ``costmodel`` consumes at scale)."""
        for e in self.events(COMPLETE):
            if e.record is not None:
                yield e.record

    def cold_starts(self) -> int:
        with self._lock:
            a = self._valid_analytics()
            if a is not None:
                return a.cold_starts
        return len(self.events(COLD_START))

    def span(self) -> Tuple[float, float]:
        """(first, last) event timestamps; (0, 0) when empty."""
        with self._lock:
            a = self._valid_analytics()
            if a is not None:
                return a.span()
        evs = self.events()
        if not evs:
            return (0.0, 0.0)
        ts = [e.t for e in evs]
        return (min(ts), max(ts))

    def concurrency_series(self) -> List[Tuple[float, int]]:
        """(t, active) after every start / requeue / complete event —
        the live concurrency-over-time curve (paper Fig. 4).  Served
        from the incremental analytics (O(answer)); the sorted recompute
        below is the out-of-order / injected-events fallback."""
        with self._lock:
            a = self._valid_analytics()
            if a is not None:
                return list(a.concurrency)
        return self._recompute_concurrency_series()

    def _recompute_concurrency_series(self) -> List[Tuple[float, int]]:
        series: List[Tuple[float, int]] = []
        active = 0
        for e in sorted(self.events(), key=lambda e: e.t):
            if e.kind == START:
                active += 1
            elif e.kind in (COMPLETE, REQUEUE):
                active -= 1
            else:
                continue
            series.append((e.t, active))
        return series

    def capacity_series(self) -> List[Tuple[float, int]]:
        """(t, capacity) after every resize (includes the initial
        capacity announcement each pool emits at construction)."""
        with self._lock:
            a = self._valid_analytics()
            if a is not None:
                return list(a.capacity)
        return self._recompute_capacity_series()

    def _recompute_capacity_series(self) -> List[Tuple[float, int]]:
        return [(e.t, e.capacity)
                for e in sorted(self.events(), key=lambda e: e.t)
                if e.kind in (CAPACITY_GROW, CAPACITY_SHRINK)
                and e.capacity is not None]

    def peak_concurrency(self) -> int:
        with self._lock:
            a = self._valid_analytics()
            if a is not None:
                return a.peak_concurrency
        series = self.concurrency_series()
        return max((a for _, a in series), default=0)

    # -- composition -------------------------------------------------------
    def tail(self, start: int) -> "EventLog":
        """Read-only view of the timeline from event index ``start`` —
        the per-run window when a long-lived pool is reused (capture
        ``len(pool.events)`` before the run, slice after).  Assumes the
        pool is quiescent across the boundary: in-flight tasks from an
        earlier window leave their ``start`` events behind."""
        out = EventLog(clock=self.clock)
        out._events = self.events()[max(0, start):]
        return out

    @classmethod
    def merged(cls, logs: Sequence["EventLog"],
               clock: Optional[Clock] = None,
               exclude_kinds: Sequence[str] = ()) -> "EventLog":
        """Read-only union of several timelines, sorted by timestamp.

        Used by composite pools (hybrid) whose sub-pools each own a log:
        the merged concurrency series is the *true* combined curve, not
        a sum of independently-peaking traces.  ``exclude_kinds`` drops
        event kinds that do not aggregate (e.g. sub-pool capacity
        announcements, which a composite replaces with its own)."""
        out = cls(clock=clock or (logs[0].clock if logs else None))
        evs: List[Event] = []
        for log in logs:
            evs.extend(e for e in log.events()
                       if e.kind not in exclude_kinds)
        evs.sort(key=lambda e: e.t)
        out._events = evs
        return out

    @staticmethod
    def iter_merged(logs: Sequence["EventLog"],
                    exclude_kinds: Sequence[str] = ()) -> Iterable[Event]:
        """Stream the timestamp-ordered union of several timelines
        WITHOUT materializing any of them — a ``heapq.merge`` over each
        log's own (already chronological) stream.  This is how a
        :class:`~repro.trace.store.ShardedTraceStore` presents K
        per-shard segments as one timeline in O(answer) memory;
        spill-backed logs contribute via their streaming
        ``iter_events`` when they have one."""
        import heapq

        def stream(log: "EventLog") -> Iterable[Event]:
            it = getattr(log, "iter_events", None)
            events = it() if it is not None else log.events()
            if not exclude_kinds:
                return events
            return (e for e in events if e.kind not in exclude_kinds)

        return heapq.merge(*(stream(log) for log in logs),
                           key=lambda e: e.t)


# -- spans -----------------------------------------------------------------

class Span(NamedTuple):
    """One stretch of host work.  ``start`` and ``end`` are
    ``time.monotonic`` seconds, the clock of :class:`WallClock`;
    ``task_id`` is the pool task the work belongs to (``None`` where none
    does); ``thread`` is the recording thread's ``threading.get_ident()``,
    so spans on one thread nest."""

    name: str
    start: float
    end: float
    task_id: Optional[int]
    thread: int


#: spans kept in memory at most; later ones are counted, not kept
SPAN_CAP = 1 << 20

#: whether the sites record spans (set it with :func:`enable_spans`).
#: Sites read it as ``telemetry.SPANS_ON``: a name imported from this
#: module would be a copy that never changes
SPANS_ON = False

# appended to from every worker thread without a lock: ``list.append``
# and ``next`` on an ``itertools.count`` are atomic under the GIL, and the
# ticket decides which spans the cap keeps.  Only a span past the cap
# takes a lock, to count itself
_spans: List[Span] = []
_tickets = itertools.count()
_dropped = 0
_dropped_lock = threading.Lock()
_local = threading.local()


def enable_spans(on: bool = True) -> None:
    """Turn span recording on or off; what was kept stays."""
    global SPANS_ON
    SPANS_ON = bool(on)


def spans() -> List[Span]:
    """The spans kept so far, in the order they were recorded."""
    return list(_spans)


def clear_spans() -> None:
    """Forget the spans kept and the count of those dropped (call it with
    no run recording)."""
    global _tickets, _dropped
    _spans.clear()
    _tickets = itertools.count()
    _dropped = 0


def spans_dropped() -> int:
    """Spans recorded past :data:`SPAN_CAP` since the last clear."""
    return _dropped


def add_span(name: str, start: float, end: float,
             task_id: Optional[int] = None) -> None:
    """Keep one span of the calling thread (sites call it only while
    :data:`SPANS_ON` is set)."""
    global _dropped
    if next(_tickets) < SPAN_CAP:
        _spans.append(Span(name, start, end, task_id,
                           threading.get_ident()))
    else:
        with _dropped_lock:
            _dropped += 1


def set_current_task(task_id: Optional[int]) -> None:
    """The pool task the calling thread runs (the pool sets it around a
    task body while spans are on), for spans that cannot be told it."""
    _local.task_id = task_id


def current_task() -> Optional[int]:
    """The task :func:`set_current_task` last gave this thread."""
    return getattr(_local, "task_id", None)
