"""Streaming trace store — bounded-memory ``EventLog`` backend (tentpole
part 1).

``EventLog`` keeps every event in one in-memory list, which caps a run
at whatever the master's RAM can hold — the ROADMAP's million-task runs
could not even record themselves.  :class:`TraceStore` is a drop-in
``EventLog`` subclass with a different storage discipline:

* **append-only JSONL writer** — every event is serialized to one line
  of ``path`` as it is emitted (buffered; ``flush`` on read);
* **in-memory ring** — only the newest ``ring_size`` events stay
  resident (the hot tail schedulers and tests inspect);
* **seekable reader** — a sparse byte-offset index (every
  ``index_every`` events) lets :meth:`iter_events` start mid-trace
  without scanning from byte 0; :class:`TraceReader` replays a finished
  trace file with the same interface;
* **incremental analytics** — the derived views (``concurrency_series``
  / ``capacity_series`` / ``cold_starts`` / ``peak_concurrency`` /
  ``counts`` / ``span``) come from the attached
  :class:`~repro_torch.trace.analytics.TraceAnalytics`, maintained at append
  time, so reads are O(answer), not O(trace).

Pools adopt a store via their ``trace=`` keyword
(``SimPool(..., trace=TraceStore(...))`` — see ``repro_torch.core``); the
pool rebinds the store's clock to its own, so virtual-time runs spill
virtual timestamps.  Serialization round-trips every ``Event`` field
including the attached ``TaskRecord`` losslessly (JSON floats are
shortest-round-trip reprs).
"""
from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from ..core.futures import TaskRecord
from ..core.telemetry import (CANCEL, CAPACITY_GROW, CAPACITY_SHRINK,
                              COMPLETE, EVENT_KINDS, SUBMIT, Clock,
                              Event, EventLog)
from .analytics import TraceAnalytics

__all__ = ["TraceStore", "ShardedTraceStore", "TraceReader",
           "event_to_dict", "event_from_dict", "read_trace",
           "iter_trace_events"]


def iter_trace_events(trace) -> Iterable[Event]:
    """Normalize any trace-shaped input — a spill-backed store (has
    ``iter_events``), a plain ``EventLog``, or a raw event iterable —
    into one event stream.  The single entry point ``replay`` and
    ``calibrate`` consume, so they always accept the same shapes."""
    it = getattr(trace, "iter_events", None)
    if it is not None:
        return it()
    if isinstance(trace, EventLog):
        return trace.events()
    return trace

_EVENT_FIELDS = ("task_id", "worker", "capacity", "ok", "parent",
                 "payload")
_RECORD_FIELDS = ("task_id", "worker", "submit_time", "start_time",
                  "end_time", "cost_hint", "remote", "attempts")


def event_to_dict(ev: Event) -> dict:
    d = {"t": ev.t, "kind": ev.kind}
    for f in _EVENT_FIELDS:
        v = getattr(ev, f)
        if v is not None:
            d[f] = v
    if ev.record is not None:
        d["record"] = {f: getattr(ev.record, f) for f in _RECORD_FIELDS}
    return d


def event_from_dict(d: dict) -> Event:
    rec = d.get("record")
    return Event(
        t=d["t"], kind=d["kind"],
        task_id=d.get("task_id"), worker=d.get("worker"),
        capacity=d.get("capacity"), ok=d.get("ok"),
        record=TaskRecord(**rec) if rec is not None else None,
        parent=d.get("parent"), payload=d.get("payload"))


class TraceStore(EventLog):
    """Ring-buffer + JSONL-spill execution timeline.

    Satisfies the full ``EventLog`` read/write API while holding at most
    ``ring_size`` events resident.  Full-history reads
    (:meth:`events`, :meth:`iter_events`, :attr:`records`) stream from
    the spill file; derived series come from the incremental analytics
    unless wall-clock jitter produced out-of-order timestamps, in which
    case the store falls back to a sorted recompute over the streamed
    history (virtual-clock pools are always monotone).
    """

    def __init__(self, clock: Optional[Clock] = None, *,
                 ring_size: int = 4096,
                 path: Optional[str] = None,
                 index_every: int = 1024,
                 max_series_points: int = 1 << 20) -> None:
        if ring_size <= 0:
            raise ValueError("ring_size must be positive")
        if index_every <= 0:
            raise ValueError("index_every must be positive")
        super().__init__(clock)
        self.ring_size = ring_size
        self.index_every = index_every
        self._ring: "deque[Event]" = deque(maxlen=ring_size)
        self._events = []  # base-class list intentionally unused
        self._analytics = TraceAnalytics(max_series_points)
        self._owns_path = path is None
        if path is None:
            fd, path = tempfile.mkstemp(prefix="repro-trace-",
                                        suffix=".jsonl")
            os.close(fd)
        self.path = path
        self._writer = open(path, "w", encoding="utf-8")
        self._offsets: List[int] = []   # offsets[i] = byte of event i*index_every
        self._written = 0
        self._bytes = 0
        self._closed = False

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
            if self._closed:
                raise RuntimeError(f"trace store {self.path} is closed")
            # stamp inside the lock (see EventLog.emit): concurrent
            # wall-clock emitters stay in timestamp order, keeping the
            # incremental analytics on its monotone fast path
            ev = Event(t=self.clock.now() if t is None else t, kind=kind,
                       task_id=task_id, worker=worker, capacity=capacity,
                       ok=ok, record=record, parent=parent,
                       payload=payload)
            line = json.dumps(event_to_dict(ev),
                              separators=(",", ":")) + "\n"
            if self._written % self.index_every == 0:
                self._offsets.append(self._bytes)
            self._writer.write(line)
            self._bytes += len(line.encode("utf-8"))
            self._written += 1
            self._ring.append(ev)
            self._analytics.observe(ev)
        return ev

    def flush(self) -> None:
        with self._lock:
            if not self._closed:
                self._writer.flush()

    def close(self, delete: Optional[bool] = None) -> None:
        """Flush and close the spill writer; further emits raise.

        ``delete`` controls whether the spill file is removed: default
        is to delete files the store created itself (anonymous temp
        spills must not pile up in ``$TMPDIR``) and to keep
        caller-named paths, which stay readable via
        :func:`read_trace`."""
        with self._lock:
            if self._closed:
                return
            self._writer.flush()
            self._writer.close()
            self._closed = True
            if delete is None:
                delete = self._owns_path
        if delete:
            try:
                os.unlink(self.path)
            except OSError:
                pass

    def __del__(self):  # pragma: no cover - interpreter-shutdown path
        try:
            self.close()
        except Exception:
            pass

    # -- read side ---------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return self._written

    @property
    def resident_events(self) -> int:
        """Events currently held in memory (<= ``ring_size``) — the
        bounded-memory claim, inspectable."""
        with self._lock:
            return len(self._ring)

    def iter_events(self, start: int = 0) -> Iterator[Event]:
        """Stream events ``[start, len(self))`` from the spill file,
        seeking via the sparse offset index instead of scanning from
        byte 0.  Snapshot semantics: events emitted after the call
        begins are not yielded."""
        with self._lock:
            end = self._written
            if start >= end:
                return
            if not self._closed:
                self._writer.flush()
            block = min(start // self.index_every,
                        len(self._offsets) - 1)
            offset = self._offsets[block]
        skip = start - block * self.index_every
        with open(self.path, "r", encoding="utf-8") as f:
            f.seek(offset)
            idx = start - skip
            for line in f:
                if idx >= end:
                    return
                if skip > 0:
                    skip -= 1
                else:
                    yield event_from_dict(json.loads(line))
                idx += 1

    def events(self, kind: Optional[str] = None) -> List[Event]:
        """Full history, materialized.  O(trace) transiently — prefer
        :meth:`iter_events` / the derived series at scale; the in-memory
        ring answers directly when nothing has spilled out of it yet."""
        with self._lock:
            if self._written <= len(self._ring):
                evs = list(self._ring)
            else:
                evs = None
        if evs is None:
            evs = list(self.iter_events())
        if kind is None:
            return evs
        return [e for e in evs if e.kind == kind]

    def __iter__(self):
        return self.iter_events()

    def iter_records(self) -> Iterator[TaskRecord]:
        for e in self.iter_events():
            if e.kind == COMPLETE and e.record is not None:
                yield e.record

    @property
    def records(self) -> List[TaskRecord]:
        return list(self.iter_records())

    def counts(self) -> dict:
        with self._lock:
            return dict(self._analytics.counts)

    def cold_starts(self) -> int:
        with self._lock:
            return self._analytics.cold_starts

    def span(self) -> Tuple[float, float]:
        with self._lock:
            return self._analytics.span()

    def peak_concurrency(self) -> int:
        with self._lock:
            if self._analytics.monotone:
                return self._analytics.peak_concurrency
        return max((a for _, a in self.concurrency_series()), default=0)

    def concurrency_series(self) -> List[Tuple[float, int]]:
        with self._lock:
            if self._analytics.monotone:
                return list(self._analytics.concurrency)
        # wall-clock jitter: fall back to the shared sorted recompute
        # over the full history (correctness over speed)
        return self._recompute_concurrency_series()

    def capacity_series(self) -> List[Tuple[float, int]]:
        with self._lock:
            if self._analytics.monotone:
                return list(self._analytics.capacity)
        return self._recompute_capacity_series()

    @property
    def analytics(self) -> TraceAnalytics:
        return self._analytics

    def utilization(self) -> dict:
        with self._lock:
            return self._analytics.utilization()

    def tail(self, start: int) -> EventLog:
        """Lazy per-run window (same quiescence contract as the base
        class): a view that *streams* ``[start, ...)`` from the spill
        file on every read instead of materializing the window — so a
        driver windowing a million-event store stays bounded-memory."""
        return _TraceWindow(self, max(0, start))


class _TraceWindow(EventLog):
    """Read-only tail view over a :class:`TraceStore` — every read
    streams from the spill file, nothing is materialized beyond the
    answer.  Assumes the store's quiescence-at-boundary contract
    (active count 0 at ``start``), exactly like ``EventLog.tail``."""

    def __init__(self, store: TraceStore, start: int) -> None:
        super().__init__(clock=store.clock)
        self._store = store
        self._start = start
        # (store generation, folded analytics) — see _fold()
        self._fold_cache: Optional[Tuple[int, TraceAnalytics]] = None

    def __len__(self) -> int:
        return max(0, len(self._store) - self._start)

    def _fold(self) -> TraceAnalytics:
        """ONE streamed pass over the window, cached per store
        generation: every derived view below reads the same fold, so
        repeated ``characterize()`` / cost reads on a reused pool parse
        the spilled JSONL once instead of once per view (~4x less
        parse).  The cache invalidates as soon as the store grows."""
        with self._store._lock:
            gen = self._store._written
        cached = self._fold_cache
        if cached is not None and cached[0] == gen:
            return cached[1]
        a = TraceAnalytics(self._store._analytics.max_series_points)
        for e in self.iter_events():
            a.observe(e)
        self._fold_cache = (gen, a)
        return a

    def iter_events(self, start: int = 0) -> Iterator[Event]:
        return self._store.iter_events(self._start + start)

    def events(self, kind: Optional[str] = None) -> List[Event]:
        evs = list(self.iter_events())
        if kind is None:
            return evs
        return [e for e in evs if e.kind == kind]

    def __iter__(self):
        return self.iter_events()

    def iter_records(self) -> Iterator[TaskRecord]:
        for e in self.iter_events():
            if e.kind == COMPLETE and e.record is not None:
                yield e.record

    @property
    def records(self) -> List[TaskRecord]:
        return list(self.iter_records())

    def counts(self) -> dict:
        return dict(self._fold().counts)

    def cold_starts(self) -> int:
        return self._fold().cold_starts

    def span(self) -> Tuple[float, float]:
        return self._fold().span()

    def concurrency_series(self) -> List[Tuple[float, int]]:
        a = self._fold()
        if a.monotone:
            return list(a.concurrency)
        # out-of-order timestamps: the shared sorted recompute (reads
        # the window via self.events())
        return EventLog._recompute_concurrency_series(self)

    def capacity_series(self) -> List[Tuple[float, int]]:
        a = self._fold()
        if a.monotone:
            return list(a.capacity)
        return EventLog._recompute_capacity_series(self)

    def peak_concurrency(self) -> int:
        a = self._fold()
        if a.monotone:
            return a.peak_concurrency
        return max((v for _, v in self.concurrency_series()), default=0)

    def tail(self, start: int) -> EventLog:
        return _TraceWindow(self._store, self._start + max(0, start))


class ShardedTraceStore(EventLog):
    """K per-shard :class:`TraceStore` segments behind ONE ``EventLog``
    surface — the trace backend of ``run_irregular(shards=K)``.

    Each master shard writes its own spill segment (no contention on a
    single writer); routing is by task ownership: a ``submit`` records
    the currently bound shard (see :meth:`bind_shard`, called by
    ``ShardView`` right before delegating a submission) as the task's
    owner, every later lifecycle event of that task lands in the same
    segment, and pool-level ``capacity_*`` events land in segment 0.
    Readers see one timeline: :meth:`iter_events` streams the
    timestamp-ordered union of all segments
    (``EventLog.iter_merged`` — a heap merge, O(answer) memory), and
    the derived series come from a *global* incremental
    :class:`TraceAnalytics` fed at emit time, so analytics, replay and
    cost accounting work unchanged on sharded runs.
    """

    def __init__(self, shards: int, clock: Optional[Clock] = None, *,
                 ring_size: int = 4096,
                 path: Optional[str] = None,
                 index_every: int = 1024,
                 max_series_points: int = 1 << 20) -> None:
        if shards <= 0:
            raise ValueError("shards must be positive")
        super().__init__(clock)
        self._events = []  # base-class list intentionally unused
        self._analytics = TraceAnalytics(max_series_points)
        self.segments: List[TraceStore] = [
            TraceStore(clock=self.clock, ring_size=ring_size,
                       path=(f"{path}.shard{i}" if path is not None
                             else None),
                       index_every=index_every,
                       max_series_points=max_series_points)
            for i in range(shards)
        ]
        self._owner: Dict[int, int] = {}   # task_id -> owning segment
        self._bound = 0
        self._written = 0

    # pools rebind ``trace.clock`` to their own at adoption — propagate
    # to every segment so all K writers stamp from the ONE clock
    @property
    def clock(self) -> Clock:
        return self._clock

    @clock.setter
    def clock(self, clock: Clock) -> None:
        self._clock = clock
        for seg in getattr(self, "segments", ()):
            seg.clock = clock

    def bind_shard(self, shard: int) -> None:
        """Route subsequent task submissions to segment ``shard``."""
        if not 0 <= shard < len(self.segments):
            raise IndexError(
                f"shard {shard} out of range for "
                f"{len(self.segments)} segments")
        self._bound = shard

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
            if kind in (CAPACITY_GROW, CAPACITY_SHRINK):
                seg = 0  # pool-level: ONE capacity staircase
            elif task_id is None:
                seg = self._bound
            elif kind == SUBMIT:
                self._owner[task_id] = seg = self._bound
            elif kind in (COMPLETE, CANCEL):
                # terminal: drop the owner entry so the map stays
                # bounded by in-flight tasks, not trace length
                seg = self._owner.pop(task_id, self._bound)
            else:
                seg = self._owner.get(task_id, self._bound)
            ev = self.segments[seg].emit(
                kind, t=t, task_id=task_id, worker=worker,
                capacity=capacity, ok=ok, record=record, parent=parent,
                payload=payload)
            self._written += 1
            self._analytics.observe(ev)
        return ev

    def flush(self) -> None:
        for seg in self.segments:
            seg.flush()

    def close(self, delete: Optional[bool] = None) -> None:
        for seg in self.segments:
            seg.close(delete)

    # -- read side ---------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return self._written

    @property
    def resident_events(self) -> int:
        return sum(seg.resident_events for seg in self.segments)

    @property
    def paths(self) -> List[str]:
        return [seg.path for seg in self.segments]

    def iter_events(self, start: int = 0) -> Iterator[Event]:
        """Stream the merged timeline from global index ``start`` —
        a heap merge over the segments' own chronological streams."""
        merged = EventLog.iter_merged(self.segments)
        return itertools.islice(merged, start, None)

    def events(self, kind: Optional[str] = None) -> List[Event]:
        evs = list(self.iter_events())
        if kind is None:
            return evs
        return [e for e in evs if e.kind == kind]

    def __iter__(self):
        return self.iter_events()

    def iter_records(self) -> Iterator[TaskRecord]:
        for e in self.iter_events():
            if e.kind == COMPLETE and e.record is not None:
                yield e.record

    @property
    def records(self) -> List[TaskRecord]:
        return list(self.iter_records())

    def counts(self) -> dict:
        with self._lock:
            return dict(self._analytics.counts)

    def cold_starts(self) -> int:
        with self._lock:
            return self._analytics.cold_starts

    def span(self) -> Tuple[float, float]:
        with self._lock:
            return self._analytics.span()

    def peak_concurrency(self) -> int:
        with self._lock:
            if self._analytics.monotone:
                return self._analytics.peak_concurrency
        return max((a for _, a in self.concurrency_series()), default=0)

    def concurrency_series(self) -> List[Tuple[float, int]]:
        with self._lock:
            if self._analytics.monotone:
                return list(self._analytics.concurrency)
        return self._recompute_concurrency_series()

    def capacity_series(self) -> List[Tuple[float, int]]:
        with self._lock:
            if self._analytics.monotone:
                return list(self._analytics.capacity)
        return self._recompute_capacity_series()

    @property
    def analytics(self) -> TraceAnalytics:
        return self._analytics

    def utilization(self) -> dict:
        with self._lock:
            return self._analytics.utilization()

    def tail(self, start: int) -> EventLog:
        """Streaming per-run window over the merged timeline (same
        contract as :meth:`TraceStore.tail`)."""
        return _TraceWindow(self, max(0, start))


class TraceReader:
    """Seekable reader over a finished trace file.

    Builds the same sparse offset index as the writer lazily, while
    scanning, so repeated :meth:`iter_from` calls seek instead of
    rescanning the prefix.  ``to_log()`` materializes into a plain
    :class:`EventLog` for the full derived-series API on small traces.
    """

    def __init__(self, path: str, index_every: int = 1024) -> None:
        self.path = path
        self.index_every = index_every
        self._offsets: List[int] = [0]   # byte offset of event i*index_every
        self._indexed_upto = 0           # events covered by the index
        self._lock = threading.Lock()

    def __iter__(self) -> Iterator[Event]:
        return self.iter_from(0)

    def iter_from(self, start: int = 0) -> Iterator[Event]:
        with self._lock:
            block = min(start // self.index_every,
                        len(self._offsets) - 1)
            offset = self._offsets[block]
        idx = block * self.index_every
        with open(self.path, "r", encoding="utf-8") as f:
            f.seek(offset)
            pos = offset
            for line in f:
                nxt = pos + len(line.encode("utf-8"))
                i, pos = idx, nxt
                idx += 1
                with self._lock:
                    if (i + 1) % self.index_every == 0 \
                            and i + 1 > self._indexed_upto:
                        blk = (i + 1) // self.index_every
                        if blk == len(self._offsets):
                            self._offsets.append(nxt)
                            self._indexed_upto = i + 1
                if i >= start:
                    yield event_from_dict(json.loads(line))

    def count(self) -> int:
        n = 0
        for _ in self:
            n += 1
        return n

    def to_log(self) -> EventLog:
        log = EventLog()
        log._events = list(self)
        return log


def read_trace(path: str) -> TraceReader:
    """Open a spilled trace file for streaming replay/analysis."""
    return TraceReader(path)
