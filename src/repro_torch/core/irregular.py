"""Generic master loop for irregular algorithms (``run_irregular``).

The paper's three case studies (UTS Listing 2, Mariani-Silver
Listing 3, BC Listing 4) share one skeleton: seed the pool with tasks,
drain a result queue, fold results into state, spawn follow-up tasks,
optionally retune the two §5.2 knobs from live concurrency.  The three
copy-pasted drivers of old are now one event-driven loop; a workload is
a declarative :class:`WorkSpec`:

    seed(shape)          -> initial work items
    execute(item, shape) -> result            (the stateless task body)
    split(result, shape) -> follow-up items   (nested parallelism)
    reduce(state, result)-> state             (master-side fold)

plus ``init``/``finalize`` for the accumulator, ``cost_hint`` for
characterization, and an optional ``execute_batch`` fused body: with
``run_irregular(..., batching=True)`` the driver drains ready items
through ``pool.submit_batch`` in chunks of up to ``idle_capacity``,
replacing N tiny per-task kernel dispatches with one vectorized call
(the application-level overhead amortization of §5.2).  Any :class:`~repro_torch.core.pool.Pool` backend works —
``local``, ``elastic``, ``hybrid``, or the virtual-time ``sim`` pool —
and stragglers can be speculatively re-dispatched (stateless tasks make
duplication safe; the first completion wins at the future level).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from . import telemetry
from .adaptive import TaskShape
from .costmodel import CostReport, serverless_cost
from .futures import CompletionQueue, ElasticFuture, TaskState
from .pool import Pool
from .provider import AutoscalePolicy
from .telemetry import (CHECKPOINT, FOLDED, PARENT_ROOT, REQUEUE,
                        WORKER_KILLED)

__all__ = ["WorkSpec", "IrregularResult", "run_irregular"]


def _no_children(result: Any, shape: TaskShape) -> Iterable[Any]:
    return ()


def _keep_state(state: Any, result: Any) -> Any:
    return state


@dataclass(frozen=True)
class WorkSpec:
    """Declarative description of an irregular workload.

    ``execute`` must be a *stateless* function of ``(item, shape)`` —
    all data in via arguments, all data out via the return value — so
    re-dispatch (stragglers, failures) is safe.  Everything else runs
    master-side.
    """

    name: str
    #: stateless task body: (item, shape) -> result
    execute: Callable[[Any, TaskShape], Any]
    #: initial frontier: shape -> iterable of work items
    seed: Callable[[TaskShape], Iterable[Any]]
    #: follow-up work from a result (leftover bags, split rects); () to stop
    split: Callable[[Any, TaskShape], Iterable[Any]] = _no_children
    #: master-side fold of a result into the accumulator
    reduce: Callable[[Any, Any], Any] = _keep_state
    #: accumulator constructor
    init: Callable[[], Any] = lambda: None
    #: associative+commutative combine of two accumulators — required
    #: for ``run_irregular(..., shards=K)``: each shard folds its own
    #: accumulator with ``reduce`` and the driver tree-merges the K
    #: partials at join.  For bit-identical results across any K, the
    #: (reduce, merge, finalize) triple must be order-insensitive
    #: (exact int/counter sums, disjoint writes, or a canonicalizing
    #: ``finalize`` — see ``bc_spec``).
    merge: Optional[Callable[[Any, Any], Any]] = None
    #: final state -> output transform
    finalize: Callable[[Any], Any] = lambda state: state
    #: a-priori work estimate per item (characterization / cost model)
    cost_hint: Callable[[Any], float] = lambda item: 1.0
    #: optional fused task body: (items, shape) -> one result per item.
    #: Must be equivalent to mapping ``execute`` over the items — the
    #: driver may fuse any subset of ready items through it (one
    #: vectorized kernel invocation instead of N tiny ones) when
    #: ``run_irregular(..., batching=True)``.
    execute_batch: Optional[
        Callable[[List[Any], TaskShape], List[Any]]] = None
    #: WAL codecs (master crash recovery, ``repro_torch.chaos``).
    #: ``encode_item`` maps a work item to a JSON-able value used as a
    #: canonical *matching key* — it is never decoded, so it only needs
    #: to be injective, not invertible.  ``encode_result`` /
    #: ``decode_result`` must round-trip a result exactly (bit-for-bit
    #: for array payloads): recovery re-folds journaled results with
    #: ``reduce``, and ``resume_from=`` is bit-identical only if the
    #: replayed results are.
    encode_item: Optional[Callable[[Any], Any]] = None
    encode_result: Optional[Callable[[Any], Any]] = None
    decode_result: Optional[Callable[[Any], Any]] = None
    #: WAL segment-checkpoint codecs (``checkpoint_every=``).  A
    #: checkpoint journals the encoded accumulator plus the pending
    #: multiset, so recovery replays only the journal tail past it —
    #: ``encode_state``/``decode_state`` must round-trip the
    #: accumulator exactly, and ``decode_item`` must invert
    #: ``encode_item`` (unlike plain WAL replay, checkpointed pending
    #: items are *reconstructed* from their encodings, not re-derived
    #: from seed/split).
    decode_item: Optional[Callable[[Any], Any]] = None
    encode_state: Optional[Callable[[Any], Any]] = None
    decode_state: Optional[Callable[[Any], Any]] = None
    #: default task shape (split_factor, iters) when none is passed
    shape: TaskShape = TaskShape(1, 1)


@dataclass
class IrregularResult:
    """Outcome of one ``run_irregular`` drive.

    ``cost`` and the two time series are computed live from the pool's
    event timeline (``pool.events``) — billing and the Fig.-4-style
    concurrency curve come out of the same run that produced the
    output, not a post-hoc reconstruction.  On virtual-time pools the
    series timestamps and the billed makespan are virtual.
    """

    output: Any
    wall_time_s: float
    tasks: int                      # dispatches issued by this driver
    peak_concurrency: int = 0
    controller_transitions: list = field(default_factory=list)
    speculated: int = 0             # straggler duplicates issued
    pool_snapshot: Dict[str, Any] = field(default_factory=dict)
    #: makespan used for billing: virtual time on sim pools, else wall
    makespan_s: float = 0.0
    #: Eq. 3-6 over the pool's timeline (client VM billed for makespan)
    cost: Optional[CostReport] = None
    #: (t, active) concurrency-over-time curve from the timeline
    concurrency_series: List[tuple] = field(default_factory=list)
    #: (t, capacity) resize history (autoscale + explicit resizes)
    capacity_series: List[tuple] = field(default_factory=list)
    #: container provisions observed during the run (provider models)
    cold_starts: int = 0
    #: (old, new) capacity decisions the autoscale policy issued
    autoscale_decisions: List[tuple] = field(default_factory=list)
    #: master shards that drove the run (1 = classic single master)
    shards: int = 1
    #: work-stealing transfers between shards (sharded driver only)
    steals: int = 0
    #: transient attempts requeued for retry (timeline ``requeue``
    #: count — derived like ``cold_starts``)
    retries: int = 0
    #: injected container deaths survived (timeline ``worker_killed``)
    worker_deaths: int = 0
    #: frontier items reconstructed from the WAL when the run was
    #: started with ``resume_from=`` (0 on a fresh run)
    recovered_tasks: int = 0
    #: DAG runs only (``repro.dag.DagSpec``): longest dependency chain
    #: executed (nodes on the critical path; 0 for tree workloads)
    critical_path_len: int = 0
    #: DAG runs only: executed nodes per dependency depth —
    #: ``stage_widths[d]`` counts the nodes whose longest path from a
    #: root has ``d`` edges (the irregular stage-width profile)
    stage_widths: List[int] = field(default_factory=list)
    #: DAG runs only: total nodes executed (static + dynamically
    #: expanded)
    dag_nodes: int = 0

    @property
    def throughput(self) -> float:
        """Output units per second when ``output`` is a count."""
        t = self.makespan_s or self.wall_time_s
        if not t or not isinstance(self.output, (int, float)):
            return 0.0
        return self.output / t


@dataclass
class _ChunkWal:
    """Journal accumulator for one fused batch: a fused carrier banks
    the whole chunk's work on slot 0 (slots 1+ return neutral results),
    so per-slot WAL entries would let a crash land between them and
    leave a journal whose partial chunk double-counts on resume.  The
    chunk's folds are therefore journaled as ONE atomic ``folded``
    event, emitted only once every slot has folded — a crash before
    that leaves the whole chunk pending, and re-running it re-derives
    the same results."""

    size: int
    entries: List[dict] = field(default_factory=list)
    #: children produced by already-folded slots, held back until the
    #: chunk's atomic journal event lands: on wall pools a chunk's
    #: slots settle across drain batches, and a child folded (and
    #: journaled) before its parent chunk's event would leave a crash
    #: window whose journal records a fold the replayed seed/split
    #: never produced.  Entries are ``(children, parent_task_id)``.
    deferred: List[Tuple[List[Any], int]] = field(default_factory=list)


@dataclass
class _Dispatch:
    item: Any
    shape: TaskShape
    issued_at: float
    speculated: bool = False
    chunk: Optional[_ChunkWal] = None


def run_irregular(
    pool: Pool,
    spec: WorkSpec,
    *,
    shape: Optional[TaskShape] = None,
    initial_shape: Optional[TaskShape] = None,
    controller: Optional[Any] = None,
    autoscale: Optional[AutoscalePolicy] = None,
    speculative_deadline: Optional[float] = None,
    timeout: Optional[float] = None,
    batching: Optional[bool] = None,
    arrivals: Optional[Iterable[Tuple[float, Any]]] = None,
    shards: Optional[int] = None,
    resume_from: Optional[Any] = None,
    wal: Optional[bool] = None,
    checkpoint_every: Optional[int] = None,
) -> IrregularResult:
    """Drive ``spec`` over ``pool`` to completion.

    shape                 task shape for dispatch (default: spec.shape)
    initial_shape         override for the seed dispatch only (the
                          paper's wide ramp-up split)
    controller            object with ``update(active) -> TaskShape``
                          (``StagedController`` / ``OccupancyController``);
                          called once per completion, like Listing 5
    autoscale             ``AutoscalePolicy`` consulted once per
                          completion: capacity follows the frontier up
                          (queued tasks are demand) and shrinks in the
                          drain phase, applied via ``pool.resize`` and
                          clamped to the provider's scaling ramp when
                          the pool carries a ``ProviderModel`` — the
                          paper's inherent elasticity, made explicit
    speculative_deadline  clone a task that has been *running* longer
                          than this many real seconds onto another
                          worker; first settlement wins, the loser is
                          ignored (meaningful on real-time pools only).
                          On pools with a ``ProviderModel`` the
                          effective deadline additionally includes the
                          expected clone overhead — the full cold-start
                          penalty when no warm container is idle — so
                          speculation only fires when a (likely cold)
                          duplicate can still win
    timeout               overall wall-clock bound -> ``TimeoutError``
    batching              True: drain ready items through
                          ``pool.submit_batch`` in chunks of up to
                          ``pool.idle_capacity()`` items, executed by
                          ``spec.execute_batch`` as one vectorized call
                          on fusing backends (``local``/``sim``) and
                          decomposed per item elsewhere.  Default/False:
                          exact per-task dispatch.  ``tasks`` counts
                          items either way.  Fusing trades parallel
                          slack for invocation cost — the right trade
                          for tiny overhead-dominated tasks (batching's
                          premise), the wrong one when a single item's
                          compute dwarfs the invocation overhead.
                          Items inside a fused call are not
                          individually tracked as RUNNING, so
                          ``speculative_deadline`` does not clone them
                          (the per-item decomposed path still
                          speculates normally; the ``speculative``
                          pool wrapper additionally re-dispatches the
                          *remainder* of a straggling fused batch —
                          see ``repro_torch.runtime.straggler``).
    arrivals              open-loop mode: ``(t, item)`` pairs replacing
                          ``spec.seed`` — each item is dispatched at
                          virtual time ``t`` (the pool is run to that
                          instant first), so idle gaps between arrivals
                          survive on the timeline instead of being
                          compressed into an all-at-once seed.  Requires
                          a virtual-time pool (``run_until``); follow-up
                          items from ``split`` still dispatch at their
                          spawning completion, closed-loop.  This is how
                          serving traces (requests arriving over time)
                          replay exactly.
    shards                partition the frontier across K master shards
                          (each owning a ``ShardView`` slice of the
                          pool's capacity, its own accumulator, and —
                          on a ``ShardedTraceStore`` — its own trace
                          segment) with work-stealing between them and
                          batched completion delivery.  Requires
                          ``spec.merge``; results are bit-identical to
                          ``shards=1`` when the spec's fold is
                          order-insensitive (all three paper workloads
                          are).  Incompatible with ``controller``,
                          ``speculative_deadline`` and ``arrivals``.
    resume_from           a WAL-bearing trace from a killed master (a
                          ``TraceStore``/``EventLog``, spill-file path,
                          or event iterable): the frontier and partial
                          accumulator are reconstructed via
                          ``repro_torch.chaos.recover_frontier`` and the run
                          continues from there — for order-insensitive
                          specs the resumed output is bit-identical to
                          the unkilled run.  Requires the spec's WAL
                          codecs and fixed shapes (no ``controller``);
                          implies ``wal=True`` so the resumed run's
                          trace is itself recoverable.
    wal                   journal one ``folded`` event (encoded item +
                          result) on the pool's timeline per settled
                          item, AFTER the fold and BEFORE its children
                          dispatch — the write-ahead order that makes
                          the trace spill a crash-recovery log.
                          Default: ``True`` iff ``resume_from`` is
                          given.
    checkpoint_every      journal a ``checkpoint`` event (encoded
                          accumulator + pending multiset) every N
                          folds, at instants where no fused chunk is
                          partially folded — recovery then replays only
                          the journal tail past the last checkpoint
                          instead of the whole journal.  Implies
                          ``wal=True``; requires the spec's
                          ``encode_state``/``decode_state``/
                          ``decode_item`` codecs; single-master only
                          (incompatible with ``shards>1`` and
                          ``arrivals=``).

    A spec exposing ``to_workspec()`` (e.g. ``repro.dag.DagSpec``) is
    adapted first — dependency-structured workloads run through the
    very same completion path.
    """
    to_ws = getattr(spec, "to_workspec", None)
    if to_ws is not None:
        spec = to_ws()
    if checkpoint_every is not None:
        if checkpoint_every < 1:
            raise ValueError(
                f"{spec.name}: checkpoint_every must be >= 1")
        if shards is not None and shards > 1:
            raise ValueError(
                f"{spec.name}: checkpoint_every= is single-master "
                f"(incompatible with shards>1)")
        if arrivals is not None:
            raise ValueError(
                f"{spec.name}: checkpoint_every= is incompatible with "
                f"arrivals= (open-loop pending is not checkpointable)")
        if wal is False:
            raise ValueError(
                f"{spec.name}: checkpoint_every= requires wal")
        wal = True
        missing = [n for n in ("encode_state", "decode_state",
                               "decode_item")
                   if getattr(spec, n, None) is None]
        if missing:
            raise ValueError(
                f"{spec.name}: checkpoint_every= needs checkpoint "
                f"codecs on the spec (missing {', '.join(missing)})")
    if shards is not None and shards > 1:
        if controller is not None:
            raise ValueError(
                f"{spec.name}: shards>1 is incompatible with controller= "
                f"(per-completion shape retuning is single-master)")
        if speculative_deadline is not None:
            raise ValueError(
                f"{spec.name}: shards>1 is incompatible with "
                f"speculative_deadline= (gathered waves are not "
                f"individually tracked)")
        if arrivals is not None:
            raise ValueError(
                f"{spec.name}: shards>1 is incompatible with arrivals= "
                f"(open-loop release order is single-master)")
        if spec.merge is None:
            raise ValueError(
                f"{spec.name}: shards>1 requires spec.merge to combine "
                f"per-shard accumulators at join")
        return _run_sharded(pool, spec, shards=shards, shape=shape,
                            initial_shape=initial_shape,
                            autoscale=autoscale, timeout=timeout,
                            batching=batching, resume_from=resume_from,
                            wal=wal)
    t0 = time.monotonic()
    shape = shape or spec.shape
    if batching and spec.execute_batch is None:
        raise ValueError(
            f"{spec.name}: batching=True requires spec.execute_batch")
    batching = bool(batching)
    wal = (resume_from is not None) if wal is None else bool(wal)
    if resume_from is not None and controller is not None:
        raise ValueError(
            f"{spec.name}: resume_from= needs fixed shapes (the WAL "
            f"replays seed/split at known shapes) — controller= is "
            f"incompatible")
    wal_log = _wal_log(pool, spec) if wal else None
    state = spec.init()
    recovered = 0
    cq = CompletionQueue()
    outstanding: Dict[ElasticFuture, _Dispatch] = {}
    n_dispatched = 0

    def dispatch(item: Any, shp: TaskShape,
                 parent: Optional[int] = None) -> None:
        nonlocal n_dispatched
        f = pool.submit(spec.execute, item, shp,
                        cost_hint=spec.cost_hint(item), parent=parent)
        outstanding[f] = _Dispatch(item, shp, time.monotonic())
        cq.add(f)
        n_dispatched += 1

    def dispatch_ready(items: List[Any], shp: TaskShape,
                       parent: Optional[int] = None) -> None:
        """Issue a wave of ready items: fused through ``submit_batch``
        in idle-capacity-bounded chunks when batching, per item
        otherwise (small tiny-task dispatches are the per-invocation
        overhead the fusion exists to amortize).  ``parent`` is the
        spawning completion's task id (``PARENT_ROOT`` for seeds),
        stamped on the submit events so replays recover the dispatch
        DAG exactly."""
        nonlocal n_dispatched
        if not batching or len(items) <= 1:
            for item in items:
                dispatch(item, shp, parent)
            return
        # fusing pools (local/sim) expose max_concurrency; decomposing
        # pools ignore the chunking, so the fallback width is moot there
        width = max(1, getattr(pool, "max_concurrency", 1))
        i = 0
        while i < len(items):
            # up to idle_capacity items per fused call (pool width once
            # saturated, so chunks stay bounded and freed workers always
            # find fusable units rather than one serialized mega-call).
            # Fusing a whole wave into one slot deliberately trades
            # parallel slack for invocation cost: with tiny tasks —
            # batching's premise — overhead dominates, so one fused
            # call matches the wall time of k parallel dispatches at
            # 1/k the invocations (see fig_batch_fusion).
            cap = pool.idle_capacity() or width
            chunk = items[i:i + cap]
            i += len(chunk)
            futures = pool.submit_batch(
                lambda batch, _s=shp: spec.execute_batch(batch, _s),
                chunk,
                item_fn=lambda item, _s=shp: spec.execute(item, _s),
                cost_hints=[spec.cost_hint(item) for item in chunk],
                parent=parent)
            now = time.monotonic()
            chunk_wal = (_ChunkWal(len(chunk)) if wal_log is not None
                         and len(chunk) > 1 else None)
            for f, item in zip(futures, chunk):
                outstanding[f] = _Dispatch(item, shp, now,
                                           chunk=chunk_wal)
                cq.add(f)
                n_dispatched += 1

    # per-run windows (captured before the seed dispatch lands): a
    # long-lived pool's log (and a sim pool's clock) may carry earlier
    # runs — composite pools rebuild their merged log per access, so
    # re-fetch pool.events at each use
    has_events = getattr(pool, "events", None) is not None
    events_start = len(pool.events) if has_events else 0
    # hoisted once: composite pools rebuild their merged log on every
    # .events access, but the underlying clock identity is stable
    pool_clock = pool.events.clock if has_events else None
    vt0 = getattr(pool, "virtual_time_s", None) or 0.0
    ramp_t0: List[float] = []  # first-event timestamp, cached once

    # master.* spans: seed; at each completion the wait, then fold with
    # split and dispatch inside it; close
    t_seed = time.monotonic() if telemetry.SPANS_ON else None
    pending_arrivals: Optional[deque] = None
    if arrivals is not None:
        run_until = getattr(pool, "run_until", None)
        if run_until is None:
            raise ValueError(
                f"{spec.name}: arrivals= needs a virtual-time pool "
                f"exposing run_until (got {type(pool).__name__})")
        pending_arrivals = deque(sorted(arrivals, key=lambda a: a[0]))
        if resume_from is not None:
            raise ValueError(
                f"{spec.name}: resume_from= is incompatible with "
                f"arrivals= (open-loop release times are not "
                f"journaled)")
    elif resume_from is not None:
        from ..chaos.recovery import recover_frontier
        rec = recover_frontier(resume_from, spec, shape=shape,
                               initial_shape=initial_shape)
        state = rec.partial
        recovered = len(rec.pending)
        # recovered items dispatch at the steady shape: the paper
        # specs' outputs are granularity-insensitive, the same
        # property shards=K bit-identity rests on
        dispatch_ready(list(rec.pending), shape, parent=PARENT_ROOT)
    else:
        dispatch_ready(list(spec.seed(initial_shape or shape)),
                       initial_shape or shape, parent=PARENT_ROOT)
    if t_seed is not None and arrivals is None:
        telemetry.add_span("master.seed", t_seed, time.monotonic())

    deadline = None if timeout is None else t0 + timeout
    speculated = 0
    folds_since = 0  # journaled folds since the last checkpoint

    def apply_autoscale() -> None:
        """Frontier-pressure grow / idle shrink, honoring the ramp."""
        cap = pool.capacity
        # the policy's cooldowns run on the pool's clock (virtual on
        # sim pools), so hysteresis windows are in billed time
        now = (pool_clock.now() if pool_clock is not None
               else time.monotonic())
        target = autoscale.decide(pending=pool.pending(),
                                  idle=pool.idle_capacity(),
                                  capacity=cap, now=now)
        provider = getattr(pool, "provider", None)
        if provider is not None and target > cap and has_events:
            if not ramp_t0:
                t_first, _ = pool.events.span()
                ramp_t0.append(t_first)
            elapsed = max(0.0, pool_clock.now() - ramp_t0[0])
            granted = provider.allowed_concurrency(elapsed)
            target = max(cap, min(target, granted))
        if target != cap:
            pool.resize(target)
            autoscale.resize_log.append((cap, target))

    def clone_margin() -> float:
        # provider-aware speculation (ROADMAP): a clone on a pool with
        # no warm container idle lands cold — only call a task a
        # straggler once a cold duplicate could still beat it.  The
        # fleet is asked in the POOL's time domain (virtual fleets hold
        # virtual release timestamps; a wall timestamp would make every
        # container look expired).
        provider = getattr(pool, "provider", None)
        if provider is None:
            return 0.0
        fleet = getattr(pool, "_fleet", None)
        if fleet is None:
            warm = 0
        else:
            pool_clock = getattr(pool, "clock", None)
            fleet_now = (pool_clock.now() if pool_clock is not None
                         else time.monotonic())
            warm = fleet.warm_count(fleet_now)
        return provider.expected_clone_overhead(warm_available=warm > 0)

    def scan_stragglers() -> None:
        # A straggler is a task *running* past the deadline — queued
        # tasks are excluded (cloning them would just lengthen the same
        # queue).  One clone per dispatch, first settlement wins.
        nonlocal speculated
        now = time.monotonic()
        deadline_eff = speculative_deadline + clone_margin()
        for fut, d in list(outstanding.items()):
            if d.speculated or fut.state is not TaskState.RUNNING:
                continue
            started = fut._task.start_time
            if started is not None and now - started > deadline_eff:
                d.speculated = True
                speculated += 1
                _speculate(pool, spec, fut, d)

    observe_completion = (getattr(autoscale, "observe_completion", None)
                          if autoscale is not None else None)

    def split(result: Any, task_id: int, on: bool) -> List[Any]:
        t_split = time.monotonic() if on else 0.0
        kids = list(spec.split(result, shape))
        if on:
            telemetry.add_span("master.split", t_split, time.monotonic(),
                               task_id)
        return kids

    while outstanding or pending_arrivals:
        if pending_arrivals:
            # release every arrival due before the next completion, at
            # its exact virtual time; completions due first are pumped
            # first (below) so children still dispatch at their
            # spawning completion's instant
            t_arr = pending_arrivals[0][0]
            nxt = (pool.next_event_t()
                   if hasattr(pool, "next_event_t") else None)
            if not outstanding or nxt is None or t_arr <= nxt:
                pool.run_until(t_arr)
                while pending_arrivals and pending_arrivals[0][0] <= t_arr:
                    _, item = pending_arrivals.popleft()
                    dispatch(item, shape, PARENT_ROOT)
                if autoscale is not None:
                    apply_autoscale()
                continue
        remaining = None if deadline is None else deadline - time.monotonic()
        if remaining is not None and remaining <= 0:
            raise TimeoutError(
                f"{spec.name}: {len(outstanding)} tasks still "
                f"outstanding after {timeout}s")
        wait = remaining
        if speculative_deadline is not None:
            # wake often enough to notice stragglers even when idle
            slice_s = max(speculative_deadline / 4, 1e-3)
            wait = slice_s if wait is None else min(wait, slice_s)
        t_wait = time.monotonic() if telemetry.SPANS_ON else None
        try:
            # batched completion delivery: pop everything ready under
            # one lock acquisition (CompletionQueue.drain) instead of
            # re-acquiring per completion.  Open-loop arrivals keep
            # max_items=1 so arrival releases interleave with
            # completions at exactly the recorded instants.
            batch = cq.drain(
                max_items=1 if pending_arrivals is not None else None,
                timeout=wait)
        except TimeoutError:
            if t_wait is not None:
                telemetry.add_span("master.wait", t_wait, time.monotonic())
            if speculative_deadline is not None:
                scan_stragglers()
            continue
        if t_wait is not None:
            telemetry.add_span("master.wait", t_wait, time.monotonic())
        if speculative_deadline is not None:
            # a busy completion stream must not mask stragglers: check
            # deadlines on the completion path too, not only when idle
            scan_stragglers()
        for f in batch:
            spans_on = telemetry.SPANS_ON
            t_fold = time.monotonic() if spans_on else 0.0
            d = outstanding.pop(f)
            result = f.result()
            state = spec.reduce(state, result)
            if controller is not None:
                shape = controller.update(len(outstanding))
            # child waves to issue once WAL order allows: (kids, parent)
            ready: List[Tuple[List[Any], int]] = []
            if wal_log is not None:
                # WAL order: journal AFTER the fold applies and BEFORE
                # any child dispatch — recovery replays exactly the
                # folds that happened and re-derives everything else.
                # Fused-batch slots accumulate into one atomic entry
                # (see _ChunkWal), and their children are deferred with
                # it: on wall pools a chunk's slots settle across drain
                # batches, and a child folded before its parent chunk's
                # event would leave a crash window whose journal
                # records folds the replayed seed/split never produced.
                entry = {"item": spec.encode_item(d.item),
                         "result": spec.encode_result(result)}
                if d.chunk is None:
                    wal_log.emit(FOLDED, task_id=f._task.task_id,
                                 payload=entry)
                    folds_since += 1
                    ready.append((split(result, f._task.task_id, spans_on),
                                  f._task.task_id))
                else:
                    d.chunk.entries.append(entry)
                    d.chunk.deferred.append(
                        (split(result, f._task.task_id, spans_on),
                         f._task.task_id))
                    if len(d.chunk.entries) == d.chunk.size:
                        wal_log.emit(FOLDED, task_id=f._task.task_id,
                                     payload={"batch": d.chunk.entries})
                        folds_since += d.chunk.size
                        ready.extend(d.chunk.deferred)
            else:
                ready.append((split(result, f._task.task_id, spans_on),
                              f._task.task_id))
            t_dispatch = time.monotonic() if spans_on else 0.0
            for kids, pid in ready:
                dispatch_ready(kids, shape, parent=pid)
            if spans_on:
                telemetry.add_span("master.dispatch", t_dispatch,
                                   time.monotonic(), f._task.task_id)
            if (checkpoint_every is not None
                    and folds_since >= checkpoint_every
                    and not any(dd.chunk is not None and dd.chunk.entries
                                for dd in outstanding.values())):
                # a consistent cut: the accumulator holds exactly the
                # journaled folds (no partially folded chunk is
                # outstanding) and ``pending`` is the full multiset of
                # known-but-unfolded items
                wal_log.emit(
                    CHECKPOINT,
                    payload={
                        "state": spec.encode_state(state),
                        "pending": [spec.encode_item(dd.item)
                                    for dd in outstanding.values()]})
                folds_since = 0
            if observe_completion is not None:
                # latency-targeting policies (SLO autoscale) consume
                # each completion's queue delay — this is what lets a
                # recorded serving policy be re-tuned offline through
                # trace replay
                t = f._task
                observe_completion(
                    queue_delay_s=max(0.0, (t.start_time or 0.0)
                                      - (t.submit_time or 0.0)),
                    duration_s=max(0.0, (t.end_time or 0.0)
                                   - (t.start_time or 0.0)),
                    now=(pool_clock.now() if pool_clock is not None
                         else time.monotonic()))
            if autoscale is not None:
                apply_autoscale()
            if spans_on:
                telemetry.add_span("master.fold", t_fold, time.monotonic(),
                                   f._task.task_id)

    t_close = time.monotonic() if telemetry.SPANS_ON else None
    snap = pool.snapshot()
    wall = time.monotonic() - t0
    # sim pools bill/plot in virtual time (elapsed this run); real
    # pools in wall time
    vt = getattr(pool, "virtual_time_s", None)
    makespan = (vt - vt0) if vt is not None else wall
    cost = None
    cold_starts = snap.get("cold_starts", 0)
    retries = worker_deaths = 0
    concurrency_series: List[tuple] = []
    capacity_series: List[tuple] = []
    if has_events:
        # this run's events: when nothing but capacity announcements
        # precede the run (every fresh pool emits one at construction),
        # the window IS the log — spill-backed stores then serve the
        # series from their incremental analytics in O(answer) instead
        # of re-streaming a tail view per read
        log = pool.events
        window = (log if _prefix_is_capacity_only(log, events_start)
                  else log.tail(events_start))
        cost = serverless_cost(window, wall_time_s=makespan,
                               provider=getattr(pool, "provider", None))
        concurrency_series = window.concurrency_series()
        capacity_series = window.capacity_series()
        cold_starts = window.cold_starts()
        ev_counts = window.counts()
        retries = ev_counts.get(REQUEUE, 0)
        worker_deaths = ev_counts.get(WORKER_KILLED, 0)
    dag = getattr(spec, "dag", None)
    out = IrregularResult(
        output=spec.finalize(state),
        wall_time_s=wall,
        tasks=n_dispatched,
        peak_concurrency=snap.get("peak_concurrency", 0),
        controller_transitions=list(getattr(controller, "transitions", [])),
        speculated=speculated,
        pool_snapshot=snap,
        makespan_s=makespan,
        cost=cost,
        concurrency_series=concurrency_series,
        capacity_series=capacity_series,
        cold_starts=cold_starts,
        autoscale_decisions=(list(autoscale.resize_log)
                             if autoscale is not None else []),
        retries=retries,
        worker_deaths=worker_deaths,
        recovered_tasks=recovered,
        critical_path_len=dag.critical_path_len if dag is not None else 0,
        stage_widths=list(dag.stage_widths) if dag is not None else [],
        dag_nodes=dag.executed if dag is not None else 0,
    )
    if t_close is not None:
        telemetry.add_span("master.close", t_close, time.monotonic())
    return out


def _steal_half(frontiers: List[deque], thief: int) -> Optional[int]:
    """Work-stealing transfer: move half of the largest backlog onto
    the ``thief`` shard's drained frontier.

    Victim = the shard with the most queued items (ties broken toward
    the lowest index, deterministically); no steal when every other
    frontier holds fewer than 2 items.  The OLDEST half migrates
    (popped from the victim's front, appended in order), so both
    queues keep their FIFO discipline.  Returns the victim index, or
    ``None`` when there was nothing worth stealing.
    """
    candidates = [v for v in range(len(frontiers))
                  if v != thief and len(frontiers[v]) >= 2]
    if not candidates:
        return None
    victim = max(candidates, key=lambda v: (len(frontiers[v]), -v))
    thief_q, victim_q = frontiers[thief], frontiers[victim]
    for _ in range(len(victim_q) // 2):
        thief_q.append(victim_q.popleft())
    return victim


def _tree_merge(states: List[Any],
                merge: Callable[[Any, Any], Any]) -> Any:
    """Pairwise tree-combine of per-shard accumulators in shard-index
    order — ((s0·s1)·(s2·s3))··· — O(log K) merge depth with a
    grouping that is deterministic for every K."""
    while len(states) > 1:
        nxt = [merge(states[i], states[i + 1])
               for i in range(0, len(states) - 1, 2)]
        if len(states) % 2:
            nxt.append(states[-1])
        states = nxt
    return states[0]


def _wal_log(pool: Pool, spec: WorkSpec):
    """The log WAL ``folded`` events journal to: the pool's own
    single-writer log (a spill-backed ``TraceStore`` persists them; a
    plain ``EventLog`` keeps them queryable in memory).  Validates the
    spec's WAL codecs up front."""
    if spec.encode_item is None or spec.encode_result is None:
        raise ValueError(
            f"{spec.name}: wal=True requires encode_item/encode_result "
            f"codecs on the spec")
    log = getattr(getattr(pool, "stats", None), "log", None)
    if log is None:
        log = getattr(pool, "events", None)
    if log is None:
        raise ValueError(
            f"{spec.name}: wal=True needs a pool with an event log")
    return log


def _run_sharded(
    pool: Pool,
    spec: WorkSpec,
    *,
    shards: int,
    shape: Optional[TaskShape],
    initial_shape: Optional[TaskShape],
    autoscale: Optional[AutoscalePolicy],
    timeout: Optional[float],
    batching: Optional[bool],
    resume_from: Optional[Any] = None,
    wal: Optional[bool] = None,
) -> IrregularResult:
    """K-master sharded drive behind ``run_irregular(shards=K)``.

    The frontier is partitioned across K shards (seeds round-robin);
    each shard owns a :class:`~repro_torch.core.pool.ShardView` slice of the
    ONE pool's capacity, folds completions into its own accumulator
    with ``spec.reduce``, and queues ``spec.split`` children locally.
    A shard whose frontier drains while it still has free slots steals
    half the largest backlog (:func:`_steal_half`).  Dispatch is
    wave-oriented: with ``batching=True`` a shard's backlog is spread
    over its free slots as ``submit_gather`` waves — ONE carrier task,
    ONE completion record, ONE master wakeup per wave — and all shards
    share one :class:`CompletionQueue` drained in batches, so the
    per-item master cost is the amortized sliver that makes
    million-task frontiers driver-feasible.  At join the K accumulators
    tree-merge (``spec.merge``) and ``spec.finalize`` runs once.
    """
    t0 = time.monotonic()
    shape = shape or spec.shape
    if batching and spec.execute_batch is None:
        raise ValueError(
            f"{spec.name}: batching=True requires spec.execute_batch")
    batching = bool(batching)
    wal = (resume_from is not None) if wal is None else bool(wal)
    wal_log = _wal_log(pool, spec) if wal else None
    K = shards
    views = pool.shard_views(K)
    # frontier entries: (item, shape, parent_task_id)
    frontiers: List[deque] = [deque() for _ in range(K)]
    states: List[Any] = [spec.init() for _ in range(K)]
    recovered_partial = None
    recovered = 0
    cq = CompletionQueue()
    # future -> (shard, slots_held, is_gather, items)
    owner: Dict[ElasticFuture, Tuple[int, int, bool, List[Any]]] = {}
    inflight = [0] * K
    n_dispatched = 0
    steals = 0
    # chaos hook (kill_master_after kill_on_steal=): die on the N-th
    # successful steal instead of in fold order
    kill_on_steal: Optional[int] = getattr(
        spec.reduce, "_repro_kill_on_steal", None)

    seed_shape = initial_shape or shape
    if resume_from is not None:
        from ..chaos.recovery import recover_frontier
        rec = recover_frontier(resume_from, spec, shape=shape,
                               initial_shape=initial_shape)
        # the journal's partial joins as one extra accumulator at the
        # tree-merge; pending items round-robin like a fresh seed
        recovered_partial = rec.partial
        recovered = len(rec.pending)
        for i, item in enumerate(rec.pending):
            frontiers[i % K].append((item, shape, PARENT_ROOT))
    else:
        for i, item in enumerate(spec.seed(seed_shape)):
            frontiers[i % K].append((item, seed_shape, PARENT_ROOT))

    # per-run windows — same capture as the single-master path
    has_events = getattr(pool, "events", None) is not None
    events_start = len(pool.events) if has_events else 0
    pool_clock = pool.events.clock if has_events else None
    vt0 = getattr(pool, "virtual_time_s", None) or 0.0
    ramp_t0: List[float] = []
    deadline = None if timeout is None else t0 + timeout

    def apply_autoscale() -> None:
        # identical to the single-master policy hook: ONE pool, ONE
        # provider ramp — the shard views just re-slice whatever the
        # policy is granted
        cap = pool.capacity
        now = (pool_clock.now() if pool_clock is not None
               else time.monotonic())
        target = autoscale.decide(pending=pool.pending(),
                                  idle=pool.idle_capacity(),
                                  capacity=cap, now=now)
        provider = getattr(pool, "provider", None)
        if provider is not None and target > cap and has_events:
            if not ramp_t0:
                t_first, _ = pool.events.span()
                ramp_t0.append(t_first)
            elapsed = max(0.0, pool_clock.now() - ramp_t0[0])
            granted = provider.allowed_concurrency(elapsed)
            target = max(cap, min(target, granted))
        if target != cap:
            pool.resize(target)
            autoscale.resize_log.append((cap, target))

    def fill(s: int) -> None:
        """Dispatch shard ``s``'s ready items into its free slots."""
        nonlocal n_dispatched
        fr = frontiers[s]
        view = views[s]
        while fr:
            free = view.slots - inflight[s]
            if free <= 0:
                return
            if batching and len(fr) > 1:
                # spread the backlog over the free slots —
                # ceil(len/free) items per gathered wave — taking only
                # a same-shape run (seed waves may carry the wide
                # initial_shape while split children carry the steady
                # shape)
                k = min(len(fr), -(-len(fr) // free))
                shp = fr[0][1]
                chunk = [fr.popleft()]
                while fr and len(chunk) < k and fr[0][1] is shp:
                    chunk.append(fr.popleft())
                if len(chunk) > 1:
                    items = [c[0] for c in chunk]
                    parents = {c[2] for c in chunk}
                    f = view.submit_gather(
                        lambda batch, _s=shp: spec.execute_batch(
                            batch, _s),
                        items,
                        item_fn=lambda item, _s=shp: spec.execute(
                            item, _s),
                        cost_hints=[spec.cost_hint(it) for it in items],
                        parent=(parents.pop() if len(parents) == 1
                                else None))
                    # a fused carrier holds one worker slot; decomposed
                    # waves hold one per item
                    held = (1 if pool.supports_batching
                            else len(items))
                    owner[f] = (s, held, True, items)
                    inflight[s] += held
                    cq.add(f)
                    n_dispatched += len(items)
                    continue
                item, shp, parent = chunk[0]
            else:
                item, shp, parent = fr.popleft()
            f = view.submit(spec.execute, item, shp,
                            cost_hint=spec.cost_hint(item),
                            parent=parent)
            owner[f] = (s, 1, False, [item])
            inflight[s] += 1
            cq.add(f)
            n_dispatched += 1

    def settle(f: ElasticFuture) -> None:
        s, held, is_gather, its = owner.pop(f)
        inflight[s] -= held
        results = f.result() if is_gather else [f.result()]
        parent_id = f._task.task_id
        st = states[s]
        fr = frontiers[s]
        children: List[Any] = []
        entries: List[dict] = []
        for item, r in zip(its, results):
            st = spec.reduce(st, r)
            if wal_log is not None:
                entries.append({"item": spec.encode_item(item),
                                "result": spec.encode_result(r)})
            children.extend(spec.split(r, shape))
        if entries:
            # the gather journals atomically (fused carriers bank the
            # whole wave's work on slot 0 — see _ChunkWal) and BEFORE
            # its children queue, preserving the WAL order
            payload = (entries[0] if len(entries) == 1
                       else {"batch": entries})
            wal_log.emit(FOLDED, task_id=parent_id, payload=payload)
        for child in children:
            fr.append((child, shape, parent_id))
        states[s] = st

    while True:
        for s in range(K):
            fill(s)
        # steal pass: a drained shard with free slots takes half of
        # the largest backlog, then dispatches it immediately
        for s in range(K):
            if not frontiers[s] and inflight[s] < views[s].slots:
                if _steal_half(frontiers, s) is not None:
                    steals += 1
                    if kill_on_steal is not None and steals >= kill_on_steal:
                        # chaos injection (kill_master_after
                        # kill_on_steal=): die mid-steal, after the
                        # transfer but before the stolen items
                        # dispatch — steals move items between
                        # in-memory frontiers only, so the WAL left
                        # behind is exactly a real crash's
                        from ..chaos.recovery import MasterKilledError
                        raise MasterKilledError(
                            f"{spec.name}: injected master kill on "
                            f"steal #{steals}")
                    fill(s)
        if not owner:
            if any(frontiers):  # pragma: no cover — slots >= 1 always
                raise RuntimeError(
                    f"{spec.name}: sharded driver stalled with "
                    f"{sum(map(len, frontiers))} queued items")
            break
        remaining = (None if deadline is None
                     else deadline - time.monotonic())
        if remaining is not None and remaining <= 0:
            raise TimeoutError(
                f"{spec.name}: {len(owner)} dispatches still "
                f"outstanding after {timeout}s")
        for f in cq.drain(timeout=remaining):
            settle(f)
        if autoscale is not None:
            # once per drained batch: capacity follows the merged
            # frontier, amortized like the completions themselves
            apply_autoscale()

    snap = pool.snapshot()
    wall = time.monotonic() - t0
    vt = getattr(pool, "virtual_time_s", None)
    makespan = (vt - vt0) if vt is not None else wall
    cost = None
    cold_starts = snap.get("cold_starts", 0)
    concurrency_series: List[tuple] = []
    capacity_series: List[tuple] = []
    retries = worker_deaths = 0
    if has_events:
        log = pool.events
        window = (log if _prefix_is_capacity_only(log, events_start)
                  else log.tail(events_start))
        cost = serverless_cost(window, wall_time_s=makespan,
                               provider=getattr(pool, "provider", None))
        concurrency_series = window.concurrency_series()
        capacity_series = window.capacity_series()
        cold_starts = window.cold_starts()
        ev_counts = window.counts()
        retries = ev_counts.get(REQUEUE, 0)
        worker_deaths = ev_counts.get(WORKER_KILLED, 0)
    dag = getattr(spec, "dag", None)
    merged = _tree_merge(list(states), spec.merge)
    if recovered_partial is not None:
        # the pre-crash journal joins as one extra shard accumulator
        merged = spec.merge(recovered_partial, merged)
    return IrregularResult(
        output=spec.finalize(merged),
        wall_time_s=wall,
        tasks=n_dispatched,
        peak_concurrency=snap.get("peak_concurrency", 0),
        speculated=0,
        pool_snapshot=snap,
        makespan_s=makespan,
        cost=cost,
        concurrency_series=concurrency_series,
        capacity_series=capacity_series,
        cold_starts=cold_starts,
        autoscale_decisions=(list(autoscale.resize_log)
                             if autoscale is not None else []),
        shards=K,
        steals=steals,
        retries=retries,
        worker_deaths=worker_deaths,
        recovered_tasks=recovered,
        critical_path_len=dag.critical_path_len if dag is not None else 0,
        stage_widths=list(dag.stage_widths) if dag is not None else [],
        dag_nodes=dag.executed if dag is not None else 0,
    )


def _prefix_is_capacity_only(log: Any, start: int) -> bool:
    """True when events ``[0, start)`` are all capacity announcements —
    then the full log and the ``tail(start)`` window describe the same
    run (capacity series additionally carries the initial width, which
    is the staircase's true first step)."""
    if start <= 0:
        return True
    from .telemetry import CAPACITY_GROW, CAPACITY_SHRINK
    it = getattr(log, "iter_events", None)
    events = it() if it is not None else iter(log.events())
    for i, e in enumerate(events):
        if i >= start:
            break
        if e.kind not in (CAPACITY_GROW, CAPACITY_SHRINK):
            return False
    return True


def _speculate(pool: Pool, spec: WorkSpec, target: ElasticFuture,
               d: _Dispatch) -> None:
    """Clone a straggling dispatch onto another worker.  The clone
    resolves the *original* future; ``ElasticFuture`` keeps the first
    completion and drops the rest (paper §3.3: stateless ⇒ duplication
    is coordination-free)."""
    def clone() -> Any:
        result = spec.execute(d.item, d.shape)
        target._set_result(result)  # no-op if the original won
        return result

    try:
        pool.submit(clone, cost_hint=spec.cost_hint(d.item))
    except RuntimeError:
        pass  # pool already shutting down
