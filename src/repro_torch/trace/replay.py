"""Trace replay — what-if re-execution of a recorded run.

Malawski & Balis (PAPERS.md) argue serverless schedulers should be
tuned by *simulation from recorded traces* rather than paid cloud
reruns.  This module is that loop for our pools: a recorded timeline is
reconstructed into its task-arrival/duration structure and re-executed
on the virtual-time :class:`~repro_torch.core.simpool.SimPool` under a
**different** :class:`~repro_torch.core.provider.ProviderModel` or
:class:`~repro_torch.core.provider.AutoscalePolicy` — "the same UTS run on a
GCF-like ramp", "the same run with EWMA autoscaling" — without
re-running the algorithm.

Reconstruction prefers the **explicit parent ids** submit events carry
since the traffic subsystem (``Event.parent``: the spawning
completion's task id, ``PARENT_ROOT`` for seeds/arrivals) — exact on
wall-clock and virtual traces alike.  Recordings that predate parent
tracking fall back to the master-loop heuristic: follow-up tasks are
submitted *immediately after* the completion that spawned them, so on
the timeline every ``submit`` between completion *k* and completion
*k+1* is a child of *k*'s task, and seeds are the submits before the
first completion — exact on virtual-time traces, up to
thread-interleaving jitter on wall-clock ones.  Root submit *times*
are kept as arrival offsets: an open-loop recording (serving requests
arriving over time) replays through ``run_irregular(arrivals=...)``,
reproducing the idle gaps instead of compressing all roots into one
seed wave.  Task *body* durations
are the recorded durations minus the recording provider's cold/warm
overhead, so replay under a new provider re-applies the new platform's
overheads to clean bodies — replaying under the *same* provider **and
the same pool configuration** (width, autoscale policy) reproduces
makespan and cost (within tolerance; parity is under test).  The pool
configuration is part of the scenario: a recording made under
autoscale replayed at fixed width is a what-if, not a reproduction.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Union

from ..core.irregular import IrregularResult, WorkSpec, run_irregular
from ..core.provider import AutoscalePolicy, ProviderModel
from ..core.simpool import SimPool
from ..core.telemetry import (CANCEL, COLD_START, COMPLETE, PARENT_ROOT,
                              SUBMIT, Event, EventLog)
from .store import iter_trace_events

__all__ = ["ReplayTask", "ReplayWorkload", "extract_workload",
           "replay_spec", "replay", "what_if"]


@dataclass
class ReplayTask:
    """One recorded dispatch: its modelled body time and its children
    (the tasks its completion spawned)."""

    task_id: int
    body_s: float
    cost_hint: float = 1.0
    cold: bool = False
    attempts: int = 1
    children: List["ReplayTask"] = field(default_factory=list)
    #: recorded submit offset from trace start (roots only; open-loop
    #: replay re-arrives each root at this virtual time)
    arrival_s: float = 0.0


@dataclass
class ReplayWorkload:
    """A trace reduced to its replayable structure."""

    roots: List[ReplayTask]
    n_tasks: int
    total_body_s: float
    recorded_makespan_s: float
    recorded_cold_starts: int = 0
    #: True when the submit events carried explicit parent ids (exact
    #: DAG recovery, no heuristic)
    has_parents: bool = False
    #: tasks the recording explicitly cancelled (fail-fast ``Pool.map``
    #: / ``submit_gather`` remainders) — deliberately not replayed, and
    #: distinct from ``n_lost``
    n_cancelled: int = 0
    #: tasks submitted but neither completed nor cancelled (in flight
    #: at capture / crash): the genuinely truncated tail
    n_lost: int = 0

    @property
    def open_loop(self) -> bool:
        """Roots arrived over time (a serving trace): replay honours
        their recorded arrival offsets.  Batch recordings seed every
        root at t~0, so this stays False and replay is closed-loop."""
        return self.has_parents and any(r.arrival_s > 1e-9
                                        for r in self.roots)

    def all_tasks(self) -> Iterable[ReplayTask]:
        stack = list(self.roots)
        while stack:
            t = stack.pop()
            yield t
            stack.extend(t.children)


def extract_workload(trace: Union[EventLog, Iterable[Event]], *,
                     provider: Optional[ProviderModel] = None,
                     overhead_s: float = 0.0) -> ReplayWorkload:
    """Single pass over a timeline -> :class:`ReplayWorkload`.

    ``provider`` is the model the run was *recorded* under; when given,
    its cold/warm overhead is subtracted from each task's recorded
    duration so replay re-applies the replay provider's overheads to
    pure body time.  For provider-less recordings (a flat
    ``invoke_overhead`` pool), pass that flat value as ``overhead_s``
    instead.  Tasks that never completed are dropped from the replay
    tree (no completion to anchor children to) but NOT conflated: ones
    the recording *cancelled* (typed ``cancel`` events from fail-fast
    ``Pool.map`` / ``submit_gather``) are counted as ``n_cancelled`` —
    an intentional outcome a faithful replay also skips — while the
    remainder (in flight at capture or crash) are ``n_lost``.
    """
    nodes: Dict[int, ReplayTask] = {}
    children_of: Dict[Optional[int], List[int]] = {None: []}
    cold_ids = set()
    cancelled_ids = set()
    submit_at: Dict[int, float] = {}
    has_parents = False
    last_completed: Optional[int] = None
    t_first: Optional[float] = None
    t_last = 0.0
    for ev in iter_trace_events(trace):
        if t_first is None:
            t_first = ev.t
        t_last = ev.t
        if ev.kind == SUBMIT and ev.task_id is not None:
            # explicit parent when recorded (exact DAG); the
            # last-completed heuristic only for legacy events
            if ev.parent is not None:
                has_parents = True
                key = None if ev.parent == PARENT_ROOT else ev.parent
            else:
                key = last_completed
            children_of.setdefault(key, []).append(ev.task_id)
            submit_at[ev.task_id] = ev.t
        elif ev.kind == COLD_START and ev.task_id is not None:
            cold_ids.add(ev.task_id)
        elif ev.kind == CANCEL and ev.task_id is not None:
            cancelled_ids.add(ev.task_id)
        elif ev.kind == COMPLETE and ev.record is not None:
            r = ev.record
            cold = r.task_id in cold_ids
            body = r.duration
            body -= (provider.overhead_s(cold) if provider is not None
                     else overhead_s)
            nodes[r.task_id] = ReplayTask(
                task_id=r.task_id, body_s=max(0.0, body),
                cost_hint=r.cost_hint, cold=cold, attempts=r.attempts)
            last_completed = r.task_id

    def resolve(parent_key: Optional[int]) -> List[ReplayTask]:
        out = []
        for tid in children_of.get(parent_key, ()):
            node = nodes.get(tid)
            if node is not None:
                out.append(node)
        return out

    for tid, node in nodes.items():
        node.children = resolve(tid)
    roots = resolve(None)
    t0 = t_first if t_first is not None else 0.0
    for r in roots:
        r.arrival_s = max(0.0, submit_at.get(r.task_id, t0) - t0)
    return ReplayWorkload(
        roots=roots,
        n_tasks=len(nodes),
        total_body_s=sum(n.body_s for n in nodes.values()),
        recorded_makespan_s=(t_last - t_first) if t_first is not None
        else 0.0,
        recorded_cold_starts=len(cold_ids),
        has_parents=has_parents,
        n_cancelled=len(cancelled_ids),
        n_lost=max(0, len(submit_at) - len(nodes) - len(cancelled_ids)),
    )


def replay_spec(workload: ReplayWorkload) -> WorkSpec:
    """The workload as a ``WorkSpec``: items are :class:`ReplayTask`
    nodes, ``split`` walks the recorded spawn tree, and the accumulator
    sums replayed body seconds (the total modelled work)."""
    return WorkSpec(
        name="trace-replay",
        execute=lambda item, shape: item,
        seed=lambda shape: list(workload.roots),
        split=lambda result, shape: list(result.children),
        reduce=lambda state, result: state + result.body_s,
        init=lambda: 0.0,
        cost_hint=lambda item: item.cost_hint,
    )


def replay(
    source: Union[ReplayWorkload, EventLog, Iterable[Event]],
    *,
    provider: Optional[ProviderModel] = None,
    recorded_provider: Optional[ProviderModel] = None,
    max_concurrency: int = 2000,
    autoscale: Optional[AutoscalePolicy] = None,
    invoke_overhead: float = 0.0,
    trace: Optional[EventLog] = None,
    honor_arrivals: Optional[bool] = None,
) -> IrregularResult:
    """Re-execute a recorded workload on ``SimPool`` under ``provider``
    / ``autoscale`` — the what-if knobs.  ``source`` is a workload from
    :func:`extract_workload` or a raw trace (then ``recorded_provider``
    is the model it was recorded under, for overhead subtraction).
    Without a ``provider`` the replay pool charges ``invoke_overhead``
    per task — default 0, NOT SimPool's usual 13 ms, because
    provider-less recordings carry their flat overhead inside the
    recorded durations already (subtract it at extraction via
    ``extract_workload(overhead_s=...)`` if you want to re-model it
    here).  ``trace`` optionally records the replay itself
    (store-to-store what-if chains).  ``honor_arrivals`` controls
    open-loop replay: by default a serving trace (``wl.open_loop``)
    re-arrives each root at its recorded offset so idle gaps survive,
    while batch traces seed all roots at t=0 exactly as before; pass an
    explicit bool to force either mode."""
    if isinstance(source, ReplayWorkload):
        wl = source
    else:
        wl = extract_workload(source, provider=recorded_provider)
    if honor_arrivals is None:
        honor_arrivals = wl.open_loop
    pool = SimPool(max_concurrency=max_concurrency, provider=provider,
                   invoke_overhead=invoke_overhead,
                   duration_fn=lambda task, rt: rt.body_s,
                   trace=trace, name="replay-pool")
    try:
        if honor_arrivals:
            return run_irregular(
                pool, replay_spec(wl), autoscale=autoscale,
                arrivals=[(r.arrival_s, r) for r in wl.roots])
        return run_irregular(pool, replay_spec(wl), autoscale=autoscale)
    finally:
        pool.shutdown()


def what_if(
    source: Union[ReplayWorkload, EventLog],
    scenarios: Dict[str, Dict[str, Any]],
    *,
    recorded_provider: Optional[ProviderModel] = None,
) -> Dict[str, IrregularResult]:
    """Run several :func:`replay` scenarios over one extraction.

    ``scenarios`` maps a label to ``replay`` keyword arguments, e.g.::

        what_if(store, {
            "as-recorded": dict(provider=ProviderModel.aws_lambda()),
            "gcf-ramp":    dict(provider=ProviderModel.gcf()),
            "ewma":        dict(provider=ProviderModel.aws_lambda(),
                                autoscale=AutoscalePolicy(ewma_alpha=0.3)),
        }, recorded_provider=ProviderModel.aws_lambda())
    """
    if isinstance(source, ReplayWorkload):
        wl = source
    else:
        wl = extract_workload(source, provider=recorded_provider)
    return {label: replay(wl, **kw) for label, kw in scenarios.items()}
