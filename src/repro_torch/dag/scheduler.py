"""Ready-set scheduler: adapt a ``DagSpec`` onto ``run_irregular``.

The existing driver understands one protocol — ``seed`` produces
items, completions fold through ``reduce``, ``split`` derives
follow-up items.  A DAG fits that protocol exactly once a master-side
tracker owns the dependency bookkeeping:

* ``seed``  = reset the tracker, return the zero-in-degree roots;
* ``split`` = fold the completed node's value into the tracker,
  decrement dependents' in-degrees, run ``expand`` for dynamic nodes,
  and return every node that just became ready — each carrying its
  parents' values gathered in declared-dependency order (the
  deterministic canonical gather);
* ``reduce`` = insert ``(node_id, value)`` into the accumulator dict
  (order-insensitive, so shards/batching/resume fold bit-identically).

The tracker mutates ONLY inside ``seed``/``split`` — both run on the
master thread in every driver AND inside ``recover_frontier``'s
journal replay, which is precisely how ``resume_from=`` rebuilds the
in-degree state bit-identically: replaying the journaled folds through
``split`` reconstructs the same ready-set a live run had.

Readiness is completion-order independent: a node's depth, inputs and
width accounting depend only on WHICH parents folded (all of them),
never on the order they folded in, so outputs are bit-identical across
pools, batching modes and shard counts.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from ..core.adaptive import TaskShape
from ..core.irregular import WorkSpec
from .spec import DagNode, DagSpec

__all__ = ["DagItem", "DagScheduler", "DagWorkSpec", "build_workspec"]


@dataclass(frozen=True)
class DagItem:
    """A frontier-ready node plus its gathered inputs — the stateless
    work unit handed to ``execute`` (safe to re-dispatch)."""

    node: DagNode
    inputs: Tuple[Any, ...] = ()


class DagScheduler:
    """In-degree tracker for one logical run of a :class:`DagSpec`."""

    def __init__(self, dag: DagSpec):
        self.dag = dag
        self.nodes: Dict[str, DagNode] = {}
        self.indeg: Dict[str, int] = {}
        self.dependents: Dict[str, List[str]] = {}
        self.results: Dict[str, Any] = {}
        self.done: Set[str] = set()
        self.depth: Dict[str, int] = {}
        #: executed nodes per dependency depth (irregular stage widths)
        self.stage_widths: List[int] = []
        #: total nodes made ready (static + dynamically expanded)
        self.executed: int = 0
        #: nodes on the longest dependency chain executed
        self.critical_path_len: int = 0

    def reset(self) -> List[DagItem]:
        """Rebuild from the static graph; return the ready roots."""
        self.nodes = {n.id: n for n in self.dag.nodes}
        self.indeg = {n.id: len(n.deps) for n in self.dag.nodes}
        self.dependents = {nid: [] for nid in self.nodes}
        self.results = {}
        self.done = set()
        self.depth = {}
        self.stage_widths = []
        self.executed = 0
        self.critical_path_len = 0
        for n in self.dag.nodes:
            for d in n.deps:
                self.dependents[d].append(n.id)
        return [self._ready(n) for n in self.dag.nodes
                if self.indeg[n.id] == 0]

    def fold(self, node_id: str, value: Any) -> List[DagItem]:
        """Record ``node_id``'s value; return every node that just
        became frontier-ready (expansion nodes first, then dependents
        in declaration order — a fixed order independent of completion
        order)."""
        self.done.add(node_id)
        self.results[node_id] = value
        node = self.nodes[node_id]
        ready: List[DagItem] = []
        if node.expand is not None:
            self._add_nodes(node_id, node.expand(value), ready)
        for child_id in self.dependents[node_id]:
            self.indeg[child_id] -= 1
            if self.indeg[child_id] == 0:
                ready.append(self._ready(self.nodes[child_id]))
        return ready

    def sink_ids(self) -> List[str]:
        """Output node ids: explicit ``outputs`` or the final graph's
        sinks (no dependents), sorted — the canonical output order."""
        if self.dag.outputs is not None:
            return list(self.dag.outputs)
        return sorted(nid for nid, deps in self.dependents.items()
                      if not deps)

    def _ready(self, node: DagNode) -> DagItem:
        d = (0 if not node.deps
             else 1 + max(self.depth[p] for p in node.deps))
        self.depth[node.id] = d
        while len(self.stage_widths) <= d:
            self.stage_widths.append(0)
        self.stage_widths[d] += 1
        self.executed += 1
        self.critical_path_len = max(self.critical_path_len, d + 1)
        return DagItem(node, tuple(self.results[p] for p in node.deps))

    def _add_nodes(self, origin: str, new_nodes: Iterable[DagNode],
                   ready: List[DagItem]) -> None:
        # dynamic nodes must arrive dep-first (each dep names an
        # existing or earlier-in-batch node) — which also makes cycles
        # through dynamic nodes unconstructible
        for n in new_nodes:
            if n.id in self.nodes:
                raise ValueError(
                    f"{self.dag.name}: expand of {origin!r} emitted "
                    f"duplicate node id {n.id!r}")
            for d in n.deps:
                if d not in self.nodes:
                    raise ValueError(
                        f"{self.dag.name}: expand of {origin!r} node "
                        f"{n.id!r} depends on unknown node {d!r}")
            self.nodes[n.id] = n
            self.dependents[n.id] = []
            self.indeg[n.id] = sum(1 for d in n.deps
                                   if d not in self.done)
            for d in n.deps:
                self.dependents[d].append(n.id)
            if self.indeg[n.id] == 0:
                ready.append(self._ready(n))


@dataclass(frozen=True)
class DagWorkSpec(WorkSpec):
    """The adapted spec ``run_irregular`` actually drives; ``dag``
    carries the live scheduler so the driver can surface
    ``critical_path_len``/``stage_widths``/``dag_nodes``."""

    dag: Optional[DagScheduler] = None


def build_workspec(dag: DagSpec) -> DagWorkSpec:
    """Wire a fresh scheduler to a :class:`DagWorkSpec` (one per call:
    a ``DagSpec`` can drive many concurrent runs)."""
    sched = DagScheduler(dag)

    def execute(item: DagItem, shape: TaskShape) -> Tuple[str, Any]:
        return (item.node.id, item.node.fn(item.inputs,
                                           item.node.payload))

    def execute_batch(items: List[DagItem],
                      shape: TaskShape) -> List[Tuple[str, Any]]:
        # per-item map — equivalent to ``execute`` by construction, so
        # any subset of ready nodes may fuse into one carrier
        return [execute(it, shape) for it in items]

    def reduce(state: Dict[str, Any],
               r: Tuple[str, Any]) -> Dict[str, Any]:
        state[r[0]] = r[1]
        return state

    def merge(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
        a.update(b)  # node ids are unique, so shard dicts are disjoint
        return a

    def finalize(state: Dict[str, Any]) -> Dict[str, Any]:
        return {nid: state[nid] for nid in sched.sink_ids()}

    return DagWorkSpec(
        name=dag.name,
        execute=execute,
        seed=lambda shape: sched.reset(),
        split=lambda r, shape: sched.fold(r[0], r[1]),
        reduce=reduce,
        init=dict,
        merge=merge,
        finalize=finalize,
        cost_hint=lambda item: item.node.cost,
        execute_batch=execute_batch,
        encode_item=lambda it: {"n": it.node.id},
        encode_result=lambda r: {"n": r[0],
                                 "v": dag.encode_value(r[1])},
        decode_result=lambda e: (e["n"], dag.decode_value(e["v"])),
        dag=sched,
    )
