"""Dependency-structured workloads: ``DagNode``, ``DagSpec``, builder.

The paper's three case studies are *tree*-irregular: every task's
children depend only on that task, so the frontier is a bag and any
completion order folds to the same answer.  Scientific workflows
(Malawski & Balis) are *DAG*-irregular: stages fan out, fan back in
through joins, and a task becomes runnable only when ALL of its
upstream dependencies have folded.  ``DagSpec`` captures that class
declaratively and adapts itself onto the existing
``WorkSpec``/``run_irregular`` stack (see ``dag.scheduler``), so
batching, autoscale, speculation, chaos faults and WAL journaling all
apply unchanged.

A node body is a *stateless* function ``fn(inputs, payload)``:

* ``inputs`` — the parents' folded values, gathered in the node's
  declared dependency order (a deterministic, canonically-ordered
  gather: bit-identical across pools and completion orders);
* ``payload`` — the node's own static argument.

Dynamic graphs — the elasticity stressor — come from ``expand``: after
a node folds, ``expand(value)`` may emit NEW nodes (next BSP round,
surviving sweep configs), validated and scheduled master-side, so the
graph's width is data-dependent yet deterministic.

Values cross the WAL when journaling is on, so keep them JSON-exact
(ints, floats, strings, lists, dicts — no tuples, no numpy scalars) or
supply ``encode_value``/``decode_value`` codecs on the spec.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = ["DagNode", "DagSpec", "DagBuilder"]


def _identity(v: Any) -> Any:
    return v


@dataclass(frozen=True)
class DagNode:
    """One task in a dependency-structured workload."""

    #: unique node id (stable across runs — it is the WAL matching key)
    id: str
    #: stateless body: (inputs, payload) -> value; ``inputs`` holds the
    #: parents' values in ``deps`` order
    fn: Callable[[Tuple[Any, ...], Any], Any]
    #: upstream node ids — the node is frontier-ready only when every
    #: one of them has folded
    deps: Tuple[str, ...] = ()
    #: static argument handed to ``fn`` (tile index, config, ...)
    payload: Any = None
    #: a-priori work estimate (drives ``cost_hint`` / sim durations)
    cost: float = 1.0
    #: master-side dynamic expansion: value -> new DagNodes appended to
    #: the graph after this node folds (irregular stage widths)
    expand: Optional[Callable[[Any], Iterable["DagNode"]]] = None
    #: builder-assigned stage label (diagnostics only)
    stage: Optional[str] = None

    def __post_init__(self) -> None:
        if not isinstance(self.deps, tuple):
            object.__setattr__(self, "deps", tuple(self.deps))


@dataclass(frozen=True)
class DagSpec:
    """A ``WorkSpec`` sibling for dependency-structured workloads.

    Pass it straight to ``run_irregular`` — the driver adapts it via
    :meth:`to_workspec` onto the ordinary completion path.  The output
    is ``{sink_id: value}`` over the final graph's sink nodes (or the
    explicit ``outputs`` ids), sorted by id — canonical, so runs are
    bit-comparable across pools, batching modes and shard counts.
    """

    name: str
    #: the static nodes (dynamic ones arrive through ``expand``)
    nodes: Tuple[DagNode, ...] = ()
    #: explicit output node ids; default: the final graph's sinks
    outputs: Optional[Tuple[str, ...]] = None
    #: WAL value codecs — must round-trip exactly (default: identity,
    #: i.e. values are already JSON-exact)
    encode_value: Callable[[Any], Any] = _identity
    decode_value: Callable[[Any], Any] = _identity

    def __post_init__(self) -> None:
        if not isinstance(self.nodes, tuple):
            object.__setattr__(self, "nodes", tuple(self.nodes))
        if self.outputs is not None and not isinstance(self.outputs, tuple):
            object.__setattr__(self, "outputs", tuple(self.outputs))
        validate_nodes(self.name, self.nodes)
        if self.outputs is not None:
            known = {n.id for n in self.nodes}
            bad = [o for o in self.outputs if o not in known]
            if bad:
                raise ValueError(
                    f"{self.name}: outputs reference unknown node(s) "
                    f"{bad}")

    def to_workspec(self):
        """Adapt onto the ``run_irregular`` completion path (a fresh
        scheduler per call, so one spec drives many runs)."""
        from .scheduler import build_workspec
        return build_workspec(self)


def validate_nodes(name: str, nodes: Iterable[DagNode]) -> None:
    """Reject duplicate ids, unreachable dependencies and cycles.

    * a dep naming no node makes its dependent *unreachable* — it can
      never become frontier-ready;
    * a dependency cycle deadlocks the whole component (detected by
      Kahn's algorithm: the peel-off must consume every node).
    """
    nodes = list(nodes)
    by_id: Dict[str, DagNode] = {}
    for n in nodes:
        if n.id in by_id:
            raise ValueError(f"{name}: duplicate node id {n.id!r}")
        by_id[n.id] = n
    indeg: Dict[str, int] = {}
    dependents: Dict[str, List[str]] = {}
    for n in nodes:
        for d in n.deps:
            if d not in by_id:
                raise ValueError(
                    f"{name}: node {n.id!r} depends on unknown node "
                    f"{d!r} — it is unreachable (can never become "
                    f"frontier-ready)")
            dependents.setdefault(d, []).append(n.id)
        indeg[n.id] = len(n.deps)
    ready = [nid for nid, k in indeg.items() if k == 0]
    seen = 0
    while ready:
        nid = ready.pop()
        seen += 1
        for child in dependents.get(nid, ()):
            indeg[child] -= 1
            if indeg[child] == 0:
                ready.append(child)
    if seen != len(nodes):
        stuck = sorted(nid for nid, k in indeg.items() if k > 0)
        raise ValueError(
            f"{name}: dependency cycle through node(s) {stuck}")


class DagBuilder:
    """Small fluent builder for :class:`DagSpec` graphs.

    >>> b = DagBuilder("example")
    >>> tiles = b.stage("project").fan_out("tile", project, range(4))
    >>> final = b.stage("mosaic").join("mosaic", combine, tiles)
    >>> spec = b.build()

    ``node`` adds one task, ``fan_out`` a parallel stage (one node per
    payload, shared deps), ``join`` a gather node over many parents,
    ``stage`` labels subsequently added nodes.  All four return node
    ids (or id lists) so stages chain naturally; validation happens at
    :meth:`build` (and again in ``DagSpec.__post_init__``).
    """

    def __init__(self, name: str):
        self.name = name
        self._nodes: List[DagNode] = []
        self._stage: Optional[str] = None

    def stage(self, label: str) -> "DagBuilder":
        """Label subsequently added nodes (chainable)."""
        self._stage = label
        return self

    def node(self, id: str, fn: Callable, deps: Iterable[str] = (),
             *, payload: Any = None, cost: float = 1.0,
             expand: Optional[Callable] = None) -> str:
        self._nodes.append(DagNode(
            id=id, fn=fn, deps=tuple(deps), payload=payload, cost=cost,
            expand=expand, stage=self._stage))
        return id

    def fan_out(self, prefix: str, fn: Callable,
                payloads: Iterable[Any], deps: Iterable[str] = (),
                *, cost: float = 1.0) -> List[str]:
        """One node per payload (``{prefix}/{i}``), all sharing
        ``deps`` — a parallel stage."""
        deps = tuple(deps)
        return [self.node(f"{prefix}/{i}", fn, deps, payload=p,
                          cost=cost)
                for i, p in enumerate(payloads)]

    def join(self, id: str, fn: Callable, deps: Iterable[str],
             *, payload: Any = None, cost: float = 1.0,
             expand: Optional[Callable] = None) -> str:
        """A gather node: runs once every parent has folded, receiving
        their values in ``deps`` order."""
        return self.node(id, fn, deps, payload=payload, cost=cost,
                         expand=expand)

    def build(self, *, outputs: Optional[Iterable[str]] = None,
              encode_value: Callable[[Any], Any] = _identity,
              decode_value: Callable[[Any], Any] = _identity) -> DagSpec:
        return DagSpec(
            name=self.name, nodes=tuple(self._nodes),
            outputs=None if outputs is None else tuple(outputs),
            encode_value=encode_value, decode_value=decode_value)
