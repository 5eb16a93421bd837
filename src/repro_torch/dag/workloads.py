"""Three shipped DAG workload families (Malawski & Balis shapes).

All three are pure-integer and seed-deterministic — node values are
JSON-exact (ints and lists of ints), so outputs are bit-comparable
across pools, batching modes, shard counts and WAL resume, and the
default identity value codecs journal them losslessly.

* :func:`montage_dag` — the classic astronomy-mosaic shape: a wide
  projection fan-out, a pairwise reduce tree, and a final multi-parent
  join (static graph; the fan-in stressor).
* :func:`hyperparam_sweep_dag` — staged training where a gate node
  folds a stage's scores and *early-stops* the losers: only
  above-average configs advance, so stage widths shrink irregularly
  and data-dependently (dynamic graph via ``expand``).
* :func:`iterative_mapreduce_dag` — BSP rounds whose round-k map width
  is computed FROM the round-(k-1) aggregate: the paper's elasticity
  stressor, parallelism unknowable before the previous round folds.
"""
from __future__ import annotations

from typing import Any, List, Tuple

from .spec import DagBuilder, DagNode, DagSpec

__all__ = ["montage_dag", "hyperparam_sweep_dag",
           "iterative_mapreduce_dag"]

_MASK = (1 << 64) - 1


def _mix(*parts: int) -> int:
    """splitmix64-style integer hash fold — deterministic, platform
    independent, and cheap enough for a no-op-sized task body."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h = (h + (int(p) & _MASK)) & _MASK
        h ^= h >> 30
        h = (h * 0xBF58476D1CE4E5B9) & _MASK
        h ^= h >> 27
        h = (h * 0x94D049BB133111EB) & _MASK
        h ^= h >> 31
    return h


def montage_dag(tiles: int = 16, *, seed: int = 11,
                name: str = "montage") -> DagSpec:
    """Montage-style pipeline: ``tiles``-wide projection fan-out →
    pairwise reduce tree → final join (mosaic ⋈ background)."""

    def project(inputs: Tuple[Any, ...], payload: Any) -> int:
        return _mix(seed, 1, payload) % 10**9

    def combine(inputs: Tuple[Any, ...], payload: Any) -> int:
        return _mix(seed, 2, *inputs) % 10**9

    def mosaic(inputs: Tuple[Any, ...], payload: Any) -> int:
        return _mix(seed, 3, *inputs) % 10**9

    b = DagBuilder(name)
    ids = b.stage("project").fan_out("project", project, range(tiles),
                                     cost=4.0)
    level = 0
    while len(ids) > 1:
        b.stage(f"reduce/{level}")
        nxt = [b.join(f"reduce/{level}/{i // 2}", combine,
                      (ids[i], ids[i + 1]))
               for i in range(0, len(ids) - 1, 2)]
        if len(ids) % 2:
            nxt.append(ids[-1])  # odd tile rides up to the next level
        ids = nxt
        level += 1
    bg = b.stage("background").node("background", project,
                                    payload=tiles)
    b.stage("mosaic").join("mosaic", mosaic, (ids[0], bg), cost=2.0)
    return b.build()


def hyperparam_sweep_dag(configs: int = 8, stages: int = 3, *,
                         seed: int = 7,
                         name: str = "hyperparam-sweep") -> DagSpec:
    """Staged sweep with early stopping: each gate keeps only the
    configs scoring at or above the stage mean, so the next stage's
    width is data-dependent.  The final gate's ranked
    ``[[config, score], ...]`` list is the sink value."""
    if configs < 1 or stages < 1:
        raise ValueError(f"{name}: needs configs >= 1 and stages >= 1")

    def train(inputs: Tuple[Any, ...], payload: Any) -> List[int]:
        stage, cfg = payload
        prev = inputs[0][1] if inputs else 0
        return [cfg, _mix(seed, stage, cfg, prev) % 1000]

    def gate(inputs: Tuple[Any, ...], payload: Any) -> List[List[int]]:
        mean = sum(p[1] for p in inputs) // len(inputs)
        survivors = [p for p in inputs if p[1] >= mean]
        return sorted(survivors, key=lambda p: (-p[1], p[0]))

    def make_expand(stage: int):
        def expand(survivors: List[List[int]]):
            nodes = [DagNode(
                id=f"s{stage}/c/{cfg}", fn=train,
                deps=(f"s{stage - 1}/c/{cfg}", f"gate/{stage - 1}"),
                payload=[stage, cfg], stage=f"train/{stage}")
                for cfg, _score in survivors]
            nodes.append(DagNode(
                id=f"gate/{stage}", fn=gate,
                deps=tuple(n.id for n in nodes),
                expand=(make_expand(stage + 1)
                        if stage + 1 < stages else None),
                stage=f"gate/{stage}"))
            return nodes
        return expand

    b = DagBuilder(name)
    trains = b.stage("train/0").fan_out(
        "s0/c", train, [[0, i] for i in range(configs)])
    b.stage("gate/0").join(
        "gate/0", gate, trains,
        expand=make_expand(1) if stages > 1 else None)
    return b.build()


def iterative_mapreduce_dag(rounds: int = 4, initial_width: int = 8, *,
                            max_width: int = 16, seed: int = 3,
                            name: str = "iter-mapreduce") -> DagSpec:
    """Iterative MapReduce: BSP rounds where round ``k``'s map width is
    ``1 + aggregate(k-1) % max_width`` — the next round's parallelism
    literally cannot be known before the previous round folds."""
    if rounds < 1 or initial_width < 1 or max_width < 1:
        raise ValueError(
            f"{name}: needs rounds/initial_width/max_width >= 1")

    def mapper(inputs: Tuple[Any, ...], payload: Any) -> int:
        rnd, i = payload
        carry = inputs[0] if inputs else 0
        return _mix(seed, rnd, i, carry) % 10**6

    def reducer(inputs: Tuple[Any, ...], payload: Any) -> int:
        return sum(inputs) % 10**9

    def make_expand(rnd: int):
        def expand(agg: int):
            if rnd + 1 >= rounds:
                return ()
            width = 1 + agg % max_width
            maps = [DagNode(
                id=f"r{rnd + 1}/m/{i}", fn=mapper,
                deps=(f"r{rnd}/reduce",), payload=[rnd + 1, i],
                stage=f"map/{rnd + 1}") for i in range(width)]
            return maps + [DagNode(
                id=f"r{rnd + 1}/reduce", fn=reducer,
                deps=tuple(m.id for m in maps),
                expand=make_expand(rnd + 1),
                stage=f"reduce/{rnd + 1}")]
        return expand

    b = DagBuilder(name)
    maps = b.stage("map/0").fan_out(
        "r0/m", mapper, [[0, i] for i in range(initial_width)])
    b.stage("reduce/0").join("r0/reduce", reducer, maps,
                             expand=make_expand(0))
    return b.build()
