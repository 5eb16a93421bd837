"""Adaptive task-shaping controller (paper §5.2, Listing 5).

The paper shows that dynamically adjusting two knobs from the *measured
pool concurrency* — the split factor (how many child tasks a bag is split
into) and the per-task iteration budget (how many nodes a task may
traverse) — improves UTS wall time by 41.6 % for +3.31 % cost:

    phase 0 (ramp-up):   split wide (200), traverse little (50k)
    phase 1 (>800 act):  split 50, traverse 2.5M
    phase 2 (>1300 act): split 5,  traverse 5M
    phase 3 (<1100 act): traverse 2.5M   (drain begins)
    phase 4 (<100 act):  traverse 1M     (tail: create tasks fast again)

We implement (a) ``StagedController`` — the paper's exact staged policy,
and (b) ``OccupancyController`` — a continuous generalization that targets
a pool-occupancy setpoint; the latter is reused by the LM serving batcher
(``repro.serving.elastic_batcher``) where the knobs become prefill chunk
size and decode admission width.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Tuple

__all__ = ["TaskShape", "StagedController", "OccupancyController"]


@dataclass(frozen=True)
class TaskShape:
    """The two knobs of paper §5.2."""

    split_factor: int
    iters: int


@dataclass
class Stage:
    # Transition fires when `direction`(active, threshold) is true.
    threshold: int
    direction: str  # "above" | "below"
    shape: TaskShape


class StagedController:
    """Paper Listing 5, faithfully: a one-way ladder of stages keyed on the
    current number of active tasks."""

    def __init__(self, initial: TaskShape = TaskShape(200, 50_000),
                 stages: List[Stage] = None) -> None:
        self._shape = initial
        self.step = 0
        self.stages = stages if stages is not None else [
            Stage(800, "above", TaskShape(50, 2_500_000)),
            Stage(1300, "above", TaskShape(5, 5_000_000)),
            Stage(1100, "below", TaskShape(5, 2_500_000)),
            Stage(100, "below", TaskShape(5, 1_000_000)),
        ]
        self.transitions: List[Tuple[int, int]] = []  # (active, step) log

    def update(self, active: int) -> TaskShape:
        if self.step < len(self.stages):
            st = self.stages[self.step]
            fired = (active > st.threshold if st.direction == "above"
                     else active < st.threshold)
            if fired:
                self.step += 1
                self._shape = st.shape
                self.transitions.append((active, self.step))
        return self._shape

    @property
    def shape(self) -> TaskShape:
        return self._shape


@dataclass
class OccupancyController:
    """Continuous controller: keep pool occupancy near a setpoint.

    When the pool is under-occupied we split wider and shorten tasks so new
    parallelism is generated quickly; when saturated we split narrower and
    lengthen tasks to amortize invocation overhead — the exact logic the
    paper applies by hand, in closed-loop form.

    gain        proportional gain on log-occupancy error
    min/max     clamps for both knobs
    """

    capacity: int
    target_occupancy: float = 0.95
    gain: float = 1.0
    min_split: int = 2
    max_split: int = 256
    min_iters: int = 10_000
    max_iters: int = 5_000_000
    init_shape: TaskShape = TaskShape(64, 100_000)
    _log_split: float = field(init=False, default=0.0)
    _log_iters: float = field(init=False, default=0.0)
    history: List[Tuple[float, TaskShape]] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._log_split = math.log(self.init_shape.split_factor)
        self._log_iters = math.log(self.init_shape.iters)

    def update(self, active: int) -> TaskShape:
        occ = max(active, 0) / max(self.capacity, 1)
        # error > 0 ⇒ under-occupied ⇒ more splitting, shorter tasks.
        err = math.log(max(self.target_occupancy, 1e-6) /
                       max(occ, 1.0 / (4 * self.capacity)))
        self._log_split += self.gain * 0.25 * err
        self._log_iters -= self.gain * 0.25 * err
        split = int(round(math.exp(self._log_split)))
        iters = int(round(math.exp(self._log_iters)))
        shape = TaskShape(
            split_factor=max(self.min_split, min(self.max_split, split)),
            iters=max(self.min_iters, min(self.max_iters, iters)),
        )
        # keep clamped state so the controller doesn't wind up
        self._log_split = math.log(shape.split_factor)
        self._log_iters = math.log(shape.iters)
        self.history.append((occ, shape))
        return shape
