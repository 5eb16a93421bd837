"""Elastic continuous batcher — the paper's executor driving LM serving.

Copy of ``repro.serving.elastic_batcher`` with its imports pointed at
the port's ``core``.

Requests are tasks; the decode engine is the worker pool.  Request
lengths are heavy-tailed (the paper's CDF characterization, §4.2,
applies verbatim), so static batch shapes over- or under-provision —
the same failure mode as static clusters on UTS.  The §5.2 adaptive
controller retunes the two serving knobs from live pool occupancy:

    split_factor  ->  prefill chunk size (how finely a long prompt is
                      chopped so decode slots never starve)
    iters         ->  decode burst length (steps run before the engine
                      re-admits from the queue)

The engine here is pluggable: tests drive a host ``SimEngine``; ``launch.serve``
wires the port's ``TorchEngine`` (decode on the card) in.

Since the unified-pool redesign the batcher reports through the same
``ExecutorStats`` surface as every ``make_pool`` backend: requests are
``on_submit``-ed at ingress, slots ``on_start`` at admission and
``on_finish`` a ``TaskRecord`` at retirement, so ``stats`` /
``records`` / ``snapshot()`` read exactly like an executor pool's and
peak slot occupancy is measured by the shared notification layer.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.adaptive import OccupancyController, TaskShape
from ..core.characterization import characterize
from ..core.executor import ExecutorStats
from ..core.futures import TaskRecord
from ..core.telemetry import PARENT_ROOT

__all__ = ["Request", "BatcherConfig", "ElasticBatcher", "SimEngine"]


@dataclass
class Request:
    rid: int
    prompt_len: int
    max_new_tokens: int
    arrived: float = field(default_factory=time.monotonic)
    # progress
    prefilled: int = 0
    generated: int = 0
    slot: Optional[int] = None
    first_token_t: Optional[float] = None
    done_t: Optional[float] = None

    @property
    def finished(self) -> bool:
        return self.generated >= self.max_new_tokens


@dataclass(frozen=True)
class BatcherConfig:
    n_slots: int = 8                 # concurrent decode slots (batch)
    prefill_chunk: int = 256         # initial; controller retunes
    decode_burst: int = 8            # initial; controller retunes
    adaptive: bool = True


class SimEngine:
    """Host stand-in for the pod engine: costs are analytic.

    prefill(chunk_tokens) costs ~ c_p * tokens; decode(batch) costs
    ~ c_d per step.  Lets the batcher logic be tested deterministically.
    """

    def __init__(self, c_prefill: float = 1e-5, c_decode: float = 1e-4):
        self.c_p = c_prefill
        self.c_d = c_decode
        self.prefill_tokens = 0
        self.decode_steps = 0

    def prefill_chunk(self, tokens: int) -> None:
        self.prefill_tokens += tokens
        time.sleep(self.c_p * tokens)

    def decode(self, n_active: int) -> None:
        self.decode_steps += 1
        time.sleep(self.c_d)


class ElasticBatcher:
    """Continuous batching loop with the paper's occupancy controller."""

    def __init__(self, engine, cfg: BatcherConfig, *, trace=None,
                 clock=None):
        self.engine = engine
        self.cfg = cfg
        self.queue: List[Request] = []
        self.slots: List[Optional[Request]] = [None] * cfg.n_slots
        self.completed: List[Request] = []
        # unified Pool stats surface; ``trace`` adopts an external
        # timeline (a spill-to-disk TraceStore records the serving run
        # for the replay/what-if loop), ``clock`` stamps it
        self.stats = ExecutorStats(clock=clock, log=trace)
        self.controller = OccupancyController(
            capacity=cfg.n_slots,
            init_shape=TaskShape(split_factor=max(
                1, 4096 // cfg.prefill_chunk), iters=cfg.decode_burst),
            min_split=1, max_split=64,
            min_iters=1, max_iters=64,
        )
        self._shape = self.controller.init_shape

    # -- ingress --------------------------------------------------------------
    def submit(self, req: Request) -> None:
        # serving arrivals are roots of the dispatch DAG (nothing
        # spawned them), and they carry their request id so a recorded
        # timeline replays each request exactly
        self.stats.on_submit(req.rid, parent=PARENT_ROOT)
        self.queue.append(req)

    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot is None and self.queue:
                req = self.queue.pop(0)
                req.slot = i
                self.slots[i] = req
                self.stats.on_start(req.rid, worker=f"slot{i}")

    # -- one scheduler round ---------------------------------------------------
    def step(self) -> None:
        self._admit()
        active = [r for r in self.slots if r is not None]
        if not active:
            return
        if self.cfg.adaptive:
            self._shape = self.controller.update(len(active))
        # knobs: split_factor -> prefill chunk; iters -> decode burst
        chunk = max(64, 4096 // max(1, self._shape.split_factor))
        burst = max(1, self._shape.iters)

        # 1. advance at most one prefill chunk per un-prefilled request
        for r in active:
            if r.prefilled < r.prompt_len:
                take = min(chunk, r.prompt_len - r.prefilled)
                self.engine.prefill_chunk(take)
                r.prefilled += take

        # 2. decode burst for fully-prefilled requests
        ready = [r for r in active if r.prefilled >= r.prompt_len
                 and not r.finished]
        if ready:
            for _ in range(burst):
                self.engine.decode(len(ready))
                now = time.monotonic()
                for r in ready:
                    if r.generated < r.max_new_tokens:
                        if r.first_token_t is None:
                            r.first_token_t = now
                        r.generated += 1
                ready = [r for r in ready if not r.finished]
                if not ready:
                    break

        # 3. retire
        for i, r in enumerate(self.slots):
            if r is not None and r.finished:
                r.done_t = time.monotonic()
                self.completed.append(r)
                self.slots[i] = None
                self.stats.on_finish(TaskRecord(
                    task_id=r.rid, worker=f"slot{r.slot}",
                    submit_time=r.arrived,
                    start_time=r.first_token_t or r.arrived,
                    end_time=r.done_t, cost_hint=r.prompt_len,
                    remote=True), ok=True)

    def run(self, until_empty: bool = True, max_rounds: int = 100_000
            ) -> Dict[str, Any]:
        rounds = 0
        t0 = time.monotonic()
        while (self.queue or any(self.slots)) and rounds < max_rounds:
            self.step()
            rounds += 1
        wall = time.monotonic() - t0
        return self.report(wall, rounds)

    @property
    def records(self) -> List[TaskRecord]:
        """Per-request completion log (the Pool ``records`` surface)."""
        return self.stats.records

    def snapshot(self) -> Dict[str, Any]:
        """Pool-style counters: submitted/active/completed/peak slots."""
        return self.stats.snapshot()

    def report(self, wall: float, rounds: int) -> Dict[str, Any]:
        recs = self.stats.records
        tokens = sum(r.generated for r in self.completed)
        ttfts = [r.first_token_t - r.arrived for r in self.completed
                 if r.first_token_t]
        return {
            "requests": len(self.completed),
            "rounds": rounds,
            "wall_s": wall,
            "tokens": tokens,
            "tok_per_s": tokens / wall if wall else 0.0,
            "ttft_p50": float(np.median(ttfts)) if ttfts else 0.0,
            "ttft_p99": float(np.quantile(ttfts, 0.99)) if ttfts else 0.0,
            "peak_slots": self.stats.peak_concurrency,
            "pool": self.stats.snapshot(),
            "characterization": characterize(recs).summary() if recs
            else {},
        }
