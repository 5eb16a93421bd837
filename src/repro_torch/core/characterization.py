"""Algorithm characterization (paper §4.2, Table 2, Figs. 2-3).

Copy of ``repro.core.characterization`` (free of JAX); the port keeps
its own so that it imports nothing of the reference package.

Three lenses on a completed run's execution timeline — pass a pool's
:class:`~repro_torch.core.telemetry.EventLog` (``pool.events``) directly, or
a raw ``TaskRecord`` iterable:

* **Coefficient of variation** C_L = sigma_L / mu_L over task durations —
  the paper's imbalance metric (UTS 1.20, Mariani-Silver 4.06, BC 0.23).
* **Task generation rate** — tasks submitted per unit time (Fig. 2):
  UTS generates erratically throughout; BC all at once; MS in between.
* **Duration CDF** (Fig. 3) — exposes the heavy tails that make static
  provisioning lose.

The same functions run over LM-serving request logs (durations = request
latencies) and MoE routing statistics (durations = per-expert token
counts), which is how the paper's characterization guides deployment of
the framework's own irregular workloads.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple, Union

from .futures import TaskRecord
from .telemetry import EventLog

__all__ = [
    "coefficient_of_variation", "task_generation_rate", "duration_cdf",
    "Characterization", "characterize",
]


def coefficient_of_variation(durations: Sequence[float]) -> float:
    """C_L = sigma/mu (Eq. 2). Population sigma, as in load-imbalance use."""
    xs = [float(d) for d in durations]
    if not xs:
        return 0.0
    mu = sum(xs) / len(xs)
    if mu == 0:
        return 0.0
    var = sum((x - mu) ** 2 for x in xs) / len(xs)
    return math.sqrt(var) / mu


def task_generation_rate(submit_times: Sequence[float],
                         bucket_s: float = 1.0) -> List[Tuple[float, int]]:
    """Histogram of task submissions per ``bucket_s`` window (Fig. 2)."""
    if not len(submit_times):
        return []
    t0 = min(submit_times)
    buckets: dict = {}
    for t in submit_times:
        b = int((t - t0) / bucket_s)
        buckets[b] = buckets.get(b, 0) + 1
    return [(b * bucket_s, buckets[b]) for b in sorted(buckets)]


def duration_cdf(durations: Sequence[float],
                 points: int = 100) -> List[Tuple[float, float]]:
    """Empirical CDF sampled at ``points`` quantiles (Fig. 3)."""
    xs = sorted(float(d) for d in durations)
    if not xs:
        return []
    n = len(xs)
    out = []
    for i in range(points + 1):
        q = i / points
        idx = min(n - 1, int(q * n))
        out.append((xs[idx], q))
    return out


@dataclass
class Characterization:
    n_tasks: int
    cv: float
    mean_duration: float
    p50: float
    p99: float
    max_duration: float
    gen_rate: List[Tuple[float, int]]
    cdf: List[Tuple[float, float]]

    def summary(self) -> dict:
        return {
            "n_tasks": self.n_tasks,
            "coefficient_of_variation": round(self.cv, 4),
            "mean_duration_s": round(self.mean_duration, 6),
            "p50_s": round(self.p50, 6),
            "p99_s": round(self.p99, 6),
            "max_s": round(self.max_duration, 6),
        }


def _quantile(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    idx = min(len(xs) - 1, int(q * len(xs)))
    return xs[idx]


def characterize(records: Union[EventLog, Iterable[TaskRecord]],
                 bucket_s: float = 1.0) -> Characterization:
    """Characterize a run from its timeline (or raw records)."""
    if isinstance(records, EventLog):
        records = records.records
    recs = list(records)
    durations = sorted(r.duration for r in recs)
    submits = [r.submit_time for r in recs]
    mean = sum(durations) / len(durations) if durations else 0.0
    return Characterization(
        n_tasks=len(recs),
        cv=coefficient_of_variation(durations),
        mean_duration=mean,
        p50=_quantile(durations, 0.5),
        p99=_quantile(durations, 0.99),
        max_duration=durations[-1] if durations else 0.0,
        gen_rate=task_generation_rate(submits, bucket_s),
        cdf=duration_cdf(durations),
    )
