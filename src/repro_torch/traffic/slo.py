"""SLO-aware autoscale: target p99 TTFT, not pressure.

The base :class:`~repro_torch.core.provider.AutoscalePolicy` follows the
irregular *frontier* — queued tasks are demand, idle slots are waste.
Serving has a different contract: the operator promises a tail latency
(p99 time-to-first-token) and wants the cheapest capacity that holds
it.  :class:`SLOAutoscalePolicy` keeps a sliding window of observed
TTFTs and

* **grows** (multiplicatively, ``grow_fraction`` of current capacity)
  while the window's p99 exceeds ``target_p99_ttft_s``;
* **shrinks** through the inherited gradual-drain arithmetic only when
  the tail sits below ``headroom`` x target *and* the pool is
  demonstrably over-provisioned (no queue, mostly idle);
* otherwise holds — a tail inside the band is the cheap steady state.

It plugs in everywhere the base policy does: the serving harness feeds
it real TTFTs via :meth:`observe_ttft`; ``run_irregular`` feeds it
per-completion queue delays via the :meth:`observe_completion` hook, so
the policy can be *tuned offline* against a recorded trace through
``repro_torch.trace.replay.what_if`` (queue delay is the capacity-dependent
component of TTFT — the prefill/decode terms replay identically at any
width, so minimizing the proxy minimizes the real tail).
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Optional, Sequence

from ..core.provider import AutoscalePolicy

__all__ = ["SLOAutoscalePolicy", "p_quantile"]


def p_quantile(xs: Sequence[float], q: float) -> float:
    """Order-statistic quantile (no interpolation): the smallest sample
    s.t. >= ``q`` of the window is at or below it.  Deterministic and
    numpy-free so the policy works on any pool thread."""
    if not xs:
        return 0.0
    s = sorted(xs)
    idx = min(len(s) - 1, max(0, int(math.ceil(q * len(s))) - 1))
    return s[idx]


@dataclass
class SLOAutoscalePolicy(AutoscalePolicy):
    """Capacity chases a p99 TTFT target instead of frontier pressure.

    target_p99_ttft_s   the SLO the operator promises
    react_fraction      grow once the window p99 crosses
                        ``react_fraction * target`` — reacting only at
                        the breach itself means the breach has already
                        happened by the time capacity lands, so the
                        policy defends the SLO from *inside* it
    headroom            shrink only below ``headroom * target`` (the
                        hysteresis band that prevents flapping; keep
                        ``headroom < react_fraction``)
    slo_window          sliding window length (observations)
    min_observations    before this many TTFTs are seen, defer to the
                        inherited pressure policy (cold-start phase)
    grow_fraction       multiplicative grow step (fraction of current
                        capacity, >= 1 slot)
    """

    target_p99_ttft_s: float = 1.0
    react_fraction: float = 0.7
    headroom: float = 0.5
    slo_window: int = 64
    min_observations: int = 8
    grow_fraction: float = 0.25

    def __post_init__(self) -> None:
        super().__post_init__()
        self._ttft: deque = deque(maxlen=self.slo_window)

    # -- observation feeds -------------------------------------------------
    def observe_ttft(self, ttft_s: float,
                     now: Optional[float] = None) -> None:
        """One served request's time-to-first-token."""
        self._ttft.append(float(ttft_s))

    def observe_completion(self, *, queue_delay_s: float,
                           duration_s: float = 0.0,
                           now: Optional[float] = None) -> None:
        """``run_irregular``'s per-completion hook: queue delay is the
        capacity-dependent TTFT component, so replays tune against it."""
        self.observe_ttft(queue_delay_s, now=now)

    def window_p99(self) -> float:
        return p_quantile(self._ttft, 0.99)

    # -- the decision ------------------------------------------------------
    def decide(self, *, pending: int, idle: int, capacity: int,
               now: Optional[float] = None) -> int:
        if len(self._ttft) < self.min_observations:
            return super().decide(pending=pending, idle=idle,
                                  capacity=capacity, now=now)
        p99 = self.window_p99()
        if p99 > self.react_fraction * self.target_p99_ttft_s:
            if not self._cooled(self._last_grow_t, self.grow_cooldown_s,
                                now):
                return capacity
            step = max(1, int(math.ceil(capacity * self.grow_fraction)))
            target = min(self.max_capacity, capacity + step)
            if target != capacity:
                self._last_grow_t = now
                # the window measured the *old* capacity; a fresh one
                # stops stale tail samples forcing growth past the knee
                self._ttft.clear()
            return target
        if (p99 < self.headroom * self.target_p99_ttft_s
                and pending == 0
                and idle > self.shrink_idle_fraction * capacity):
            if not self._cooled(self._last_shrink_t,
                                self.shrink_cooldown_s, now):
                return capacity
            surplus = max(1, int(idle * self.shrink_factor))
            target = max(self.min_capacity, capacity - surplus)
            if target != capacity:
                self._last_shrink_t = now
            return target
        return capacity
