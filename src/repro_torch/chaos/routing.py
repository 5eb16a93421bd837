"""Offload routing as a first-class policy object.

The paper's hybrid rule (Listing 1) is a single hard-coded predicate —
run locally iff the local pool has an idle slot — and our
``HybridExecutor`` later grew a static ``cost_hint`` threshold variant.
The related FaaS-manager repo's core loop is "offload to cloud
according to a local decision policy"; this module makes that policy a
pluggable object chosen **per task**:

    pool = make_pool("hybrid",
                     policy=make_routing_policy("cost-per-deadline",
                                                deadline_s=0.5))

A policy answers ``route(hybrid, cost_hint=...) -> bool`` (True = run
on the local donor VM, False = offload to the elastic pool).  Policies
only read the hybrid's public surface (idle capacity, backlog, the
elastic side's ``ProviderModel`` / warm fleet), so they work unchanged
against any object exposing ``.local`` / ``.elastic`` pools — the sim
benchmark harness routes through the same objects.  Plain callables
``policy(hybrid) -> bool`` keep working (the paper's rule is one).

Policies are deterministic — :class:`RandomPolicy` draws from a seeded
counter-hash stream — so a routed run is reproducible and tunable
offline via trace replay (``repro_torch.trace.replay.what_if``).
"""
from __future__ import annotations

import time
from typing import Any, Optional

from .faults import _SALT_STORM_JITTER, _unit

__all__ = [
    "RoutingPolicy", "LocalFirstPolicy", "ThresholdPolicy",
    "RandomPolicy", "LeastLoadedPolicy", "CostPerDeadlinePolicy",
    "make_routing_policy",
]


def _pool_now(pool: Any) -> float:
    """A timestamp in ``pool``'s own time domain (virtual pools carry
    a clock; wall pools use the process monotonic clock)."""
    clk = getattr(pool, "clock", None)
    return clk.now() if clk is not None else time.monotonic()


def _elastic_overhead(elastic: Any) -> float:
    """Expected invocation overhead of offloading right now: the
    provider's warm overhead, plus the full cold-start penalty when no
    warm container is idle (the same provider-aware expectation the
    straggler watchdog uses)."""
    provider = getattr(elastic, "provider", None)
    if provider is None:
        return float(getattr(elastic, "invoke_overhead", 0.0) or 0.0)
    fleet = getattr(elastic, "_fleet", None)
    warm = (fleet.warm_count(_pool_now(elastic))
            if fleet is not None else 0)
    return provider.expected_clone_overhead(warm_available=warm > 0)


class RoutingPolicy:
    """Base class: ``route`` decides one task's placement.

    Instances are also plain callables (``policy(hybrid)``) for
    back-compat with the legacy predicate-style policy argument.
    """

    name = "routing-policy"

    def route(self, hybrid: Any, *, cost_hint: float = 1.0,
              **kw: Any) -> bool:
        """True = run on the local donor VM; False = offload."""
        raise NotImplementedError

    def __call__(self, hybrid: Any) -> bool:
        return self.route(hybrid)

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class LocalFirstPolicy(RoutingPolicy):
    """The paper's Listing-1 rule: local iff an idle local slot."""

    name = "local-first"

    def route(self, hybrid: Any, *, cost_hint: float = 1.0,
              **kw: Any) -> bool:
        return hybrid.local.idle_capacity() > 0


class ThresholdPolicy(RoutingPolicy):
    """The legacy static rule: big tasks offload, small ones stay.

    Tasks with ``cost_hint`` at or above ``cost_threshold`` go elastic;
    the rest run locally while a slot is idle (spilling when saturated,
    so cheap work cannot deadlock a full donor VM)."""

    name = "threshold"

    def __init__(self, cost_threshold: float = 1.0) -> None:
        self.cost_threshold = cost_threshold

    def route(self, hybrid: Any, *, cost_hint: float = 1.0,
              **kw: Any) -> bool:
        if cost_hint >= self.cost_threshold:
            return False
        return hybrid.local.idle_capacity() > 0

    def __repr__(self) -> str:
        return f"ThresholdPolicy(cost_threshold={self.cost_threshold})"


class RandomPolicy(RoutingPolicy):
    """Bernoulli(p_local) placement from a seeded stream — the load
    balancer's baseline, and deterministic run to run."""

    name = "random"

    def __init__(self, seed: int = 0, p_local: float = 0.5) -> None:
        if not 0.0 <= p_local <= 1.0:
            raise ValueError("p_local must be in [0, 1]")
        self.seed = seed
        self.p_local = p_local
        self._n = 0

    def route(self, hybrid: Any, *, cost_hint: float = 1.0,
              **kw: Any) -> bool:
        i, self._n = self._n, self._n + 1
        return _unit(self.seed, i, _SALT_STORM_JITTER ^ 0xA5A5) \
            < self.p_local


class LeastLoadedPolicy(RoutingPolicy):
    """Route to the side with the lower fractional load (busy + queued
    over capacity); ties go local (the donor VM is sunk cost)."""

    name = "least-loaded"

    @staticmethod
    def _load(pool: Any) -> float:
        cap = max(1, getattr(pool, "max_concurrency", 1))
        busy = cap - pool.idle_capacity()
        return (busy + pool.pending()) / cap

    def route(self, hybrid: Any, *, cost_hint: float = 1.0,
              **kw: Any) -> bool:
        return self._load(hybrid.local) <= self._load(hybrid.elastic)


class CostPerDeadlinePolicy(RoutingPolicy):
    """Deadline-aware cost minimizer using the provider model.

    Estimates each side's completion time for this task —

    * local:   queue-position wait (backlog over local width) + body
    * elastic: expected invocation overhead (warm, or the full
      cold-start penalty when no warm container is idle — the
      ``ProviderModel`` cold/warm expectation) + body

    where body ≈ ``alpha_s_per_cost * cost_hint`` — then keeps the task
    on the free donor VM whenever that still meets ``deadline_s``,
    pays for an invocation only when offloading is what meets it, and
    degrades to whichever side is *faster* when neither can.  This is
    the policy that beats the static threshold in the
    ``chaos_mortality`` benchmark row: it offloads exactly the tasks
    whose local queue wait would blow the deadline, instead of
    everything above a size cutoff.
    """

    name = "cost-per-deadline"

    def __init__(self, deadline_s: float,
                 alpha_s_per_cost: float = 1.0) -> None:
        if deadline_s <= 0:
            raise ValueError("deadline_s must be positive")
        self.deadline_s = deadline_s
        self.alpha_s_per_cost = alpha_s_per_cost

    def etas(self, hybrid: Any, cost_hint: float) -> tuple:
        """(local_eta_s, elastic_eta_s) for a task of this size."""
        body = self.alpha_s_per_cost * cost_hint
        local = hybrid.local
        cap = max(1, getattr(local, "max_concurrency", 1))
        busy = cap - local.idle_capacity()
        backlog = busy + local.pending()
        local_eta = (backlog / cap) * body + body
        elastic_eta = _elastic_overhead(hybrid.elastic) + body
        return local_eta, elastic_eta

    def route(self, hybrid: Any, *, cost_hint: float = 1.0,
              **kw: Any) -> bool:
        local_eta, elastic_eta = self.etas(hybrid, cost_hint)
        if local_eta <= self.deadline_s:
            return True           # meets the SLO at zero marginal cost
        if elastic_eta <= self.deadline_s:
            return False          # only the paid path meets it
        return local_eta <= elastic_eta  # degrade to the faster side

    def __repr__(self) -> str:
        return (f"CostPerDeadlinePolicy(deadline_s={self.deadline_s}, "
                f"alpha_s_per_cost={self.alpha_s_per_cost})")


_POLICIES = {
    "local-first": LocalFirstPolicy,
    "threshold": ThresholdPolicy,
    "random": RandomPolicy,
    "least-loaded": LeastLoadedPolicy,
    "cost-per-deadline": CostPerDeadlinePolicy,
}


def make_routing_policy(name: str, **kw: Any) -> RoutingPolicy:
    """Construct a routing policy by name (dashes or underscores)."""
    key = name.replace("_", "-")
    try:
        cls = _POLICIES[key]
    except KeyError:
        raise ValueError(
            f"unknown routing policy {name!r}; available: "
            f"{', '.join(sorted(_POLICIES))}") from None
    return cls(**kw)
