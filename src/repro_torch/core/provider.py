"""FaaS provider model — cold starts, warm reuse, scaling ramp, billing.

The paper's cost-performance claim (§4.3) rests on platform dynamics
our pools previously ignored: a function invocation lands either on a
*warm* container (overhead ~13 ms, Table 4) or a *cold* one (container
provision + runtime init, hundreds of ms), warm containers are
reclaimed after an idle keep-alive window, and concurrency does not
appear instantly — AWS Lambda grants a burst (500-3000 by region) and
then grows the limit by ~500/min.  "Benchmarking Parallelism in FaaS
Platforms" (Barcelona-Pons & García-López, PAPERS.md) measures exactly
these ramp/cold-start curves dominating real FaaS parallelism.

:class:`ProviderModel` captures those dynamics as data.  One model
instance drives both execution modes:

* ``ElasticExecutor`` (real clock) sleeps the cold/warm overhead and
  blocks admission beyond ``allowed_concurrency(elapsed)``;
* ``SimPool`` (virtual clock) adds the same overhead to modelled task
  durations and gates virtual starts on the same ramp.

:class:`ContainerFleet` is the shared warm-container bookkeeping: LIFO
reuse (most-recently-released container is the most likely to still be
warm), keep-alive expiry, cold-start counting.  It is clock-agnostic —
callers pass ``now`` from whichever :class:`~repro.core.telemetry.Clock`
owns the pool.

:class:`AutoscalePolicy` is the driver-side elasticity hook:
``run_irregular`` consults it after every completion and calls
``pool.resize`` — growing with frontier pressure (queued tasks),
shrinking when the pool idles — clamped to what the provider ramp has
made available.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

__all__ = ["ProviderModel", "ContainerFleet", "AutoscalePolicy",
           "Backoff"]


class Backoff:
    """Seeded exponential backoff with jitter for admission retries.

    The elastic admission path used to hot-spin at a fixed 100 us poll
    while the provider ramp (or an injected rate-limit storm) withheld
    capacity.  ``next()`` returns the wait before the n-th retry of one
    episode: ``min(cap_s, base_s * factor**n)`` scaled by a uniform
    jitter in ``[0.5, 1.0)`` ("equal jitter" — decorrelates herds of
    blocked submitters without ever collapsing the wait to zero).
    ``reset()`` ends the episode once admission succeeds.

    Jitter comes from a private xorshift64* stream seeded at
    construction, so a given pool's admission schedule is reproducible
    run to run — storm-injection tests converge deterministically.
    """

    def __init__(self, base_s: float = 1e-4, cap_s: float = 0.05,
                 factor: float = 2.0, seed: int = 0) -> None:
        self.base_s = base_s
        self.cap_s = cap_s
        self.factor = factor
        self._state = (seed * 2654435761 + 0x9E3779B97F4A7C15) \
            & 0xFFFFFFFFFFFFFFFF or 0x9E3779B97F4A7C15
        self._n = 0

    def _uniform(self) -> float:
        x = self._state
        x ^= (x << 13) & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 7
        x ^= (x << 17) & 0xFFFFFFFFFFFFFFFF
        self._state = x
        return ((x * 0x2545F4914F6CDD1D) & 0xFFFFFFFFFFFFFFFF) / 2.0**64

    def next(self) -> float:
        """Wait (seconds) before the next retry of the current episode."""
        raw = min(self.cap_s, self.base_s * self.factor ** self._n)
        self._n += 1
        return raw * (0.5 + 0.5 * self._uniform())

    def reset(self) -> None:
        """Admission succeeded — the next episode starts from base."""
        self._n = 0

    @property
    def attempt(self) -> int:
        return self._n


@dataclass(frozen=True)
class ProviderModel:
    """Platform dynamics of a FaaS provider, as data.

    cold_start_s         container provision + runtime init latency
    warm_overhead_s      invocation overhead on a warm container
                         (the paper's 13 ms, Table 4)
    keep_alive_s         idle window before a warm container is
                         reclaimed (AWS: minutes, exact value unpublished)
    burst_concurrency    concurrency available instantly
    scaling_ramp_per_min additional concurrency granted per minute
                         after the burst is consumed (AWS: 500/min)
    invoke_rate_limit    invocations per second (AWS: 10 000/s)
    billing_granularity_s  execution time is rounded up to this
                         (Lambda bills per ms)
    memory_mb            billed container memory (Eq. 5's MB term)
    """

    name: str = "aws-lambda"
    cold_start_s: float = 0.25
    warm_overhead_s: float = 13e-3
    keep_alive_s: float = 600.0
    burst_concurrency: int = 1000
    scaling_ramp_per_min: float = 500.0
    invoke_rate_limit: Optional[float] = 10_000.0
    billing_granularity_s: float = 0.001
    memory_mb: int = 1769

    def overhead_s(self, cold: bool) -> float:
        """Invocation overhead for one attempt."""
        return self.warm_overhead_s + (self.cold_start_s if cold else 0.0)

    def expected_clone_overhead(self, warm_available: bool) -> float:
        """Expected invocation overhead of a *speculative duplicate*:
        with no warm container idle, the clone almost surely lands cold
        and pays the full provision latency before it can even start
        racing the straggler.  The straggler watchdogs add this to their
        deadline so speculation only fires when a (likely cold) clone
        can still win (ROADMAP: provider-aware speculation)."""
        return self.overhead_s(cold=not warm_available)

    def allowed_concurrency(self, elapsed_s: float) -> int:
        """Platform-granted concurrency ``elapsed_s`` after first use:
        the burst plus the per-minute ramp (AWS's 500/min)."""
        if self.scaling_ramp_per_min == float("inf"):
            return 2 ** 31  # effectively unlimited
        ramp = self.scaling_ramp_per_min * max(elapsed_s, 0.0) / 60.0
        return int(self.burst_concurrency + ramp)

    # -- presets -----------------------------------------------------------
    @classmethod
    def aws_lambda(cls, **overrides) -> "ProviderModel":
        """The paper's measured platform (Table 4 + AWS public limits)."""
        return replace(cls(), **overrides) if overrides else cls()

    @classmethod
    def prewarmed(cls, **overrides) -> "ProviderModel":
        """Cold-start-free variant of the same platform — the paper's
        warm-container assumption, and the ablation baseline."""
        return replace(cls(name="aws-lambda-warm", cold_start_s=0.0),
                       **overrides)

    @classmethod
    def gcf(cls, **overrides) -> "ProviderModel":
        """Google Cloud Functions-like dynamics, fitted from synthetic
        traces shaped on the FaaS-benchmarking literature
        (Barcelona-Pons & García-López, PAPERS.md): second-scale cold
        starts, no meaningful burst pool — instances are granted
        gradually (the measured "slow ramp" that dominates GCF
        parallelism) — longer keep-alive, 100 ms billing rounding."""
        return replace(
            cls(name="gcf", cold_start_s=2.2, warm_overhead_s=25e-3,
                keep_alive_s=900.0, burst_concurrency=100,
                scaling_ramp_per_min=120.0, invoke_rate_limit=1000.0,
                billing_granularity_s=0.1, memory_mb=2048),
            **overrides)

    @classmethod
    def azure_functions(cls, **overrides) -> "ProviderModel":
        """Azure Functions (consumption plan)-like dynamics, fitted the
        same way: the slowest cold starts of the big three, ~1 new
        instance/second scale-out (~60/min), ~20 min keep-alive, 100 ms
        minimum execution billing."""
        return replace(
            cls(name="azure-functions", cold_start_s=3.5,
                warm_overhead_s=30e-3, keep_alive_s=1200.0,
                burst_concurrency=200, scaling_ramp_per_min=60.0,
                invoke_rate_limit=2000.0, billing_granularity_s=0.1,
                memory_mb=1536),
            **overrides)

    @classmethod
    def local_vm(cls, **overrides) -> "ProviderModel":
        """A host thread pool dressed as a provider: no cold starts, no
        ramp, thread-spawn-grade overhead (Table 4's 18 us)."""
        return replace(
            cls(name="local-vm", cold_start_s=0.0, warm_overhead_s=18e-6,
                keep_alive_s=float("inf"), burst_concurrency=10_000,
                scaling_ramp_per_min=0.0,
                invoke_rate_limit=None, billing_granularity_s=1.0),
            **overrides)


class ContainerFleet:
    """Warm-container bookkeeping, shared by real and virtual pools.

    ``acquire(now)`` returns ``(container_id, cold)``: a warm container
    if one is idle and within its keep-alive window (LIFO — the most
    recently released is reused first, which is both what platforms do
    and what maximizes warm hits), else a fresh cold one.
    ``release(container_id, now)`` returns it to the idle set.
    """

    def __init__(self, model: ProviderModel) -> None:
        self.model = model
        self._lock = threading.Lock()
        self._idle: List[Tuple[float, int]] = []  # (released_at, id)
        self._ids = itertools.count()
        self.cold_starts = 0
        self.warm_hits = 0
        self.evictions = 0

    def _prune(self, now: float) -> None:
        keep = self.model.keep_alive_s
        self._idle = [(t, cid) for t, cid in self._idle
                      if now - t <= keep]

    def acquire(self, now: float) -> Tuple[int, bool]:
        with self._lock:
            self._prune(now)
            if self._idle:
                _, cid = self._idle.pop()  # LIFO: warmest first
                self.warm_hits += 1
                return cid, False
            self.cold_starts += 1
            return next(self._ids), True

    def release(self, container_id: int, now: float) -> None:
        with self._lock:
            self._idle.append((now, container_id))

    # -- residency hooks (memory-bounded admission, repro.traffic) ---------
    def try_acquire_warm(self, now: float) -> Optional[int]:
        """A warm container or nothing — never provisions.  The
        memory-bounded residency model separates the warm-hit path
        (free) from cold provision (needs a memory grant), so it asks
        for each explicitly instead of using :meth:`acquire`."""
        with self._lock:
            self._prune(now)
            if self._idle:
                _, cid = self._idle.pop()  # LIFO: warmest first
                self.warm_hits += 1
                return cid
            return None

    def oldest_idle_at(self, now: float) -> Optional[float]:
        """Release timestamp of the longest-idle live container (the
        idle-LRU eviction candidate), ``None`` when no idle container
        survives keep-alive.  Non-destructive."""
        keep = self.model.keep_alive_s
        with self._lock:
            live = [t for t, _ in self._idle if now - t <= keep]
            return min(live) if live else None

    def evict_oldest_idle(self, now: float) -> Optional[int]:
        """Deallocate the longest-idle container (FaaS_Sim A1: evict
        idle-LRU to free memory).  Busy containers — including ones
        mid-cold-start — are never in the idle set, so they are
        structurally unevictable (A4).  Returns the evicted id."""
        with self._lock:
            self._prune(now)
            if not self._idle:
                return None
            _, cid = self._idle.pop(0)  # FIFO end: longest idle
            self.evictions += 1
            return cid

    def prune_expired(self, now: float) -> int:
        """Reclaim idle containers past keep-alive; returns how many —
        the residency model frees their memory at this instant."""
        with self._lock:
            before = len(self._idle)
            self._prune(now)
            return before - len(self._idle)

    def idle_ids(self, now: float) -> List[int]:
        """Live idle container ids, longest-idle first (inspection)."""
        keep = self.model.keep_alive_s
        with self._lock:
            return [cid for t, cid in sorted(self._idle)
                    if now - t <= keep]

    def warm_count(self, now: float) -> int:
        """Idle containers still within keep-alive at ``now``.  A pure
        read: unlike :meth:`acquire` it never prunes, so an observer on
        the wrong clock (or peeking at the future) cannot corrupt the
        fleet state."""
        keep = self.model.keep_alive_s
        with self._lock:
            return sum(1 for t, _ in self._idle if now - t <= keep)


@dataclass
class AutoscalePolicy:
    """Driver-side elasticity: grow with the frontier, shrink when idle.

    ``run_irregular`` calls :meth:`decide` after every completion and
    applies the result via ``pool.resize`` (clamped to the provider
    ramp when the pool has one).  The defaults implement the paper's
    inherent-elasticity story: capacity follows the irregular frontier
    up (queued tasks are immediate demand) and decays in the drain
    phase, when pay-as-you-go billing makes idle capacity free to drop.

    min_capacity / max_capacity   resize clamps
    shrink_idle_fraction          shrink once more than this fraction
                                  of capacity sits idle
    shrink_factor                 fraction of the idle surplus released
                                  per decision (gradual drain)
    ewma_alpha                    None = react to instantaneous queue
                                  depth (legacy).  Set (0, 1] to grow on
                                  an exponentially-weighted moving
                                  average of pending instead — spikes
                                  stop triggering a resize per
                                  completion, and demand accumulated
                                  during a cooldown comes out as one
                                  larger step (ROADMAP: most raw grow
                                  decisions used to be clamped away by
                                  the provider ramp).
    grow_cooldown_s /             minimum time between issued grows /
    shrink_cooldown_s             shrinks (hysteresis).  Time is the
                                  driver's clock — virtual on sim pools
                                  — passed as ``decide(..., now=...)``;
                                  without a ``now`` the cooldowns are
                                  inert (back-compat).

    ``resize_log`` journals the (old, new) resizes the driver actually
    *applied* — post-clamp — not raw :meth:`decide` outputs.
    """

    min_capacity: int = 1
    max_capacity: int = 10_000
    shrink_idle_fraction: float = 0.5
    shrink_factor: float = 0.5
    ewma_alpha: Optional[float] = None
    grow_cooldown_s: float = 0.0
    shrink_cooldown_s: float = 0.0
    resize_log: List[Tuple[int, int]] = None

    def __post_init__(self) -> None:
        if self.resize_log is None:
            self.resize_log = []
        if self.ewma_alpha is not None \
                and not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        self._ewma: Optional[float] = None
        self._last_grow_t: Optional[float] = None
        self._last_shrink_t: Optional[float] = None

    def _smoothed_pending(self, pending: int) -> float:
        if self.ewma_alpha is None:
            return float(pending)
        if self._ewma is None:
            self._ewma = float(pending)
        else:
            self._ewma = (self.ewma_alpha * pending
                          + (1.0 - self.ewma_alpha) * self._ewma)
        return self._ewma

    def _cooled(self, last_t: Optional[float], cooldown: float,
                now: Optional[float]) -> bool:
        if now is None or cooldown <= 0.0 or last_t is None:
            return True
        if now < last_t:
            # the clock went backwards: the policy instance moved to a
            # different time domain (wall-clock run, then a virtual
            # replay) — treat the stale stamp as expired rather than
            # freezing resizes for the whole new run
            return True
        return now - last_t >= cooldown

    def decide(self, *, pending: int, idle: int, capacity: int,
               now: Optional[float] = None) -> int:
        """Target capacity given queued demand and idle supply.  The
        caller clamps (provider ramp) and journals what it applies;
        smoothing/cooldown state is the policy's own."""
        demand = self._smoothed_pending(pending)
        # growth needs *live* queued work: a decaying EWMA after a
        # spike must not keep widening an idle pool (the shrink branch
        # takes over as soon as the queue is empty)
        if pending > 0 and demand >= 1.0:
            if not self._cooled(self._last_grow_t, self.grow_cooldown_s,
                                now):
                return capacity
            target = min(self.max_capacity,
                         capacity + int(round(demand)))
            if target != capacity:
                self._last_grow_t = now
            return target
        if idle > self.shrink_idle_fraction * capacity:
            if not self._cooled(self._last_shrink_t,
                                self.shrink_cooldown_s, now):
                return capacity
            surplus = int(idle * self.shrink_factor)
            target = max(self.min_capacity, capacity - surplus)
            if target != capacity:
                self._last_shrink_t = now
            return target
        return capacity
