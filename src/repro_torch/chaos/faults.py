"""Declarative, seeded fault injection for any pool backend.

Real FaaS platforms deliver elasticity with failures attached —
function crashes, whole-container mortality, rate-limit storms and
cold-start stalls are the operating regime, not the exception (Ripple
treats automatic re-execution as a framework feature; Castro et al.
name fault handling as a defining property of serverless).  A
:class:`FaultPlan` describes that regime as data:

    plan = FaultPlan(seed=7, container_mortality=0.30,
                     storms=((5.0, 8.0),), cold_start_multiplier=3.0)
    pool = make_pool("sim", provider=ProviderModel.aws_lambda(),
                     faults=plan)

Every pool backend accepts ``faults=`` and consults the plan's *bound*
form (:meth:`FaultPlan.bind`) at dispatch time:

* ``kills_attempt()`` — should this execution attempt die mid-task?
  Killed attempts land a typed ``worker_killed`` event (plus the
  slot-freeing ``requeue``), destroy their container (the next acquire
  is cold), and are transparently retried up to ``max_kill_attempts``
  times — far above any plausible mortality, so the headline invariant
  holds: **N% mortality changes cost/makespan, never results.**
* ``storm_until(now)`` — is a rate-limit storm window active?  While
  it is, admission is refused and callers back off (``throttled``
  events; see :class:`~repro_torch.core.provider.Backoff`).
* ``cold_start_multiplier`` — inflate provision latency (a slow AZ,
  an image pull storm) without touching the provider preset.

Decisions are *counter-hashed*, not task-id-hashed: the i-th kill
decision a pool makes is a pure function of ``(seed, i)``.  Task ids
come from a process-global counter, so keying on them would make a
benchmark's fault schedule depend on what ran earlier in the process;
the attempt ordinal makes a seeded sim run bit-reproducible wherever
it executes.  The core pools never import this module — they duck-type
against the bound plan — so the dependency arrow stays chaos → core.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional, Tuple

__all__ = ["FaultPlan", "BoundFaults"]

_MASK = 0xFFFFFFFFFFFFFFFF

# salts separating the independent decision streams drawn from one seed
_SALT_KILL_TASK = 0x9E3779B97F4A7C15
_SALT_KILL_BATCH = 0xC2B2AE3D27D4EB4F
_SALT_MORTALITY = 0x165667B19E3779F9
_SALT_STORM_JITTER = 0x27D4EB2F165667C5


def _splitmix64(x: int) -> int:
    """One splitmix64 step — a well-mixed 64-bit hash of ``x``."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK
    return x ^ (x >> 31)


def _unit(seed: int, ordinal: int, salt: int) -> float:
    """Deterministic uniform [0, 1) for decision ``ordinal`` of a
    stream identified by ``(seed, salt)``."""
    h = _splitmix64((seed & _MASK) ^ salt)
    h = _splitmix64(h ^ (ordinal & _MASK))
    return h / 2.0**64


@dataclass(frozen=True)
class FaultPlan:
    """Seeded, declarative description of an injected failure regime.

    seed                   decision-stream seed; same seed + same pool
                           ⇒ same fault schedule, run to run
    kill_task_rate         P(an execution attempt of a plain task dies
                           mid-body)
    kill_batch_rate        P(a fused batch *carrier* attempt dies) —
                           exercises the all-items-requeue path
    container_mortality    P(the attempt's whole container dies) —
                           applies to every attempt, plain or batch,
                           independently of the kill rates; this is the
                           N% knob of the headline invariant
    cold_start_multiplier  scale factor on the provider's cold-start
                           latency (1.0 = as modelled)
    storms                 ``(start_s, end_s)`` windows, in pool time
                           (virtual on sim pools, seconds since first
                           ramp use on wall pools), during which
                           admission is rate-limited and submitters
                           back off
    kill_fraction          fraction of the task body billed before the
                           kill lands (sim pools: a kill costs
                           ``overhead + kill_fraction * duration``)
    max_kill_attempts      retry budget for injected kills — separate
                           from the executor's application-error
                           ``max_attempts`` so mortality alone can
                           never exhaust a task into a terminal
                           :class:`~repro_torch.core.futures.WorkerKilledError`
    """

    seed: int = 0
    kill_task_rate: float = 0.0
    kill_batch_rate: float = 0.0
    container_mortality: float = 0.0
    cold_start_multiplier: float = 1.0
    storms: Tuple[Tuple[float, float], ...] = ()
    kill_fraction: float = 0.5
    max_kill_attempts: int = 25

    def __post_init__(self) -> None:
        for name in ("kill_task_rate", "kill_batch_rate",
                     "container_mortality"):
            v = getattr(self, name)
            # 1.0 is legal: every attempt dies until the retry budget
            # runs out — the deterministic terminal-kill regime
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.cold_start_multiplier < 0.0:
            raise ValueError("cold_start_multiplier must be >= 0")
        if not 0.0 <= self.kill_fraction <= 1.0:
            raise ValueError("kill_fraction must be in [0, 1]")
        if self.max_kill_attempts < 1:
            raise ValueError("max_kill_attempts must be >= 1")
        for w in self.storms:
            if len(w) != 2 or w[0] > w[1]:
                raise ValueError(f"storm window must be (start <= end), "
                                 f"got {w!r}")

    @property
    def any_kills(self) -> bool:
        return (self.kill_task_rate > 0.0 or self.kill_batch_rate > 0.0
                or self.container_mortality > 0.0)

    def bind(self) -> "BoundFaults":
        """A per-pool mutable decision stream over this plan.  Each
        pool binds its own so concurrent pools sharing one plan don't
        interleave (and thereby perturb) each other's ordinals."""
        return BoundFaults(self)


class BoundFaults:
    """One pool's live view of a :class:`FaultPlan`.

    Holds the attempt ordinal (advanced under a lock — thread pools
    decide concurrently) and answers the pool's three questions:
    :meth:`kills_attempt`, :meth:`storm_until`, :meth:`storm_delay`.
    """

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self._lock = threading.Lock()
        self._ordinal = 0
        #: injected-kill retry budget (executors read this instead of
        #: their application ``max_attempts`` for killed attempts)
        self.retry_budget = plan.max_kill_attempts
        #: decisions taken / kills issued (inspection + tests)
        self.decisions = 0
        self.kills = 0

    # -- kill stream ---------------------------------------------------
    def kills_attempt(self, batch: bool = False) -> bool:
        """Should the attempt now starting die mid-body?  Draws one
        ordinal from the stream: kill when the task/batch kill rate
        *or* the container-mortality rate fires (independent salts, so
        a plan combining both composes sensibly)."""
        plan = self.plan
        with self._lock:
            i = self._ordinal
            self._ordinal += 1
            self.decisions += 1
        rate = plan.kill_batch_rate if batch else plan.kill_task_rate
        salt = _SALT_KILL_BATCH if batch else _SALT_KILL_TASK
        kill = (rate > 0.0 and _unit(plan.seed, i, salt) < rate)
        if not kill and plan.container_mortality > 0.0:
            kill = (_unit(plan.seed, i, _SALT_MORTALITY)
                    < plan.container_mortality)
        if kill:
            with self._lock:
                self.kills += 1
        return kill

    # -- storms --------------------------------------------------------
    def storm_until(self, now: float) -> Optional[float]:
        """End of the storm window covering ``now``, else ``None``."""
        for start, end in self.plan.storms:
            if start <= now < end:
                return end
        return None

    def storm_delay(self, now: float) -> float:
        """Extra admission latency while a storm covers ``now``: the
        time left in the window plus a small deterministic jitter (so
        co-released tasks don't restart in lockstep).  0.0 outside any
        storm."""
        end = self.storm_until(now)
        if end is None:
            return 0.0
        with self._lock:
            i = self._ordinal
            self._ordinal += 1
        jitter = _unit(self.plan.seed, i, _SALT_STORM_JITTER)
        return (end - now) + jitter * 1e-3

    # -- cold starts ---------------------------------------------------
    def extra_cold_start(self, provider: Optional[object]) -> float:
        """Additional provision latency injected on a *cold* acquire
        (beyond what the provider already models)."""
        mult = self.plan.cold_start_multiplier
        if provider is None or mult == 1.0:
            return 0.0
        return (mult - 1.0) * provider.cold_start_s
