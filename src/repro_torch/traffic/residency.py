"""Memory-bounded container residency & admission.

FaaS_Sim (SNIPPETS.md, Snippet 1) reduces serverless request handling
to five assumptions; this module implements them over the existing
:class:`~repro_torch.core.provider.ContainerFleet` /
:class:`~repro_torch.core.provider.ProviderModel` instead of duplicating
their warm/cold bookkeeping:

A0  host memory starts empty — per-tenant fleets are created lazily and
    begin with no resident containers;
A1  when memory is needed for a new container, the *longest-idle* idle
    container (across all tenants) is deallocated; if no container is
    idle, the request is **lost** (``no_memory``);
A2  a request to a tenant already running at its concurrency cap is
    **lost** (``busy``);
A3  requests landing while the tenant's capacity is tied up in a cold
    start are **lost** (``cold_blocked``) — only the triggering request
    blocks on the provision;
A4  containers are never deallocated mid-cold-start — busy containers
    (cold ones included) are structurally absent from the fleets' idle
    sets, so eviction cannot reach them;
A5  a served request costs its service time plus, when cold, the
    provider's cold-start latency — reported per admission as
    ``overhead_s`` for the harness to add to the modelled duration.

The model is clock-agnostic like the fleet it wraps: callers pass
``now`` from whichever clock owns the run (virtual for ``SimPool``,
monotonic for wall-clock serving).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from ..core.provider import ContainerFleet, ProviderModel

__all__ = ["ResidencyConfig", "Admission", "ResidencyModel"]

#: loss reasons (stable strings — they key report dicts and tests)
LOST_BUSY = "busy"                # A2
LOST_COLD_BLOCKED = "cold_blocked"  # A3
LOST_NO_MEMORY = "no_memory"      # A1


@dataclass(frozen=True)
class ResidencyConfig:
    """Host limits the admission decisions are made against.

    memory_capacity_mb   total container memory on the host (the A1
                         bound); ``inf`` disables the memory gate
    container_mb         per-container footprint; ``None`` uses the
                         provider's billed ``memory_mb``
    max_per_tenant       concurrent containers a tenant may hold
                         (FaaS_Sim's one-container-per-function is
                         ``max_per_tenant=1``); ``None`` = unbounded
    """

    memory_capacity_mb: float = float("inf")
    container_mb: Optional[float] = None
    max_per_tenant: Optional[int] = None

    def footprint_mb(self, provider: ProviderModel) -> float:
        return (self.container_mb if self.container_mb is not None
                else float(provider.memory_mb))


@dataclass(frozen=True)
class Admission:
    """Outcome of one :meth:`ResidencyModel.admit` call."""

    kind: str                   # "warm" | "cold" | "lost"
    tenant: str
    cid: Optional[int] = None
    reason: Optional[str] = None   # loss reason when kind == "lost"
    overhead_s: float = 0.0        # invocation overhead to add (A5)

    @property
    def lost(self) -> bool:
        return self.kind == "lost"


@dataclass
class ResidencyModel:
    """A0–A5 admission over per-tenant :class:`ContainerFleet` s."""

    provider: ProviderModel
    config: ResidencyConfig = field(default_factory=ResidencyConfig)

    def __post_init__(self) -> None:
        self.fleets: Dict[str, ContainerFleet] = {}   # lazy: A0
        self._busy: Dict[str, int] = {}
        #: (tenant, cid) -> virtual/wall time the cold provision ends
        self._cold_until: Dict[tuple, float] = {}
        self.admitted_warm = 0
        self.admitted_cold = 0
        self.lost: Dict[str, int] = {LOST_BUSY: 0, LOST_COLD_BLOCKED: 0,
                                     LOST_NO_MEMORY: 0}

    # -- accounting --------------------------------------------------------
    def busy_count(self, tenant: Optional[str] = None) -> int:
        if tenant is not None:
            return self._busy.get(tenant, 0)
        return sum(self._busy.values())

    def idle_count(self, now: float) -> int:
        return sum(f.warm_count(now) for f in self.fleets.values())

    def resident_mb(self, now: float) -> float:
        """Memory held at ``now``: every busy container (cold ones
        included — A4 keeps them resident) plus every live idle one."""
        n = self.busy_count() + self.idle_count(now)
        return n * self.config.footprint_mb(self.provider)

    def _prune_all(self, now: float) -> None:
        for f in self.fleets.values():
            f.prune_expired(now)

    def _tenant_in_cold_start(self, tenant: str, now: float) -> bool:
        return any(t == tenant and now < until
                   for (t, _), until in self._cold_until.items())

    # -- the A0–A5 decision ------------------------------------------------
    def admit(self, tenant: str, now: float) -> Admission:
        """Admit, or lose, one request arriving at ``now``."""
        self._prune_all(now)   # keep-alive expiry frees memory first
        fleet = self.fleets.get(tenant)
        if fleet is None:
            fleet = self.fleets[tenant] = ContainerFleet(self.provider)

        # warm hit: free, no memory motion
        cid = fleet.try_acquire_warm(now)
        if cid is not None:
            self._busy[tenant] = self._busy.get(tenant, 0) + 1
            self.admitted_warm += 1
            return Admission("warm", tenant, cid=cid,
                             overhead_s=self.provider.overhead_s(False))

        # A2 / A3: tenant at its concurrency cap
        cap = self.config.max_per_tenant
        if cap is not None and self._busy.get(tenant, 0) >= cap:
            reason = (LOST_COLD_BLOCKED
                      if self._tenant_in_cold_start(tenant, now)
                      else LOST_BUSY)
            self.lost[reason] += 1
            return Admission("lost", tenant, reason=reason)

        # A1: make memory room for a cold container, evicting the
        # longest-idle idle container anywhere; no idle => lost
        mb = self.config.footprint_mb(self.provider)
        while self.resident_mb(now) + mb > self.config.memory_capacity_mb:
            victim_fleet = None
            victim_t = None
            for f in self.fleets.values():
                t = f.oldest_idle_at(now)
                if t is not None and (victim_t is None or t < victim_t):
                    victim_fleet, victim_t = f, t
            if victim_fleet is None:
                self.lost[LOST_NO_MEMORY] += 1
                return Admission("lost", tenant, reason=LOST_NO_MEMORY)
            victim_fleet.evict_oldest_idle(now)

        # cold provision (A5: the triggering request pays the latency)
        cid, cold = fleet.acquire(now)
        assert cold, "no idle container can exist here (warm path above)"
        self._busy[tenant] = self._busy.get(tenant, 0) + 1
        self._cold_until[(tenant, cid)] = now + self.provider.cold_start_s
        self.admitted_cold += 1
        return Admission("cold", tenant, cid=cid,
                         overhead_s=self.provider.overhead_s(True))

    def release(self, tenant: str, cid: int, now: float) -> None:
        """Request finished: its container goes idle (evictable again)."""
        self._busy[tenant] = max(0, self._busy.get(tenant, 0) - 1)
        self._cold_until.pop((tenant, cid), None)
        self.fleets[tenant].release(cid, now)

    def snapshot(self, now: float) -> dict:
        return {
            "admitted_warm": self.admitted_warm,
            "admitted_cold": self.admitted_cold,
            "lost": dict(self.lost),
            "busy": self.busy_count(),
            "idle": self.idle_count(now),
            "resident_mb": self.resident_mb(now),
            "evictions": sum(f.evictions for f in self.fleets.values()),
        }
