"""Cost model (paper §4.3 Eq. 3-7, §6 Eq. 8, Table 3 prices).

    Cost_serverless = Cost_invocations + Cost_execution + Cost_client   (3)
    Cost_invocations = lambda_i * n                                     (4)
    Cost_execution   = lambda_e * (MB/1024) * sum_i t_i                 (5)
    Cost_client      = VM_price/3600 * t_total                          (6)
    R_price_perf     = Throughput / Cost                                (7)
    Cost_EMR         = t/3600 * (workers*worker_price + master_price)   (8)

The same accounting generalizes to TPU device-seconds (``TPUPrice``): a
pod slice billed per chip-hour is the "VM", an elastic slice acquired per
task is the "function".  This is what makes the paper's cost-performance
methodology portable to the pod framework.

Billing reads the unified execution timeline: pass a pool's
:class:`~repro.core.telemetry.EventLog` (``pool.events``) straight to
:func:`serverless_cost` — completion records, attempt counts, and cold
starts all come from the same event history the run produced (a plain
``TaskRecord`` iterable is still accepted).  A
:class:`~repro.core.provider.ProviderModel` supplies the billing
granularity and container memory, so real and simulated runs under the
same model are invoiced identically.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Union

from .futures import TaskRecord
from .provider import ProviderModel
from .telemetry import EventLog

__all__ = [
    "LambdaPrice", "VMPrice", "TPUPrice", "CostReport",
    "serverless_cost", "vm_cost", "emr_cluster_cost",
    "price_performance", "provisioned_cost", "SLOT_HOUR_USD",
]

# -- Table 3 -----------------------------------------------------------------
LAMBDA_INVOCATION_PRICE = 0.0000002        # $ / invocation  (lambda_i)
LAMBDA_GBS_PRICE = 0.0000166667            # $ / GB-second   (lambda_e)
VM_PRICES = {                               # $ / hour, on-demand
    "m5.xlarge": 0.192,
    "m5.2xlarge": 0.384,
    "c5.2xlarge": 0.34,
    "c5.9xlarge": 1.53,
    "c5.12xlarge": 2.04,
    "c5.18xlarge": 3.06,
    "c5.24xlarge": 4.08,
    "c5.24xlarge-emr": 4.35,               # EMR on-demand (Eq. 8)
    "m5.2xlarge-emr": 0.48,                # EMR master (Eq. 8)
}
TPU_V5E_CHIP_HOUR = 1.20                    # $/chip-hour, on-demand list


@dataclass(frozen=True)
class LambdaPrice:
    invocation: float = LAMBDA_INVOCATION_PRICE
    gb_second: float = LAMBDA_GBS_PRICE
    memory_mb: int = 1769  # ~1 full vCPU per AWS docs (paper §4.4)


@dataclass(frozen=True)
class VMPrice:
    hourly: float

    @classmethod
    def named(cls, name: str) -> "VMPrice":
        return cls(hourly=VM_PRICES[name])


@dataclass(frozen=True)
class TPUPrice:
    chip_hourly: float = TPU_V5E_CHIP_HOUR
    chips: int = 256


@dataclass
class CostReport:
    invocations: float = 0.0
    execution: float = 0.0
    client: float = 0.0

    @property
    def total(self) -> float:
        return self.invocations + self.execution + self.client

    def as_dict(self) -> dict:
        return {
            "invocations_usd": self.invocations,
            "execution_usd": self.execution,
            "client_usd": self.client,
            "total_usd": self.total,
        }


def serverless_cost(
    records: Union[EventLog, Iterable[TaskRecord]],
    *,
    wall_time_s: float,
    price: Optional[LambdaPrice] = None,
    client_vm: Optional[VMPrice] = None,
    billing_granularity_s: Optional[float] = None,
    provider: Optional[ProviderModel] = None,
) -> CostReport:
    """Eq. 3-6 over an execution timeline (or raw completion records).

    Only *remote* records are billed as invocations/execution; the client
    VM is billed for the whole wall time (the master runs throughout).
    Every attempt — retries, cold starts, speculated duplicates — is a
    separate invoice line, exactly as the platform would bill it.  A
    ``provider`` model supplies the billing granularity and container
    memory unless explicitly overridden.

    Accounting is a single streaming pass: an ``EventLog`` is consumed
    through ``iter_records`` (spill-backed ``TraceStore`` timelines are
    invoiced without ever materializing the record list), and any plain
    iterable of ``TaskRecord`` works the same way.
    """
    if isinstance(records, EventLog):
        records = records.iter_records()
    if price is None:
        price = (LambdaPrice(memory_mb=provider.memory_mb)
                 if provider is not None else LambdaPrice())
    if billing_granularity_s is None:
        billing_granularity_s = (provider.billing_granularity_s
                                 if provider is not None else 0.001)
    n = 0          # every attempt is an invocation
    billed = 0.0   # granularity-rounded execution seconds
    for r in records:
        if not r.remote:
            continue
        n += r.attempts
        billed += max(billing_granularity_s,
                      _ceil_to(r.duration, billing_granularity_s)) \
            * r.attempts
    gb = price.memory_mb / 1024.0
    client = client_vm or VMPrice.named("m5.xlarge")
    return CostReport(
        invocations=price.invocation * n,
        execution=price.gb_second * gb * billed,
        client=client.hourly / 3600.0 * wall_time_s,
    )


def _ceil_to(x: float, g: float) -> float:
    import math
    return math.ceil(x / g) * g


#: $/slot-hour for provisioned serving capacity: a c5.24xlarge vCPU's
#: share of its on-demand price.  Used by the serving harness to bill
#: the capacity *staircase* — what the operator pays for slots held up,
#: busy or not — which is what an SLO autoscaler actually saves vs a
#: statically peak-sized pool (per-invocation Eq. 4-5 billing is
#: capacity-independent, so it cannot see the difference).
SLOT_HOUR_USD = VM_PRICES["c5.24xlarge"] / 96


def provisioned_cost(
    capacity_series: Iterable,
    *,
    end_t: float,
    slot_hourly_usd: float = SLOT_HOUR_USD,
) -> CostReport:
    """Integrate a ``(t, capacity)`` staircase up to ``end_t`` and bill
    the slot-seconds at ``slot_hourly_usd``.

    ``capacity_series`` is what every pool's timeline already exposes
    (``pool.events.capacity_series()`` — the initial width announcement
    plus every resize), so autoscaled and static runs are billed from
    the same artifact.  Timestamps after ``end_t`` are clipped."""
    series = [(t, c) for t, c in capacity_series if t <= end_t]
    slot_seconds = 0.0
    for i, (t, cap) in enumerate(series):
        t_next = series[i + 1][0] if i + 1 < len(series) else end_t
        slot_seconds += cap * max(0.0, min(t_next, end_t) - t)
    return CostReport(client=slot_seconds / 3600.0 * slot_hourly_usd)


def vm_cost(wall_time_s: float, vm: VMPrice,
            minimum_billing_s: float = 1.0) -> CostReport:
    """On-demand VM cost (Table 6 note: 1 s minimum billing period)."""
    t = max(wall_time_s, minimum_billing_s)
    return CostReport(client=vm.hourly / 3600.0 * t)


def emr_cluster_cost(wall_time_s: float, *, workers: int,
                     worker: VMPrice = VMPrice.named("c5.24xlarge-emr"),
                     master: VMPrice = VMPrice.named("m5.2xlarge-emr"),
                     ) -> CostReport:
    """Eq. 8 — Spark/EMR cluster."""
    hourly = workers * worker.hourly + master.hourly
    return CostReport(client=hourly / 3600.0 * wall_time_s)


def tpu_slice_cost(wall_time_s: float, price: TPUPrice) -> CostReport:
    """Device-seconds accounting for a pod slice (framework-side)."""
    return CostReport(client=price.chips * price.chip_hourly / 3600.0
                      * wall_time_s)


def price_performance(throughput: float, cost: CostReport) -> float:
    """Eq. 7 — throughput per dollar (M nodes/s/$, MP/s/$, tok/s/$...)."""
    if cost.total <= 0:
        return float("inf")
    return throughput / cost.total
