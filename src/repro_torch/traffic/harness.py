"""Open-loop serving harness over the elastic pool stack.

Two drivers share the workload stream:

* :func:`serve_open_loop` — the virtual-time path.  Each request is
  admitted through the :class:`~repro_torch.traffic.residency.ResidencyModel`
  (A0–A5) at its exact virtual arrival instant (``SimPool.run_until``),
  served as a modelled prefill+decode duration, and every
  submit/cold_start/start/complete lands on the pool's shared
  :class:`~repro_torch.core.telemetry.EventLog` — so a serving run records
  into a ``TraceStore``, replays through ``repro_torch.trace.replay`` with
  arrivals honoured, and is billed by the same cost model as every
  other pool, unchanged.
* :func:`drive_batcher_open_loop` — the wall-clock path: the same
  stream paced on the real clock into an
  :class:`~repro_torch.serving.elastic_batcher.ElasticBatcher` (sim or
  card-side engine), for serving with actual compute.

TTFT here is the full user-visible latency: queue delay (capacity
pressure) + cold-start/warm overhead (residency) + prefill + the first
decode step (engine).  The knee a rate sweep looks for is the arrival
rate where the queue-delay term stops being ~0.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from ..core.costmodel import provisioned_cost, serverless_cost
from ..core.provider import AutoscalePolicy, ProviderModel
from ..core.simpool import SimPool
from ..core.telemetry import PARENT_ROOT, SUBMIT
from .residency import Admission, ResidencyConfig, ResidencyModel
from .slo import p_quantile
from .workload import TrafficRequest

__all__ = ["EngineModel", "ServingReport", "serve_open_loop",
           "drive_batcher_open_loop"]


@dataclass(frozen=True)
class EngineModel:
    """Analytic decode-engine costs for the virtual-time path (the
    serving counterpart of ``SimPool``'s ``alpha_s_per_node``):
    prefill is linear in prompt tokens, decode linear in generated
    tokens.  Defaults mirror ``SimEngine``'s host constants."""

    prefill_s_per_token: float = 1e-5
    decode_s_per_token: float = 1e-4

    def service_s(self, req: TrafficRequest) -> float:
        return (req.prompt_len * self.prefill_s_per_token
                + req.decode_len * self.decode_s_per_token)

    def first_token_s(self, req: TrafficRequest) -> float:
        """Prefill + one decode step — the service part of TTFT."""
        return (req.prompt_len * self.prefill_s_per_token
                + self.decode_s_per_token)


@dataclass
class ServingReport:
    """What one open-loop serving run produced."""

    n_requests: int
    completed: int
    lost: Dict[str, int]
    ttft_p50_s: float
    ttft_p99_s: float
    makespan_s: float
    tokens: int
    serverless_usd: float
    provisioned_usd: float
    cost_per_token_usd: float
    peak_capacity: int
    cold_starts: int
    evictions: int
    resizes: int
    residency: Dict[str, Any] = field(default_factory=dict)

    @property
    def loss_rate(self) -> float:
        n_lost = sum(self.lost.values())
        return n_lost / self.n_requests if self.n_requests else 0.0

    def as_dict(self) -> dict:
        return {
            "requests": self.n_requests, "completed": self.completed,
            "lost": dict(self.lost), "loss_rate": self.loss_rate,
            "ttft_p50_s": self.ttft_p50_s, "ttft_p99_s": self.ttft_p99_s,
            "makespan_s": self.makespan_s, "tokens": self.tokens,
            "serverless_usd": self.serverless_usd,
            "provisioned_usd": self.provisioned_usd,
            "cost_per_token_usd": self.cost_per_token_usd,
            "peak_capacity": self.peak_capacity,
            "cold_starts": self.cold_starts,
            "evictions": self.evictions, "resizes": self.resizes,
        }


def _identity(req: TrafficRequest) -> TrafficRequest:
    return req


def serve_open_loop(
    stream: Sequence[TrafficRequest],
    *,
    engine: Optional[EngineModel] = None,
    provider: Optional[ProviderModel] = None,
    residency_cfg: Optional[ResidencyConfig] = None,
    capacity: int = 8,
    autoscale: Optional[AutoscalePolicy] = None,
    trace=None,
) -> ServingReport:
    """Serve ``stream`` open-loop on a virtual-time pool.

    The pool itself runs provider-less with zero invoke overhead: the
    residency model owns cold/warm dynamics (A0–A5) and its admission
    overhead is folded into each request's modelled duration, so
    platform effects are charged exactly once.  ``capacity`` is the
    initial (or, without ``autoscale``, the static) slot count;
    ``trace`` is any EventLog-compatible sink (a spill-to-disk
    ``TraceStore`` works — the whole run records and replays).
    Deterministic: same stream + same knobs -> bit-identical report.
    """
    engine = engine or EngineModel()
    provider = provider or ProviderModel.aws_lambda()
    residency = ResidencyModel(provider,
                               residency_cfg or ResidencyConfig())
    pool = SimPool(max_concurrency=capacity, invoke_overhead=0.0,
                   duration_fn=lambda task, req: req.service_s,
                   trace=trace, name="serve-sim")
    inflight: List[tuple] = []   # (future, request, admission)
    served: List[TrafficRequest] = []
    lost: List[TrafficRequest] = []
    ttfts: List[float] = []
    resizes = 0

    def retire_done() -> None:
        # release containers / observe TTFTs at each task's recorded
        # end instant; processing in end-time order keeps residency
        # state identical to a fully interleaved execution
        done = [e for e in inflight if e[0].done()]
        if not done:
            return
        done.sort(key=lambda e: e[0]._task.end_time)
        for entry in done:
            fut, req, adm = entry
            inflight.remove(entry)
            task = fut._task
            residency.release(req.tenant, adm.cid, task.end_time)
            queue_delay = max(0.0, (task.start_time or 0.0)
                              - (task.submit_time or 0.0))
            req.ttft_s = (queue_delay + adm.overhead_s
                          + engine.first_token_s(req))
            ttfts.append(req.ttft_s)
            served.append(req)
            if autoscale is not None:
                observe = getattr(autoscale, "observe_ttft", None)
                if observe is not None:
                    observe(req.ttft_s, now=task.end_time)

    def apply_autoscale(now: float) -> None:
        nonlocal resizes
        if autoscale is None:
            return
        target = autoscale.decide(
            pending=pool.pending(), idle=pool.idle_capacity(),
            capacity=pool.max_concurrency, now=now)
        target = max(1, min(target, provider.allowed_concurrency(now)))
        if target != pool.max_concurrency:
            autoscale.resize_log.append((pool.max_concurrency, target))
            pool.resize(target)
            resizes += 1

    for req in sorted(stream, key=lambda r: (r.arrival_s, r.rid)):
        pool.run_until(req.arrival_s)
        retire_done()
        adm = residency.admit(req.tenant, req.arrival_s)
        if adm.lost:
            req.lost = adm.reason
            lost.append(req)
            # the arrival still happened: record it (task-id-less, so
            # replay extraction skips it but the loss is on the trace)
            pool.stats.log.emit(SUBMIT, task_id=None, worker=req.tenant,
                                parent=PARENT_ROOT)
        else:
            req.cold = adm.kind == "cold"
            req.service_s = adm.overhead_s + engine.service_s(req)
            fut = pool.submit(
                _identity, req,
                cost_hint=float(req.prompt_len + req.decode_len),
                parent=PARENT_ROOT)
            if req.cold:
                pool.stats.on_cold_start(fut._task.task_id,
                                         fut._task.worker or pool.name)
            inflight.append((fut, req, adm))
        apply_autoscale(req.arrival_s)

    # drain: completions keep driving the clock (and the autoscaler —
    # this is where an SLO policy gives surplus capacity back)
    while True:
        nxt = pool.next_event_t()
        if nxt is None:
            break
        pool.run_until(nxt)
        retire_done()
        apply_autoscale(nxt)
    makespan = pool.clock.now()
    pool.shutdown(wait=True)

    cap_series = pool.events.capacity_series()
    sls = serverless_cost(pool.events, wall_time_s=makespan,
                          provider=provider)
    prov = provisioned_cost(cap_series, end_t=makespan)
    tokens = sum(r.prompt_len + r.decode_len for r in served)
    loss_counts = dict(residency.lost)
    return ServingReport(
        n_requests=len(stream),
        completed=len(served),
        lost=loss_counts,
        ttft_p50_s=p_quantile(ttfts, 0.50),
        ttft_p99_s=p_quantile(ttfts, 0.99),
        makespan_s=makespan,
        tokens=tokens,
        serverless_usd=sls.total,
        provisioned_usd=prov.total,
        cost_per_token_usd=(prov.total / tokens) if tokens else 0.0,
        peak_capacity=max((c for _, c in cap_series), default=capacity),
        cold_starts=residency.admitted_cold,
        evictions=sum(f.evictions for f in residency.fleets.values()),
        resizes=resizes,
        residency=residency.snapshot(makespan),
    )


def drive_batcher_open_loop(batcher, stream: Sequence[TrafficRequest],
                            *, time_scale: float = 1.0,
                            max_rounds: int = 1_000_000) -> Dict[str, Any]:
    """Pace ``stream`` into an ``ElasticBatcher`` on the real clock.

    ``time_scale`` compresses the arrival timeline (scale 10 serves a
    60 s trace in ~6 s of wall time) — the engine still pays its true
    compute per token, only the *gaps* shrink.  Returns the batcher's
    own report with open-loop fields added."""
    from ..serving.elastic_batcher import Request

    pending = deque(sorted(stream, key=lambda r: (r.arrival_s, r.rid)))
    t0 = time.monotonic()
    rounds = 0
    submitted = 0
    while (pending or batcher.queue or any(batcher.slots)) \
            and rounds < max_rounds:
        elapsed = (time.monotonic() - t0) * time_scale
        while pending and pending[0].arrival_s <= elapsed:
            req = pending.popleft()
            batcher.submit(Request(rid=req.rid,
                                   prompt_len=req.prompt_len,
                                   max_new_tokens=req.decode_len))
            submitted += 1
        if batcher.queue or any(batcher.slots):
            batcher.step()
        elif pending:
            # idle until the next arrival is due (scaled)
            wait = (pending[0].arrival_s - elapsed) / time_scale
            time.sleep(min(max(wait, 0.0), 0.01))
        rounds += 1
    wall = time.monotonic() - t0
    report = batcher.report(wall, rounds)
    report["open_loop"] = True
    report["submitted"] = submitted
    report["time_scale"] = time_scale
    return report
