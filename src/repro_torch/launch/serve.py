"""Serving entry point: elastic continuous batching over a card-side engine.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch gemma3-1b --requests 16 --slots 4 --max-seq 256

Counterpart of ``repro.launch.serve``: the ElasticBatcher (the paper's
executor + §5.2 controller) schedules heavy-tailed requests over
:class:`TorchEngine`, whose slot-batched decode runs the model on the
card (``device=None``) or, when asked, on the CPU.  As in the reference,
the batcher's prefill chunks are counted, not computed.

Open-loop traffic (``repro_torch.traffic``) plugs in two ways:

* ``--rate R`` paces arrivals onto the *real* engine on the wall clock
  (``drive_batcher_open_loop``) instead of submitting everything up
  front;
* ``--sim`` skips the engine entirely and serves the same stream on the
  virtual-time harness under a ``--provider`` preset — seconds of wall
  time for minutes of modelled traffic, with SLO autoscale via
  ``--slo-ttft``.  It touches no tensor.

Either way ``--trace PATH`` spills the run's full event timeline to a
JSONL ``TraceStore`` for the record -> replay -> what-if loop.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..core.provider import ProviderModel
from ..device import DeviceLike, resolve_device
from ..models import decode_step, init_cache, init_params
from ..serving.elastic_batcher import BatcherConfig, ElasticBatcher, Request
from ..traffic import (ArrivalModel, LengthModel, SLOAutoscalePolicy,
                       TenantSpec, drive_batcher_open_loop, generate_stream,
                       load_stream, serve_open_loop)

__all__ = ["PROVIDER_PRESETS", "TorchEngine", "serve", "serve_traffic_sim",
           "main"]

#: ``--provider`` preset name -> ProviderModel factory
PROVIDER_PRESETS = {
    "aws_lambda": ProviderModel.aws_lambda,
    "prewarmed": ProviderModel.prewarmed,
    "gcf": ProviderModel.gcf,
    "azure_functions": ProviderModel.azure_functions,
    "local_vm": ProviderModel.local_vm,
}


class TorchEngine:
    """Real decode engine: one KV cache arena, slot-batched decode.

    Weights are random from seed 0, as the reference's from
    ``PRNGKey(0)`` (the numbers differ; the shapes are the same).  Decoding always runs the full [n_slots] batch (inactive slots are
    masked by position), as the reference's jitted step does.  Prefill
    chunks are counted only, exactly as ``JaxEngine.prefill_chunk``.
    A model with no attention layer (rwkv6) runs the same way.  A slot is
    never reset: a recurrent layer's state (and its shifted input) goes
    on from whatever ran in that slot before, the previous request's and
    the idle steps' included, as in ``JaxEngine``, which also never resets
    a slot.
    """

    def __init__(self, cfg, n_slots: int, max_seq: int, *,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.params = init_params(cfg, 0, device=self.device)
        self.cache = init_cache(cfg, n_slots, max_seq, device=self.device)
        self.pos = np.zeros((n_slots,), np.int32)
        self.tokens = np.zeros((n_slots, 1), np.int32)
        self.prefill_tokens = 0
        self.decode_steps = 0

    # batcher engine interface ------------------------------------------------
    def prefill_chunk(self, tokens: int) -> None:
        self.prefill_tokens += tokens

    def decode(self, n_active: int) -> None:
        if self.cfg.frontend is None:
            batch = {"tokens": torch.from_numpy(self.tokens).to(
                self.device, torch.long)}
        else:
            # a frontend stub's step input: zero embeddings, as the
            # reference's engine feeds
            batch = {"embeds": torch.zeros(
                (self.n_slots, 1, self.cfg.d_model), dtype=torch.bfloat16,
                device=self.device)}
        pos = torch.from_numpy(self.pos).to(self.device, torch.long)
        with torch.inference_mode():
            logits, self.cache = decode_step(self.cfg, self.params,
                                             self.cache, batch, pos)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        self.tokens = nxt[:, None] % self.cfg.vocab_size
        self.pos = np.minimum(self.pos + 1, self.max_seq - 1)
        self.decode_steps += 1


def _tenant_mix(n_tenants: int, arrival: str, rate: float,
                max_seq: int) -> list:
    """``n_tenants`` heterogeneous tenants sharing the offered load:
    poisson chat-like tenants plus (for mmpp) a bursty one."""
    per = rate / max(1, n_tenants)
    tenants = []
    for i in range(n_tenants):
        bursty = arrival == "mmpp" and i == n_tenants - 1
        tenants.append(TenantSpec(
            name=f"tenant{i}",
            arrival=ArrivalModel(kind="mmpp" if bursty else "poisson",
                                 rate=per, burst_rate=4 * per),
            prompt_len=LengthModel(mean=33.0 * (1 + i % 3), sigma=1.0,
                                   lo=4, hi=max(8, max_seq // 2)),
            decode_len=LengthModel(mean=12.0, sigma=0.8, lo=2,
                                   hi=max(4, max_seq // 4))))
    return tenants


def serve(arch: str, *, smoke: bool = True, n_requests: int = 32,
          n_slots: int = 4, max_seq: int = 256, seed: int = 0,
          adaptive: bool = True, rate: Optional[float] = None,
          n_tenants: int = 1, arrival: str = "poisson",
          arrival_trace: Optional[str] = None,
          trace: Optional[str] = None,
          time_scale: float = 1.0, device: DeviceLike = None) -> dict:
    """Serve on the real engine, on ``device`` (the CUDA card by default).

    Default is the closed loop: ``n_requests`` heavy-tailed requests
    submitted up front (the reference's stream for the same ``seed``).
    With ``rate`` (req/s, or ``arrival_trace`` pointing at a saved JSONL
    stream) the same engine is driven *open-loop* on the wall clock;
    ``time_scale`` compresses the arrival gaps.  ``trace`` spills the
    run's event timeline to a JSONL ``TraceStore`` at that path."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    engine = TorchEngine(cfg, n_slots, max_seq, device=device)
    store = None
    if trace is not None:
        from ..trace import TraceStore
        store = TraceStore(path=trace)
    batcher = ElasticBatcher(engine, BatcherConfig(
        n_slots=n_slots, adaptive=adaptive), trace=store)
    try:
        if rate is None and arrival_trace is None:
            rng = np.random.RandomState(seed)
            for i in range(n_requests):
                plen = int(np.clip(rng.lognormal(3.5, 1.0), 4,
                                   max_seq // 2))
                new = int(np.clip(rng.lognormal(2.5, 0.8), 2,
                                  max_seq // 4))
                batcher.submit(Request(rid=i, prompt_len=plen,
                                       max_new_tokens=new))
            report = batcher.run()
        else:
            if arrival_trace is not None:
                stream = load_stream(arrival_trace)
            else:
                horizon = n_requests / max(rate, 1e-9)
                stream = generate_stream(
                    _tenant_mix(n_tenants, arrival, rate, max_seq),
                    horizon_s=horizon, seed=seed)
            report = drive_batcher_open_loop(batcher, stream,
                                             time_scale=time_scale)
    finally:
        if store is not None:
            store.close(delete=False)
    report["engine_decode_steps"] = engine.decode_steps
    report["arch"] = cfg.name
    report["device"] = str(engine.device)
    return report


def serve_traffic_sim(*, provider: str = "aws_lambda", rate: float = 4.0,
                      n_tenants: int = 2, arrival: str = "poisson",
                      horizon_s: float = 60.0, seed: int = 0,
                      capacity: int = 8, max_seq: int = 256,
                      slo_ttft_s: Optional[float] = None,
                      arrival_trace: Optional[str] = None,
                      trace: Optional[str] = None) -> dict:
    """Serve the synthetic stream on the virtual-time harness — no
    engine, no tensor: minutes of modelled traffic in milliseconds, under
    a real provider preset, optionally autoscaled to a p99 TTFT SLO."""
    if arrival_trace is not None:
        stream = load_stream(arrival_trace)
    else:
        stream = generate_stream(
            _tenant_mix(n_tenants, arrival, rate, max_seq),
            horizon_s=horizon_s, seed=seed)
    autoscale = None
    if slo_ttft_s is not None:
        autoscale = SLOAutoscalePolicy(
            min_capacity=1, max_capacity=max(64, 4 * capacity),
            target_p99_ttft_s=slo_ttft_s,
            grow_cooldown_s=0.25, shrink_cooldown_s=2.0)
    store = None
    if trace is not None:
        from ..trace import TraceStore
        store = TraceStore(path=trace)
    try:
        rep = serve_open_loop(
            stream, provider=PROVIDER_PRESETS[provider](),
            capacity=capacity, autoscale=autoscale, trace=store)
    finally:
        if store is not None:
            store.close(delete=False)
    out = rep.as_dict()
    out["provider"] = provider
    out["mode"] = "traffic-sim"
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma3-1b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--static", action="store_true",
                    help="disable the adaptive controller")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config instead of full width")
    # open-loop traffic ------------------------------------------------------
    ap.add_argument("--sim", action="store_true",
                    help="virtual-time traffic harness (no engine)")
    ap.add_argument("--provider", choices=sorted(PROVIDER_PRESETS),
                    default="aws_lambda",
                    help="FaaS provider preset (--sim mode)")
    ap.add_argument("--rate", type=float, default=None,
                    help="open-loop offered load, req/s")
    ap.add_argument("--tenants", type=int, default=2,
                    help="tenants sharing the offered load")
    ap.add_argument("--arrival", choices=["poisson", "mmpp"],
                    default="poisson")
    ap.add_argument("--arrival-trace", default=None, metavar="PATH",
                    help="drive arrivals from a saved JSONL stream")
    ap.add_argument("--horizon", type=float, default=60.0,
                    help="traffic horizon, seconds (--sim mode)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--slo-ttft", type=float, default=None,
                    help="p99 TTFT target: enables SLO autoscale "
                         "(--sim mode)")
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="compress open-loop arrival gaps (engine mode)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="spill the run's event timeline to PATH "
                         "(JSONL TraceStore)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args()
    if args.sim:
        out = serve_traffic_sim(
            provider=args.provider,
            rate=args.rate if args.rate is not None else 4.0,
            n_tenants=args.tenants, arrival=args.arrival,
            horizon_s=args.horizon, seed=args.seed,
            capacity=args.slots, max_seq=args.max_seq,
            slo_ttft_s=args.slo_ttft,
            arrival_trace=args.arrival_trace, trace=args.trace)
    else:
        out = serve(args.arch, smoke=args.smoke, n_requests=args.requests,
                    n_slots=args.slots, max_seq=args.max_seq,
                    seed=args.seed, adaptive=not args.static,
                    rate=args.rate, n_tenants=args.tenants,
                    arrival=args.arrival,
                    arrival_trace=args.arrival_trace,
                    trace=args.trace, time_scale=args.time_scale,
                    device=args.device)
    print(out)


if __name__ == "__main__":
    main()
