"""Serving entry point: elastic continuous batching over a card-side engine.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch gemma3-1b --requests 16 --slots 4 --max-seq 256

Counterpart of ``repro.launch.serve``'s closed loop: the ElasticBatcher
(the paper's executor + §5.2 controller) schedules heavy-tailed requests
over :class:`TorchEngine`, whose slot-batched decode runs the model on
the card (``device=None``) or, when asked, on the CPU.  As in the
reference, the batcher's prefill chunks are counted, not computed.

The open-loop paths (``rate``, ``arrival_trace``), the event-timeline
spill (``trace``) and ``serve_traffic_sim`` need ``repro.traffic`` and
``repro.trace.store``, which are not ported yet; they raise
``NotImplementedError`` naming ``ROADMAP.md``.
"""
from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..device import DeviceLike, resolve_device
from ..models import decode_step, init_cache, init_params
from ..serving.elastic_batcher import BatcherConfig, ElasticBatcher, Request

__all__ = ["TorchEngine", "serve", "serve_traffic_sim", "main"]

_NOT_PORTED = "needs repro.traffic / repro.trace.store, not ported yet " \
              "(ROADMAP.md, queue 1)"


class TorchEngine:
    """Real decode engine: one KV cache arena, slot-batched decode.

    Weights are random from seed 0, as the reference's from
    ``PRNGKey(0)`` (the numbers differ; the shapes are the same).  Decoding always runs the full [n_slots] batch (inactive slots are
    masked by position), as the reference's jitted step does.  Prefill
    chunks are counted only, exactly as ``JaxEngine.prefill_chunk``.
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
        tokens = torch.from_numpy(self.tokens).to(self.device, torch.long)
        pos = torch.from_numpy(self.pos).to(self.device, torch.long)
        with torch.inference_mode():
            logits, self.cache = decode_step(self.cfg, self.params,
                                             self.cache, {"tokens": tokens},
                                             pos)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32).cpu().numpy()
        self.tokens = nxt[:, None] % self.cfg.vocab_size
        self.pos = np.minimum(self.pos + 1, self.max_seq - 1)
        self.decode_steps += 1


def serve(arch: str, *, smoke: bool = True, n_requests: int = 32,
          n_slots: int = 4, max_seq: int = 256, seed: int = 0,
          adaptive: bool = True, rate: Optional[float] = None,
          arrival_trace: Optional[str] = None, trace: Optional[str] = None,
          device: DeviceLike = None) -> dict:
    """Serve ``n_requests`` heavy-tailed requests, submitted up front, on
    the real engine (the reference's closed loop, with the same request
    stream for the same ``seed``)."""
    if rate is not None or arrival_trace is not None:
        raise NotImplementedError(f"open-loop serving {_NOT_PORTED}")
    if trace is not None:
        raise NotImplementedError(f"trace= {_NOT_PORTED}")
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    engine = TorchEngine(cfg, n_slots, max_seq, device=device)
    batcher = ElasticBatcher(engine, BatcherConfig(
        n_slots=n_slots, adaptive=adaptive))
    rng = np.random.RandomState(seed)
    for i in range(n_requests):
        plen = int(np.clip(rng.lognormal(3.5, 1.0), 4, max_seq // 2))
        new = int(np.clip(rng.lognormal(2.5, 0.8), 2, max_seq // 4))
        batcher.submit(Request(rid=i, prompt_len=plen, max_new_tokens=new))
    report = batcher.run()
    report["engine_decode_steps"] = engine.decode_steps
    report["arch"] = cfg.name
    report["device"] = str(engine.device)
    return report


def serve_traffic_sim(**kw) -> dict:
    """The reference's virtual-time traffic harness; not ported yet."""
    raise NotImplementedError(f"serve_traffic_sim {_NOT_PORTED}")


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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run on the CPU")
    args = ap.parse_args()
    print(serve(args.arch, smoke=args.smoke, n_requests=args.requests,
                n_slots=args.slots, max_seq=args.max_seq, seed=args.seed,
                adaptive=not args.static, device=args.device))


if __name__ == "__main__":
    main()
