"""Open-loop multi-tenant workload generation.

Serving load is *open-loop*: requests arrive on their own clock whether
or not the system keeps up, which is what exposes the capacity knee a
closed-loop driver (submit-all-then-drain) structurally cannot show.
This module turns a set of :class:`TenantSpec` s — each an arrival
process plus heavy-tailed prompt/decode length models — into one
deterministic, merge-sorted stream of :class:`TrafficRequest` s.

Everything is seeded through ``numpy``'s ``default_rng`` with a
``[seed, tenant_index]`` spawn key, so the stream is bit-reproducible
across runs and machines, and adding a tenant never perturbs the other
tenants' draws.  Streams round-trip through JSONL (``save_stream`` /
``load_stream``) so a recorded or hand-edited arrival trace can drive
the harness instead of a synthetic process (``ArrivalModel.trace``).
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass, field, replace
from typing import IO, Iterable, List, Optional, Sequence, Union

import numpy as np

__all__ = [
    "LengthModel", "ArrivalModel", "TenantSpec", "TrafficRequest",
    "generate_stream", "scale_rate", "save_stream", "load_stream",
]


@dataclass(frozen=True)
class LengthModel:
    """Heavy-tailed token-length distribution (lognormal / pareto /
    fixed), clipped to ``[lo, hi]``.

    Serving length distributions are famously heavy-tailed (a few huge
    prompts dominate slot occupancy), which is exactly the irregularity
    the elastic pool is supposed to absorb — so the default shapes are
    skewed, not Gaussian.
    """

    kind: str = "lognormal"     # lognormal | pareto | fixed
    mean: float = 128.0         # lognormal: underlying exp(mu); fixed: value
    sigma: float = 0.8          # lognormal shape
    alpha: float = 1.5          # pareto tail index (lower = heavier)
    lo: int = 1
    hi: int = 2048

    def sample(self, rng: np.random.Generator) -> int:
        if self.kind == "lognormal":
            x = rng.lognormal(math.log(max(self.mean, 1e-9)), self.sigma)
        elif self.kind == "pareto":
            # Lomax + 1 scaled so the *median* sits near ``mean``
            scale = self.mean * (2.0 ** (1.0 / self.alpha) - 1.0) \
                / (2.0 ** (1.0 / self.alpha))
            x = (rng.pareto(self.alpha) + 1.0) * max(scale, 1e-9)
        elif self.kind == "fixed":
            x = self.mean
        else:
            raise ValueError(f"unknown length model {self.kind!r}")
        return int(min(self.hi, max(self.lo, round(x))))


@dataclass(frozen=True)
class ArrivalModel:
    """Open-loop arrival process: exponential gaps (``poisson``), a
    2-state Markov-modulated Poisson process (``mmpp`` — calm/burst
    phases with exponential dwell times, the standard bursty-traffic
    stand-in), or a literal list of offsets (``trace``)."""

    kind: str = "poisson"       # poisson | mmpp | trace
    rate: float = 1.0           # req/s (poisson; mmpp calm phase)
    burst_rate: float = 8.0     # req/s while bursting (mmpp)
    calm_s: float = 20.0        # mean dwell in the calm phase (mmpp)
    burst_s: float = 4.0        # mean dwell in the burst phase (mmpp)
    times: Sequence[float] = () # explicit arrival offsets (trace)

    def arrivals(self, horizon_s: float,
                 rng: np.random.Generator) -> List[float]:
        """Arrival offsets in ``[0, horizon_s)``, sorted ascending."""
        if self.kind == "trace":
            return sorted(float(t) for t in self.times
                          if 0.0 <= t < horizon_s)
        out: List[float] = []
        t = 0.0
        if self.kind == "poisson":
            if self.rate <= 0:
                return out
            while True:
                t += rng.exponential(1.0 / self.rate)
                if t >= horizon_s:
                    return out
                out.append(t)
        if self.kind == "mmpp":
            bursting = False
            phase_end = rng.exponential(self.calm_s)
            while t < horizon_s:
                rate = self.burst_rate if bursting else self.rate
                gap = (rng.exponential(1.0 / rate) if rate > 0
                       else float("inf"))
                if t + gap < phase_end:
                    t += gap
                    if t < horizon_s:
                        out.append(t)
                else:
                    # phase flip; no arrival across the boundary
                    t = phase_end
                    bursting = not bursting
                    phase_end = t + rng.exponential(
                        self.burst_s if bursting else self.calm_s)
            return out
        raise ValueError(f"unknown arrival model {self.kind!r}")


@dataclass(frozen=True)
class TenantSpec:
    """One tenant: who they are, how they arrive, what they ask for."""

    name: str
    arrival: ArrivalModel = field(default_factory=ArrivalModel)
    prompt_len: LengthModel = field(default_factory=LengthModel)
    decode_len: LengthModel = field(
        default_factory=lambda: LengthModel(mean=64.0, sigma=0.6, hi=512))


@dataclass
class TrafficRequest:
    """One request in the generated stream.  The generator fills the
    identity/shape fields; the serving harness fills the outcome fields
    as the request moves through admission and execution."""

    rid: int
    tenant: str
    arrival_s: float
    prompt_len: int
    decode_len: int
    # -- filled by the harness -------------------------------------------
    service_s: float = 0.0      # modelled prefill+decode(+cold) seconds
    cold: bool = False
    lost: Optional[str] = None  # loss reason (A1/A2/A3), None if served
    ttft_s: Optional[float] = None

    def as_dict(self) -> dict:
        return {"rid": self.rid, "tenant": self.tenant,
                "arrival_s": self.arrival_s,
                "prompt_len": self.prompt_len,
                "decode_len": self.decode_len}


def generate_stream(tenants: Sequence[TenantSpec], *,
                    horizon_s: float,
                    seed: int = 0) -> List[TrafficRequest]:
    """The deterministic open-loop stream: every tenant's arrivals and
    lengths drawn from ``default_rng([seed, tenant_index])``, merged by
    ``(arrival_s, tenant_index)`` and assigned ``rid`` s in stream
    order.  Same inputs -> bit-identical stream."""
    merged: List[tuple] = []
    for idx, spec in enumerate(tenants):
        rng = np.random.default_rng([seed, idx])
        for t in spec.arrival.arrivals(horizon_s, rng):
            merged.append((float(t), idx,
                           spec.prompt_len.sample(rng),
                           spec.decode_len.sample(rng)))
    merged.sort(key=lambda m: (m[0], m[1]))
    return [TrafficRequest(rid=i, tenant=tenants[idx].name,
                           arrival_s=t, prompt_len=p, decode_len=d)
            for i, (t, idx, p, d) in enumerate(merged)]


def scale_rate(tenants: Sequence[TenantSpec],
               factor: float) -> List[TenantSpec]:
    """The same tenant mix at ``factor`` x the offered load — the knob
    a knee sweep turns.  Trace-driven tenants compress their offsets
    instead (2x rate == arrivals at half the recorded spacing)."""
    out = []
    for spec in tenants:
        a = spec.arrival
        if a.kind == "trace":
            a = replace(a, times=tuple(t / factor for t in a.times))
        else:
            a = replace(a, rate=a.rate * factor,
                        burst_rate=a.burst_rate * factor)
        out.append(replace(spec, arrival=a))
    return out


def save_stream(stream: Iterable[TrafficRequest],
                path_or_fp: Union[str, IO[str]]) -> int:
    """Spill a stream as JSONL (one request per line); returns count."""
    own = isinstance(path_or_fp, str)
    fp = open(path_or_fp, "w") if own else path_or_fp
    n = 0
    try:
        for req in stream:
            fp.write(json.dumps(req.as_dict()) + "\n")
            n += 1
    finally:
        if own:
            fp.close()
    return n


def load_stream(path_or_fp: Union[str, IO[str]]) -> List[TrafficRequest]:
    """Re-load a JSONL stream (the ``trace``-file-driven mode)."""
    own = isinstance(path_or_fp, str)
    fp = open(path_or_fp) if own else path_or_fp
    try:
        out = []
        for line in fp:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            out.append(TrafficRequest(
                rid=int(d["rid"]), tenant=d["tenant"],
                arrival_s=float(d["arrival_s"]),
                prompt_len=int(d["prompt_len"]),
                decode_len=int(d["decode_len"])))
        out.sort(key=lambda r: (r.arrival_s, r.rid))
        return out
    finally:
        if own:
            fp.close()
