"""repro_torch.traffic — open-loop multi-tenant traffic over elastic pools.

The serving-side counterpart of ``run_irregular``: deterministic
open-loop workload generation (:mod:`~repro_torch.traffic.workload`),
FaaS_Sim A0–A5 memory-bounded admission
(:mod:`~repro_torch.traffic.residency`), virtual- and wall-clock serving
drivers (:mod:`~repro_torch.traffic.harness`), and a p99-TTFT-targeting
autoscale policy (:mod:`~repro_torch.traffic.slo`) tunable offline through
``repro_torch.trace.replay.what_if``.
"""
from .harness import (EngineModel, ServingReport,  # noqa: F401
                      drive_batcher_open_loop, serve_open_loop)
from .residency import (Admission, ResidencyConfig,  # noqa: F401
                        ResidencyModel)
from .slo import SLOAutoscalePolicy, p_quantile  # noqa: F401
from .workload import (ArrivalModel, LengthModel,  # noqa: F401
                       TenantSpec, TrafficRequest, generate_stream,
                       load_stream, save_stream, scale_rate)

__all__ = [
    "ArrivalModel", "LengthModel", "TenantSpec", "TrafficRequest",
    "generate_stream", "scale_rate", "save_stream", "load_stream",
    "ResidencyConfig", "Admission", "ResidencyModel",
    "EngineModel", "ServingReport", "serve_open_loop",
    "drive_batcher_open_loop",
    "SLOAutoscalePolicy", "p_quantile",
]
