"""Elastic-executor middleware of the PyTorch port.

A copy of ``repro.core`` (the reference package's pool abstraction and
``run_irregular`` master loop), kept here so the port imports nothing of
the JAX package.  The modules are copied unchanged apart from their
imports, except ``simulate_uts_pool``, which takes a ``device`` like
every entry point of the port and traverses the tree there.

    Pool, make_pool("local"|"elastic"|"hybrid"|"sim"|"speculative", **cfg)
    WorkSpec, run_irregular(pool, spec, ...), IrregularResult
    (``resume_from=``, ``wal=``, ``checkpoint_every=``: WAL crash
    recovery through ``repro_torch.chaos``)
    LocalExecutor, ElasticExecutor, HybridExecutor, SimPool,
    simulate_uts_pool
    StagedController, OccupancyController, TaskShape
    ProviderModel, AutoscalePolicy, serverless_cost, vm_cost,
    emr_cluster_cost, price_performance
    characterize, coefficient_of_variation
"""
from .futures import (CompletionQueue, ElasticFuture, Task, TaskRecord,
                      TaskState, WorkerKilledError)
from .telemetry import (Clock, Event, EventLog, VirtualClock, WallClock)
from .provider import (AutoscalePolicy, Backoff, ContainerFleet,
                       ProviderModel)
from .pool import (Pool, ShardView, make_pool, register_pool,
                   registered_pools)
from .executor import (
    BaseExecutor,
    ConcurrencyTracker,
    ElasticExecutor,
    ExecutorStats,
    FunctionThrottledError,
    LocalExecutor,
    as_completed,
)
from .hybrid import HybridExecutor
from .simpool import SimPool, simulate_uts_pool
from .adaptive import OccupancyController, StagedController, TaskShape
from .irregular import IrregularResult, WorkSpec, run_irregular
from .costmodel import (
    CostReport,
    LambdaPrice,
    VMPrice,
    emr_cluster_cost,
    price_performance,
    serverless_cost,
    vm_cost,
)
from .characterization import (
    Characterization,
    characterize,
    coefficient_of_variation,
    duration_cdf,
    task_generation_rate,
)

__all__ = [
    "Pool", "ShardView", "make_pool", "register_pool",
    "registered_pools",
    "WorkSpec", "run_irregular", "IrregularResult",
    "ProviderModel", "AutoscalePolicy", "ContainerFleet", "Backoff",
    "Clock", "WallClock", "VirtualClock", "Event", "EventLog",
    "ElasticFuture", "Task", "TaskRecord", "TaskState", "CompletionQueue",
    "WorkerKilledError",
    "BaseExecutor", "ElasticExecutor", "LocalExecutor", "HybridExecutor",
    "SimPool", "simulate_uts_pool",
    "ExecutorStats", "ConcurrencyTracker",
    "FunctionThrottledError", "as_completed",
    "StagedController", "OccupancyController", "TaskShape",
    "CostReport", "LambdaPrice", "VMPrice",
    "serverless_cost", "vm_cost", "emr_cluster_cost", "price_performance",
    "Characterization", "characterize", "coefficient_of_variation",
    "duration_cdf", "task_generation_rate",
]
