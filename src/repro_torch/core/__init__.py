"""Elastic-executor middleware of the PyTorch port.

A copy of ``repro.core`` (the reference package's pool abstraction and
``run_irregular`` master loop), kept here so the port imports nothing of
the JAX package.  The modules are copied unchanged apart from their
imports; this slice registers the ``local`` and ``elastic`` pools, and
the WAL-resume paths of ``run_irregular`` raise until the chaos slice is
ported.

    Pool, make_pool("local"|"elastic", **cfg)
    WorkSpec, run_irregular(pool, spec, ...), IrregularResult
    StagedController, OccupancyController, TaskShape
    ProviderModel, AutoscalePolicy, serverless_cost, vm_cost
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
from .adaptive import OccupancyController, StagedController, TaskShape
from .irregular import IrregularResult, WorkSpec, run_irregular
from .costmodel import (
    CostReport,
    LambdaPrice,
    VMPrice,
    price_performance,
    serverless_cost,
    vm_cost,
)

__all__ = [
    "Pool", "ShardView", "make_pool", "register_pool",
    "registered_pools",
    "WorkSpec", "run_irregular", "IrregularResult",
    "ProviderModel", "AutoscalePolicy", "ContainerFleet", "Backoff",
    "Clock", "WallClock", "VirtualClock", "Event", "EventLog",
    "ElasticFuture", "Task", "TaskRecord", "TaskState", "CompletionQueue",
    "WorkerKilledError",
    "BaseExecutor", "ElasticExecutor", "LocalExecutor",
    "ExecutorStats", "ConcurrencyTracker",
    "FunctionThrottledError", "as_completed",
    "StagedController", "OccupancyController", "TaskShape",
    "CostReport", "LambdaPrice", "VMPrice",
    "serverless_cost", "vm_cost", "price_performance",
]
