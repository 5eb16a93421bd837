"""Dependency-structured workloads + the FaaS parallelism probe.

Extends ``run_irregular`` from tree-irregular (UTS/MS/BC) to
DAG-irregular workloads — scientific-workflow graphs where a task is
frontier-ready only once every upstream dependency has folded — and
ships the Barcelona-Pons simultaneous-invocation probe that measures a
platform's usable parallelism and feeds ``repro_torch.trace.fit_provider``.

    spec = montage_dag(tiles=32)
    res = run_irregular(pool, spec, batching=True)
    res.output             # {sink_id: value}, canonical order
    res.critical_path_len, res.stage_widths, res.dag_nodes

Spec layer: ``DagSpec``/``DagNode``/``DagBuilder`` (``node``,
``fan_out``, ``join``, ``stage``).  Workloads: ``montage_dag``,
``hyperparam_sweep_dag``, ``iterative_mapreduce_dag``.  Probe:
``run_parallelism_probe`` → ``ParallelismProfile`` → ``.fit()``.
"""
from .spec import DagBuilder, DagNode, DagSpec
from .scheduler import DagItem, DagScheduler, DagWorkSpec, build_workspec
from .workloads import (hyperparam_sweep_dag, iterative_mapreduce_dag,
                        montage_dag)
from .probe import (BurstMeasurement, ParallelismProfile, probe_widths,
                    run_parallelism_probe)

__all__ = [
    "DagBuilder", "DagNode", "DagSpec",
    "DagItem", "DagScheduler", "DagWorkSpec", "build_workspec",
    "montage_dag", "hyperparam_sweep_dag", "iterative_mapreduce_dag",
    "BurstMeasurement", "ParallelismProfile", "probe_widths",
    "run_parallelism_probe",
]
