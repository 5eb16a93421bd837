"""The port's ``repro_torch.dag`` on the CPU: a twin of each test of
``tests/test_dag.py`` (validation, the deterministic gather, bit-identity
across pools, batching and shards, the DAG result surface, WAL kill and
resume mid-DAG, the Barcelona-Pons parallelism probe).  Every twin runs the
reference's case through both packages: the reference's assertions hold
for each, and the port's sink values, stage widths, critical paths,
virtual seconds and probe profiles equal the JAX package's."""
import dataclasses
import importlib
from types import SimpleNamespace

import pytest
import torch


def _pkg(root: str) -> SimpleNamespace:
    def imp(name):
        return importlib.import_module(f"{root}.{name}")
    dag, chaos, core = imp("dag"), imp("chaos"), imp("core")
    return SimpleNamespace(
        **{k: getattr(dag, k) for k in dag.__all__},
        MasterKilledError=chaos.MasterKilledError,
        kill_master_after=chaos.kill_master_after,
        make_pool=core.make_pool, run_irregular=core.run_irregular,
        TaskShape=core.TaskShape,
        ProviderModel=imp("core.provider").ProviderModel,
        algorithms=imp("algorithms"))


J, T = _pkg("repro"), _pkg("repro_torch")
FAMILIES = ["montage_dag", "hyperparam_sweep_dag", "iterative_mapreduce_dag"]


def both(case, *args):
    """``case`` run through the reference and the port: equal results."""
    want, got = case(J, *args), case(T, *args)
    assert got == want
    return got


def _sim(m):
    return m.make_pool("sim", max_concurrency=8)


def _shape(r):
    """A DAG run's whole result surface."""
    return (r.output, r.dag_nodes, r.stage_widths, r.critical_path_len,
            r.tasks, r.makespan_s)


# -- validation paths ------------------------------------------------------

def _error(m, build):
    with pytest.raises(ValueError) as err:
        build(m)
    return str(err.value)


def test_duplicate_node_id_rejected():
    msg = both(_error, lambda m: m.DagSpec(name="dup", nodes=(
        m.DagNode("a", lambda i, p: 0), m.DagNode("a", lambda i, p: 1))))
    assert "duplicate" in msg


def test_unknown_dep_is_unreachable():
    msg = both(_error, lambda m: m.DagSpec(name="orphan", nodes=(
        m.DagNode("a", lambda i, p: 0),
        m.DagNode("b", lambda i, p: 0, deps=("ghost",)))))
    assert "unreachable" in msg


def test_cycle_detected():
    msg = both(_error, lambda m: m.DagSpec(name="loop", nodes=(
        m.DagNode("a", lambda i, p: 0, deps=("c",)),
        m.DagNode("b", lambda i, p: 0, deps=("a",)),
        m.DagNode("c", lambda i, p: 0, deps=("b",)))))
    assert "cycle" in msg


def test_unknown_output_rejected():
    msg = both(_error, lambda m: m.DagSpec(
        name="out", nodes=(m.DagNode("a", lambda i, p: 0),),
        outputs=("ghost",)))
    assert "outputs" in msg


def test_dynamic_expand_validation():
    def build(m):
        def expand(v):
            return [m.DagNode("root", lambda i, p: 0)]  # collides with root
        spec = m.DagSpec(name="dyn", nodes=(
            m.DagNode("root", lambda i, p: 0, expand=expand),))
        m.run_irregular(_sim(m), spec)
    assert "duplicate" in both(_error, build)


# -- deterministic gather --------------------------------------------------

def test_join_gathers_in_declared_dep_order():
    def case(m):
        b = m.DagBuilder("gather")
        ids = b.fan_out("leaf", lambda i, p: p * 10, range(5))
        b.join("sink", lambda i, p: list(i), list(reversed(ids)))
        out = m.run_irregular(_sim(m), b.build()).output
        assert out == {"sink": [40, 30, 20, 10, 0]}
        return out
    both(case)


# -- bit-identity across pools and batching --------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_bit_identical_across_pools_and_batching(family):
    def case(m):
        base = m.run_irregular(_sim(m), getattr(m, family)())
        assert base.output
        for mk_pool in (_sim, lambda m: m.make_pool("local",
                                                    max_concurrency=4)):
            for batching in (False, True):
                pool = mk_pool(m)
                try:
                    r = m.run_irregular(pool, getattr(m, family)(),
                                        batching=batching)
                finally:
                    pool.shutdown()
                assert r.output == base.output, (mk_pool, batching)
                assert r.dag_nodes == base.dag_nodes
                assert r.stage_widths == base.stage_widths
                assert r.critical_path_len == base.critical_path_len
        return _shape(base)
    both(case)


@pytest.mark.parametrize("family", FAMILIES)
def test_bit_identical_sharded(family):
    def case(m):
        base = m.run_irregular(_sim(m), getattr(m, family)())
        r = m.run_irregular(_sim(m), getattr(m, family)(), shards=3)
        assert r.output == base.output
        assert r.shards == 3
        return _shape(base), r.output, r.tasks
    both(case)


# -- DAG result surface ----------------------------------------------------

def test_montage_static_shape():
    def case(m):
        r = m.run_irregular(_sim(m), m.montage_dag(tiles=8))
        assert r.stage_widths == [9, 4, 2, 1, 1]
        assert r.critical_path_len == 5
        assert r.dag_nodes == 17
        assert r.tasks == 17
        assert list(r.output) == ["mosaic"]
        return _shape(r)
    both(case)


def test_dynamic_widths_are_data_dependent():
    def case(m):
        r = m.run_irregular(_sim(m), m.iterative_mapreduce_dag(
            rounds=4, initial_width=8, max_width=16))
        assert len(r.stage_widths) == 8
        assert r.stage_widths[0] == 8
        assert all(w == 1 for w in r.stage_widths[1::2])
        assert any(w != 8 for w in r.stage_widths[2::2])
        return _shape(r)
    both(case)


def test_sweep_early_stopping_shrinks_stages():
    def case(m):
        r = m.run_irregular(_sim(m), m.hyperparam_sweep_dag(configs=8,
                                                           stages=3))
        train_widths = r.stage_widths[::2]
        assert train_widths[0] == 8
        assert all(b <= a for a, b in zip(train_widths, train_widths[1:]))
        assert train_widths[-1] < 8
        return _shape(r)
    both(case)


def test_tree_specs_report_no_dag_fields():
    def case(m):
        kw = {} if m is J else {"device": torch.device("cpu")}
        p = m.algorithms.UTSParams(seed=2, b0=3.0, max_depth=4)
        r = m.run_irregular(_sim(m), m.algorithms.uts_spec(p, **kw),
                            shape=m.TaskShape(split_factor=4, iters=50))
        assert r.critical_path_len == 0
        assert r.stage_widths == []
        assert r.dag_nodes == 0
        return r.output, r.tasks, r.makespan_s
    both(case)


# -- WAL kill + resume mid-DAG ---------------------------------------------

@pytest.mark.parametrize("family,n_folds",
                         [("montage_dag", 9), ("hyperparam_sweep_dag", 6),
                          ("iterative_mapreduce_dag", 12)], ids=FAMILIES)
def test_mid_dag_kill_resume_bit_identical(family, n_folds):
    def case(m):
        base = m.run_irregular(_sim(m), getattr(m, family)()).output
        pool = _sim(m)
        with pytest.raises(m.MasterKilledError):
            m.run_irregular(pool, m.kill_master_after(
                getattr(m, family)().to_workspec(), n_folds), wal=True)
        resumed = m.run_irregular(_sim(m), getattr(m, family)(),
                                  resume_from=pool.events)
        assert resumed.output == base
        assert resumed.recovered_tasks > 0
        return (base, resumed.recovered_tasks, resumed.tasks,
                resumed.makespan_s)
    both(case)


def test_mid_dag_kill_resume_batched():
    def case(m):
        base = m.run_irregular(_sim(m), m.montage_dag()).output
        pool = _sim(m)
        with pytest.raises(m.MasterKilledError):
            m.run_irregular(pool, m.kill_master_after(
                m.montage_dag().to_workspec(), 9), wal=True, batching=True)
        resumed = m.run_irregular(_sim(m), m.montage_dag(),
                                  resume_from=pool.events, batching=True)
        assert resumed.output == base
        return base, resumed.recovered_tasks, resumed.tasks
    both(case)


# -- the Barcelona-Pons probe ----------------------------------------------

def test_probe_widths_schedule():
    def case(m):
        got = (m.probe_widths(16), m.probe_widths(20, start=4))
        assert got == ([1, 2, 4, 8, 16], [4, 8, 16, 20])
        with pytest.raises(ValueError):
            m.probe_widths(0)
        return got
    both(case)


def _profile(prof):
    return (prof.requested, prof.achieved,
            [dataclasses.astuple(b) for b in prof.bursts])


def test_probe_measures_platform_limits():
    def case(m):
        pool = m.make_pool("sim", max_concurrency=1024,
                           provider=m.ProviderModel.gcf())
        prof = m.run_parallelism_probe(pool, max_width=256)
        assert isinstance(prof, m.ParallelismProfile)
        assert prof.requested == [1, 2, 4, 8, 16, 32, 64, 128, 256]
        assert prof.envelope_monotone()
        by_width = dict(zip(prof.requested, prof.achieved))
        assert by_width[64] == 64
        assert by_width[256] < 256
        assert prof.bursts[0].cold_start_share > 0
        assert prof.bursts[-1].ramp_latency_s >= 0
        return _profile(prof)
    both(case)


def test_probe_feeds_fit_provider():
    def case(m):
        known = dataclasses.replace(
            m.ProviderModel.gcf(), name="probe-target", burst_concurrency=8,
            scaling_ramp_per_min=240.0, cold_start_s=0.3)
        pool = m.make_pool("sim", max_concurrency=1024, provider=known)
        prof = m.run_parallelism_probe(pool, max_width=256, start=256,
                                       repeats_at_max=10)
        fitted = prof.fit(base=known)
        assert isinstance(fitted, m.ProviderModel)
        assert abs(fitted.burst_concurrency - 8) <= 2
        assert abs(fitted.scaling_ramp_per_min - 240.0) / 240.0 < 0.25
        assert abs(fitted.cold_start_s - 0.3) / 0.3 < 0.25
        return _profile(prof), dataclasses.astuple(fitted)
    both(case)


def test_probe_on_prewarmed_delivers_everything():
    def case(m):
        pool = m.make_pool("sim", max_concurrency=1024,
                           provider=m.ProviderModel.prewarmed())
        prof = m.run_parallelism_probe(pool, max_width=128)
        assert prof.achieved == prof.requested
        return _profile(prof)
    both(case)


# -- the dag_pipeline and faas_parallelism rows, through both packages -----

def _load(name, rel):
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parents[1] / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("row", ["dag_pipeline", "faas_parallelism"])
def test_row_equals_the_reference(row):
    """``benchmarks/run.py``'s row (the JAX package) and ``chip_smoke.py``'s
    port of it at the row's shapes give the same derived values, which
    are the ones the smoke run holds the card to."""
    bench = _load("bench_run", "benchmarks/run.py")
    smoke = _load("chip_smoke", "chip_smoke.py")
    getattr(bench, row)()
    want = bench.JSON_ROWS[-1]["derived"]
    assert getattr(smoke, f"{row}_row")() == want
    assert getattr(smoke, f"{row.upper()}_ROW") == want
