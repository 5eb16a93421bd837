"""The port's ``hybrid``, ``sim`` and ``speculative`` pools and
``simulate_uts_pool`` on the CPU: twins of ``tests/test_simpool.py``,
``tests/test_speculation.py`` and those pools' cases of
``tests/test_pool_api.py`` and ``tests/test_elasticity.py``, and
``simulate_uts_pool`` against the reference package's, field for field."""
import threading
import time

import pytest
import torch

from repro.algorithms.uts import UTSParams as JUTSParams
from repro.core import StagedController as JStagedController
from repro.core import TaskShape as JTaskShape
from repro.core.adaptive import Stage as JStage
from repro.core.simpool import simulate_uts_pool as jax_simulate_uts_pool
from repro_torch.algorithms import UTSParams, uts_sequential, uts_spec
from repro_torch.core import (AutoscalePolicy, EventLog, HybridExecutor,
                              Pool, ProviderModel, SimPool, StagedController,
                              TaskShape, VirtualClock, WorkSpec,
                              FunctionThrottledError, as_completed,
                              make_pool, registered_pools, run_irregular,
                              serverless_cost, simulate_uts_pool)
from repro_torch.core.adaptive import Stage
from repro_torch.core.futures import TaskRecord
from repro_torch.core.telemetry import (CAPACITY_GROW, CAPACITY_SHRINK,
                                        COMPLETE, START, SUBMIT)
from repro_torch.runtime import SpeculativeExecutor

P = UTSParams(seed=19, b0=4.0, max_depth=7, chunk=1024)
CPU = "cpu"

#: the pools this slice adds, as the reference's contract tests build them
BACKENDS = [
    ("hybrid", dict(local_concurrency=2, elastic_concurrency=3)),
    ("sim", dict(max_concurrency=3, invoke_overhead=1e-3)),
    ("speculative", dict(inner="local",
                         inner_cfg=dict(max_concurrency=3,
                                        invoke_overhead=0.0),
                         floor_s=30.0)),
]
IDS = [b[0] for b in BACKENDS]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; PyTorch's intra-op threads would
    oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- simulate_uts_pool (tests/test_simpool.py) ---------------------------------

def test_simulated_traversal_is_exact():
    expected = uts_sequential(P, device=CPU)
    r = simulate_uts_pool(P, workers=64, overhead_s=1e-3,
                          alpha_s_per_node=1e-6,
                          shape=TaskShape(8, 500), device=CPU)
    assert r.count == expected
    assert r.peak_concurrency <= 64
    assert r.virtual_time_s > 0


def test_more_workers_never_slower():
    shape = TaskShape(16, 300)
    t_narrow = simulate_uts_pool(P, workers=4, overhead_s=1e-3,
                                 alpha_s_per_node=1e-6, shape=shape,
                                 device=CPU).virtual_time_s
    t_wide = simulate_uts_pool(P, workers=256, overhead_s=1e-3,
                               alpha_s_per_node=1e-6, shape=shape,
                               device=CPU).virtual_time_s
    assert t_wide <= t_narrow


def test_controller_reacts_in_simulation():
    ctrl = StagedController(initial=TaskShape(32, 200), stages=[
        Stage(16, "above", TaskShape(4, 2000)),
        Stage(8, "below", TaskShape(4, 500)),
    ])
    r = simulate_uts_pool(P, workers=64, overhead_s=1e-3,
                          alpha_s_per_node=1e-6,
                          shape=TaskShape(32, 200), controller=ctrl,
                          device=CPU)
    assert r.count == uts_sequential(P, device=CPU)
    assert ctrl.step >= 1  # at least one stage transition fired


def test_makespan_bounded_below_by_work_and_critical_path():
    """Virtual makespan >= total-work / workers and >= one overhead."""
    r = simulate_uts_pool(P, workers=8, overhead_s=2e-3,
                          alpha_s_per_node=1e-6,
                          shape=TaskShape(8, 400), device=CPU)
    work = r.count * 1e-6 + r.tasks * 2e-3
    assert r.virtual_time_s >= work / 8 * 0.99
    assert r.virtual_time_s >= 2e-3


@pytest.mark.parametrize("staged", [False, True])
def test_simulate_uts_pool_equals_the_reference(staged):
    """Every field of the result, the concurrency trace included, equals
    the reference package's on the same tree, shape and controller."""
    def stages(ctrl_cls, stage_cls, shape_cls):
        return ctrl_cls(initial=shape_cls(32, 200), stages=[
            stage_cls(16, "above", shape_cls(4, 2000)),
            stage_cls(8, "below", shape_cls(4, 500))])
    kw = dict(workers=48, overhead_s=1e-3, alpha_s_per_node=1e-6)
    ours = simulate_uts_pool(
        P, shape=TaskShape(32, 200), device=CPU,
        controller=stages(StagedController, Stage, TaskShape)
        if staged else None, **kw)
    ref = jax_simulate_uts_pool(
        JUTSParams(seed=19, b0=4.0, max_depth=7, chunk=1024),
        shape=JTaskShape(32, 200),
        controller=stages(JStagedController, JStage, JTaskShape)
        if staged else None, **kw)
    for field in ("count", "virtual_time_s", "tasks", "peak_concurrency",
                  "concurrency_trace"):
        assert getattr(ours, field) == getattr(ref, field), field


def test_simulate_uts_pool_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate_uts_pool(P, workers=4)


# -- the registry and the Pool contract (tests/test_pool_api.py) ----------------

def test_all_backends_registered():
    assert {"local", "elastic", "hybrid", "sim",
            "speculative"} <= set(registered_pools())


@pytest.mark.parametrize("kind,cfg", BACKENDS[:2], ids=IDS[:2])
def test_pool_contract(kind, cfg):
    """One shared lifecycle for every backend: construct via make_pool,
    submit/map, stats/records/snapshot, context manager."""
    with make_pool(kind, **cfg) as pool:
        assert isinstance(pool, Pool)
        assert pool.kind == kind
        futures = [pool.submit(lambda i=i: i * i, cost_hint=float(i))
                   for i in range(12)]
        assert sorted(f.result() for f in futures) \
            == sorted(i * i for i in range(12))
        assert pool.map(lambda x: x + 1, [1, 2, 3]) == [2, 3, 4]
        snap = pool.snapshot()
        assert snap["submitted"] == 15
        assert snap["completed"] == 15
        assert snap["failed"] == 0
        assert 1 <= snap["peak_concurrency"] <= 5  # hybrid: 2 local + 3
        assert len(pool.records) == 15
        assert pool.pending() == 0
    # context manager exit shut the pool down
    with pytest.raises(RuntimeError):
        pool.submit(lambda: 1)


@pytest.mark.parametrize("kind,cfg", BACKENDS[:2], ids=IDS[:2])
def test_pool_rejects_none_task(kind, cfg):
    pool = make_pool(kind, **cfg)
    with pytest.raises(TypeError):
        pool.submit(None)
    pool.shutdown()


@pytest.mark.parametrize("kind,cfg", BACKENDS[:2], ids=IDS[:2])
def test_as_completed_event_driven(kind, cfg):
    with make_pool(kind, **cfg) as pool:
        fs = [pool.submit(lambda i=i: i) for i in range(9)]
        assert {f.result() for f in as_completed(fs, timeout=10)} \
            == set(range(9))


def test_throttle_reject_sim():
    sp = make_pool("sim", max_concurrency=2, throttle_mode="reject")
    sp.submit(lambda: 1)
    sp.submit(lambda: 2)
    with pytest.raises(FunctionThrottledError):
        sp.submit(lambda: 3)
    sp.shutdown()


def test_sim_pool_delivers_exceptions():
    with make_pool("sim", max_concurrency=2) as sp:
        f = sp.submit(lambda: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            f.result()
        assert sp.snapshot()["failed"] == 1


def test_hybrid_combined_peak_is_true_simultaneous_max():
    hy = HybridExecutor(local_concurrency=2, elastic_concurrency=8)
    barrier = threading.Barrier(5)
    fs = [hy.submit(barrier.wait, 10) for _ in range(5)]
    for f in fs:
        f.result()
    assert hy.stats.peak_concurrency == 5
    # true peak can never exceed the old per-pool-sum upper bound
    assert hy.stats.peak_concurrency <= \
        (hy.local.stats.peak_concurrency
         + hy.elastic.stats.peak_concurrency)
    hy.shutdown()


def test_speculative_pool_via_make_pool():
    with make_pool("speculative", inner="local",
                   inner_cfg=dict(max_concurrency=2, invoke_overhead=0.0),
                   floor_s=10.0) as pool:
        assert isinstance(pool, Pool)
        assert isinstance(pool, SpeculativeExecutor)
        assert pool.map(lambda x: x * 3, [1, 2]) == [3, 6]


# -- elasticity contract (tests/test_elasticity.py) -----------------------------

@pytest.mark.parametrize("kind,cfg", BACKENDS, ids=IDS)
def test_timeline_records_lifecycle(kind, cfg):
    """Every backend writes submit/start/complete events to one
    EventLog; records and the concurrency curve derive from it."""
    with make_pool(kind, **cfg) as pool:
        fs = [pool.submit(lambda i=i: i * i) for i in range(8)]
        assert sorted(f.result() for f in fs) == [i * i for i in range(8)]
        log = pool.events
        counts = log.counts()
        assert counts[SUBMIT] == 8
        assert counts[START] >= 8
        assert counts[COMPLETE] == 8
        assert counts[CAPACITY_GROW] >= 1
        assert len(log.records) == 8
        series = log.concurrency_series()
        assert series, "concurrency curve must be derivable"
        assert max(a for _, a in series) <= pool.capacity
        assert series[-1][1] == 0           # drained at the end
        assert {r.task_id for r in log.records} \
            == {r.task_id for r in pool.records}


@pytest.mark.parametrize("kind,cfg", BACKENDS, ids=IDS)
def test_resize_contract(kind, cfg):
    """resize() moves capacity both ways, logs capacity events, and the
    pool keeps executing correctly at the new width."""
    with make_pool(kind, **cfg) as pool:
        c0 = pool.capacity
        pool.resize(c0 + 4)
        assert pool.capacity == c0 + 4
        grow = [e for e in pool.events.events(CAPACITY_GROW)
                if e.capacity is not None]
        assert any(e.capacity >= c0 + 1 for e in grow)
        assert pool.map(lambda x: x + 1, list(range(6))) \
            == list(range(1, 7))
        pool.resize(max(1, c0))
        shrink = pool.events.events(CAPACITY_SHRINK)
        assert shrink and shrink[-1].capacity <= c0 + 4
        assert pool.map(lambda x: x * 2, [1, 2]) == [2, 4]
        series = pool.events.capacity_series()
        assert series[-1][1] == pool.capacity


def test_sim_resize_rejects_nonpositive():
    with make_pool("sim", max_concurrency=3, invoke_overhead=1e-3) as pool:
        with pytest.raises(ValueError):
            pool.resize(0)


def test_run_irregular_autoscale_grows_and_shrinks():
    """Driving UTS with an AutoscalePolicy on the sim pool: capacity
    follows the frontier up and decays in the drain phase."""
    p = UTSParams(seed=19, b0=4.0, max_depth=6, chunk=1024)
    pool = make_pool("sim", max_concurrency=2, invoke_overhead=1e-3)
    r = run_irregular(pool, uts_spec(p, device=CPU),
                      shape=TaskShape(16, 200),
                      autoscale=AutoscalePolicy(min_capacity=2,
                                                max_capacity=64))
    pool.shutdown()
    assert r.output == uts_sequential(p, device=CPU)
    assert r.autoscale_decisions, "policy must have fired"
    grew = [new for old, new in r.autoscale_decisions if new > old]
    assert grew and max(grew) > 2, "frontier pressure must grow the pool"
    assert r.capacity_series, "resizes are timeline events"
    assert r.cost is not None and r.cost.total > 0


def test_sim_pool_cold_then_warm():
    """First wave is cold; the second reuses warm containers within the
    keep-alive window."""
    prov = ProviderModel.aws_lambda(cold_start_s=0.5, keep_alive_s=60.0)
    with make_pool("sim", max_concurrency=4, provider=prov) as pool:
        first = [pool.submit(lambda: 1, cost_hint=100.0)
                 for _ in range(4)]
        for f in first:
            f.result()
        t_first = pool.virtual_time_s
        assert pool.events.cold_starts() == 4
        assert t_first >= 0.5
        second = [pool.submit(lambda: 2, cost_hint=100.0)
                  for _ in range(4)]
        for f in second:
            f.result()
        assert pool.events.cold_starts() == 4
        assert pool.virtual_time_s - t_first < 0.5


def test_sim_ramp_gates_virtual_concurrency():
    """burst=2, ramp=120/min: at virtual time t the platform grants
    2 + 2t slots; the start events respect that envelope."""
    prov = ProviderModel.aws_lambda(cold_start_s=0.0, warm_overhead_s=0.0,
                                    burst_concurrency=2,
                                    scaling_ramp_per_min=120.0)
    with make_pool("sim", max_concurrency=100, provider=prov,
                   alpha_s_per_node=1.0) as pool:
        assert isinstance(pool, SimPool)
        fs = [pool.submit(lambda: 0, cost_hint=1.0) for _ in range(30)]
        for f in fs:
            f.result()
        for t, active in pool.events.concurrency_series():
            assert active <= max(1, prov.allowed_concurrency(t))
        assert pool.stats.peak_concurrency > 2


def test_one_model_two_clocks_same_invoice():
    """Identical records through the virtual and the real timelines
    bill identically."""
    prov = ProviderModel.aws_lambda(billing_granularity_s=0.1,
                                    memory_mb=2048)
    recs = [TaskRecord(task_id=i, worker="w", submit_time=0.0,
                       start_time=0.0, end_time=0.25, cost_hint=1.0,
                       remote=True) for i in range(3)]
    a = serverless_cost(recs, wall_time_s=1.0, provider=prov)
    log = EventLog(VirtualClock())
    for r in recs:
        log.emit(COMPLETE, t=r.end_time, ok=True, record=r)
    b = serverless_cost(log, wall_time_s=1.0, provider=prov)
    assert a.as_dict() == b.as_dict()


def test_reused_sim_pool_bills_per_run_not_cumulatively():
    spec = WorkSpec(name="three", execute=lambda item, shape: item,
                    seed=lambda shape: [1, 2, 3])
    pool = make_pool("sim", max_concurrency=2, invoke_overhead=1e-3)
    r1 = run_irregular(pool, spec)
    r2 = run_irregular(pool, spec)
    pool.shutdown()
    assert abs(r1.cost.total - r2.cost.total) < 1e-12
    assert len(r1.concurrency_series) == len(r2.concurrency_series) == 6
    assert abs(r1.makespan_s - r2.makespan_s) < 1e-9
    assert r2.concurrency_series[0][0] >= r1.concurrency_series[-1][0]


def test_hybrid_capacity_series_is_aggregate_only():
    """The merged hybrid timeline must not interleave sub-pool
    capacities with aggregate ones."""
    with make_pool("hybrid", local_concurrency=2,
                   elastic_concurrency=8) as pool:
        pool.resize(12)
        pool.resize(6)
        series = pool.events.capacity_series()
        assert [c for _, c in series] == [10, 12, 6]


def test_map_failure_drains_on_sim_pool():
    with make_pool("sim", max_concurrency=2) as p:
        with pytest.raises(ZeroDivisionError):
            p.map(lambda x: 1 // x, [1, 0, 1, 1])


def test_speculative_forwards_batching_and_width():
    """speculative(sim) fuses batches like the bare sim pool; width
    introspection sees the inner pool."""
    with make_pool("speculative", inner="sim",
                   inner_cfg=dict(max_concurrency=8,
                                  invoke_overhead=1e-3),
                   floor_s=30.0) as pool:
        assert pool.supports_batching
        assert pool.max_concurrency == 8
        assert pool.capacity == 8
        fs = pool.submit_batch(lambda items: [i * 2 for i in items],
                               [1, 2, 3, 4])
        assert [f.result() for f in fs] == [2, 4, 6, 8]
        assert pool.snapshot()["invocations"] == 1


def test_speculative_decomposing_inner_stays_watched():
    """With a non-fusing inner, batches decompose through the wrapper's
    own submit so every item stays under the straggler watchdog."""
    with make_pool("speculative", inner="elastic",
                   inner_cfg=dict(max_concurrency=4, invoke_overhead=0.0,
                                  invoke_rate_limit=None),
                   floor_s=30.0) as pool:
        assert not pool.supports_batching
        fs = pool.submit_batch(lambda items: [i + 1 for i in items],
                               [1, 2, 3])
        assert sorted(f.result() for f in fs) == [2, 3, 4]
        assert pool.snapshot()["invocations"] == 3
        assert len(pool._watches) >= 3


def test_speculative_resize_forwards():
    with make_pool("speculative", inner="local",
                   inner_cfg=dict(max_concurrency=2,
                                  invoke_overhead=0.0),
                   floor_s=30.0) as pool:
        pool.resize(5)
        assert pool.capacity == 5
        assert pool.inner.max_concurrency == 5


# -- straggler speculation (tests/test_speculation.py) --------------------------

def test_expected_clone_overhead():
    prov = ProviderModel.aws_lambda(cold_start_s=0.7,
                                    warm_overhead_s=0.01)
    assert prov.expected_clone_overhead(warm_available=True) \
        == pytest.approx(0.01)
    assert prov.expected_clone_overhead(warm_available=False) \
        == pytest.approx(0.71)


def test_speculative_deadline_includes_cold_penalty():
    """With no warm container idle the watchdog deadline stretches by
    the full provisioning latency; a warm container retracts it."""
    prov = ProviderModel.aws_lambda(cold_start_s=7.0,
                                    warm_overhead_s=0.0,
                                    invoke_rate_limit=None)
    with make_pool("speculative", inner="elastic",
                   inner_cfg=dict(max_concurrency=2, provider=prov),
                   floor_s=0.5) as pool:
        pool._durations.extend([0.01] * 6)   # quantiles warmed up
        assert pool._deadline() == pytest.approx(0.5 + 7.0)
        pool.inner._fleet.release(0, time.monotonic())
        assert pool._deadline() == pytest.approx(0.5)


def test_run_irregular_speculation_waits_for_cold_clone_to_pay():
    """Without a provider the driver clones every straggler; when every
    clone would land cold, no duplicate is ever issued."""
    spec = WorkSpec(name="slow",
                    execute=lambda item, shape: time.sleep(0.1) or item,
                    seed=lambda shape: [1, 2, 3])
    with make_pool("elastic", max_concurrency=3, invoke_overhead=1.0,
                   invoke_rate_limit=None) as pool:
        r = run_irregular(pool, spec, speculative_deadline=0.3)
    assert r.speculated == 3
    prov = ProviderModel.aws_lambda(cold_start_s=1.0,
                                    warm_overhead_s=0.0,
                                    keep_alive_s=0.0,
                                    invoke_rate_limit=None)
    with make_pool("elastic", max_concurrency=3, provider=prov) as pool:
        r = run_irregular(pool, spec, speculative_deadline=0.3)
    assert r.speculated == 0


def test_watchdog_does_not_corrupt_virtual_fleet():
    """The watchdog's warm-container query runs on the inner pool's
    clock and never prunes a virtual fleet."""
    prov = ProviderModel.aws_lambda(cold_start_s=0.5, keep_alive_s=60.0)
    with make_pool("speculative", inner="sim",
                   inner_cfg=dict(max_concurrency=4, provider=prov),
                   floor_s=0.05, poll_s=0.01) as pool:
        for f in [pool.submit(lambda: 1, cost_hint=100.0)
                  for _ in range(4)]:
            f.result()
        time.sleep(0.15)                # several watchdog ticks
        inner = pool.inner
        assert inner._fleet.warm_count(inner.clock.now()) == 4
        for f in [pool.submit(lambda: 2, cost_hint=100.0)
                  for _ in range(4)]:
            f.result()
        assert inner.events.cold_starts() == 4   # all warm reuses


def test_batch_remainder_respawned_when_carrier_straggles():
    """A straggling fused carrier's unsettled remainder is re-dispatched
    per item and resolves the children."""
    release = threading.Event()

    def batch_fn(items):
        release.wait(timeout=30)        # the straggling carrier
        return [i * 10 for i in items]

    def item_fn(item):
        return item * 10

    with make_pool("speculative", inner="local",
                   inner_cfg=dict(max_concurrency=2,
                                  invoke_overhead=0.0),
                   floor_s=0.15, poll_s=0.02) as pool:
        for f in [pool.submit(lambda: 0) for _ in range(6)]:
            f.result(timeout=10)
        time.sleep(0.1)                 # let the watchdog record them
        fs = pool.submit_batch(batch_fn, [1, 2, 3], item_fn=item_fn)
        t0 = time.monotonic()
        assert [f.result(timeout=10) for f in fs] == [10, 20, 30]
        waited = time.monotonic() - t0
        release.set()
        assert waited < 5.0             # did not wait out the carrier
        assert pool.batch_respawns == 1
        assert pool.duplicates >= 3     # one clone per remaining item
        assert pool.wins_by_clone >= 3


def test_batch_watch_drops_completed_batches():
    """Fast fused batches are never respawned."""
    with make_pool("speculative", inner="local",
                   inner_cfg=dict(max_concurrency=2,
                                  invoke_overhead=0.0),
                   floor_s=0.1, poll_s=0.02) as pool:
        for f in [pool.submit(lambda: 0) for _ in range(6)]:
            f.result(timeout=10)
        fs = pool.submit_batch(lambda items: [i + 1 for i in items],
                               [1, 2, 3])
        assert [f.result(timeout=10) for f in fs] == [2, 3, 4]
        time.sleep(0.3)                 # several watchdog periods
        assert pool.batch_respawns == 0


def test_single_item_batch_stays_on_watched_path():
    """len-1 batches decompose through the wrapper's submit, keeping
    the per-task watchdog engaged."""
    with make_pool("speculative", inner="local",
                   inner_cfg=dict(max_concurrency=2,
                                  invoke_overhead=0.0),
                   floor_s=30.0) as pool:
        fs = pool.submit_batch(lambda items: [i * 2 for i in items], [21])
        assert [f.result(timeout=10) for f in fs] == [42]
        assert len(pool._watches) >= 1
        assert not pool._batch_watches


def test_speculative_clones_race_the_original_and_the_first_wins():
    """A UTS run on a speculative elastic pool whose watchdog clones
    eagerly: original and clone run the same task body at once, every
    invocation finishes, and the count is exact."""
    p = UTSParams(seed=19, b0=4.0, max_depth=7, chunk=1024)
    with make_pool("speculative", inner="elastic",
                   inner_cfg=dict(max_concurrency=4, invoke_overhead=0.0,
                                  invoke_rate_limit=None),
                   factor=1.0, floor_s=0.0, poll_s=0.005) as pool:
        r = run_irregular(pool, uts_spec(p, device=CPU),
                          shape=TaskShape(8, 400))
    snap = pool.inner.stats.snapshot()
    assert r.output == uts_sequential(p, device=CPU)
    assert pool.duplicates > 0
    assert snap["failed"] == 0 and snap["completed"] == snap["submitted"]
    assert snap["submitted"] == r.tasks + pool.duplicates


@pytest.mark.parametrize("kind", ["elastic", "local"])
def test_shutdown_joins_the_workers(kind):
    """After ``shutdown()`` no worker thread is left: one still unwinding
    when the interpreter exits is killed inside torch's C++ frames and
    aborts the process after its work is done."""
    pool = make_pool(kind, max_concurrency=6, invoke_overhead=0.0)
    futures = [pool.submit(lambda x: torch.ones(4).sum().item() + x, i)
               for i in range(24)]
    assert sorted(f.result() for f in futures) == [4.0 + i for i in range(24)]
    workers = list(pool._workers)
    assert len(workers) == 6
    pool.shutdown()
    assert not any(t.is_alive() for t in workers)
