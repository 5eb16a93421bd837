"""The port's ``repro_torch.chaos`` on the CPU: a twin of each test of
``tests/test_chaos.py`` (fault injection, WAL crash recovery, routing
policies, and a cancel round trip through a trace and its replay), then the
WAL across the two packages: a journal written by either package resumes
in the other (UTS and MS bit for bit, BC within the reference's test
tolerances), and both packages journal the same folds in the same order."""
import numpy as np
import pytest
import torch

from repro.algorithms.betweenness import RMATParams as JRMATParams
from repro.algorithms.betweenness import bc_spec as jax_bc_spec
from repro.algorithms.mariani_silver import MSParams as JMSParams
from repro.algorithms.mariani_silver import ms_spec as jax_ms_spec
from repro.algorithms.uts import UTSParams as JUTSParams
from repro.algorithms.uts import uts_spec as jax_uts_spec
from repro.chaos import kill_master_after as jax_kill_master_after
from repro.core import TaskShape as JTaskShape
from repro.core import make_pool as jax_make_pool
from repro.core import run_irregular as jax_run_irregular
from repro.trace import TraceStore as JTraceStore
from repro_torch.algorithms import (MSParams, RMATParams, UTSParams,
                                    bc_spec, ms_spec, uts_spec)
from repro_torch.chaos import (CostPerDeadlinePolicy, FaultPlan,
                               LeastLoadedPolicy, LocalFirstPolicy,
                               MasterKilledError, RandomPolicy,
                               ThresholdPolicy, kill_master_after,
                               make_routing_policy, recover_frontier)
from repro_torch.core import (ProviderModel, StagedController, TaskShape,
                              WorkerKilledError, WorkSpec, make_pool,
                              run_irregular)
from repro_torch.core.provider import Backoff
from repro_torch.core.telemetry import (CANCEL, CHECKPOINT, FOLDED, REQUEUE,
                                        THROTTLED, WORKER_KILLED, Event,
                                        EventLog, VirtualClock)
from repro_torch.trace import (TraceStore, event_from_dict, event_to_dict,
                               extract_workload)

UTS = dict(seed=2, b0=3.0, max_depth=6)
MS = dict(width=64, height=64, max_dwell=32, max_depth=3,
          initial_subdivision=4)
BC = dict(scale=6, edge_factor=8, seed=2)
UTS_P, MS_P, BC_P = UTSParams(**UTS), MSParams(**MS), RMATParams(**BC)
UTS_SHAPE = TaskShape(split_factor=4, iters=50)
#: the reference's BC test tolerances
BC_RTOL, BC_ATOL = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; PyTorch's intra-op threads would
    oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _uts():
    return uts_spec(UTS_P, device="cpu")


def _ms():
    return ms_spec(MS_P, device="cpu")


def _bc():
    return bc_spec(BC_P, n_tasks=16, device="cpu")


def _run(spec, *, faults=None, trace=None, **kw):
    pool = make_pool("sim", max_concurrency=16, faults=faults, trace=trace)
    try:
        return run_irregular(pool, spec, **kw), pool
    finally:
        pool.shutdown()


@pytest.fixture(scope="module")
def uts_base():
    r, _ = _run(_uts(), shape=UTS_SHAPE)
    return r


@pytest.fixture(scope="module")
def ms_base():
    r, _ = _run(_ms())
    return r


@pytest.fixture(scope="module")
def bc_base():
    r, _ = _run(_bc())
    return r


def test_bases_equal_the_reference(uts_base, ms_base, bc_base):
    """The unfaulted runs every test below holds its outputs to are the
    reference package's."""
    def jrun(spec, **kw):
        with jax_make_pool("sim", max_concurrency=16) as pool:
            return jax_run_irregular(pool, spec, **kw).output
    assert uts_base.output == jrun(jax_uts_spec(JUTSParams(**UTS)),
                                   shape=JTaskShape(4, 50))
    ms = jrun(jax_ms_spec(JMSParams(**MS)))
    assert np.array_equal(ms_base.output["image"], ms["image"])
    bc = jrun(jax_bc_spec(JRMATParams(**BC), n_tasks=16))
    np.testing.assert_allclose(bc_base.output, bc, rtol=BC_RTOL,
                               atol=BC_ATOL)


# -- FaultPlan determinism -------------------------------------------------

def test_fault_plan_validation():
    with pytest.raises(ValueError):
        FaultPlan(kill_task_rate=1.5)
    with pytest.raises(ValueError):
        FaultPlan(container_mortality=-0.1)
    with pytest.raises(ValueError):
        FaultPlan(storms=((2.0, 1.0),))
    with pytest.raises(ValueError):
        FaultPlan(max_kill_attempts=0)
    FaultPlan(kill_task_rate=1.0)  # rate 1.0 is the terminal regime


def test_bound_decisions_are_seeded_and_counterbased():
    plan = FaultPlan(seed=11, kill_task_rate=0.3)
    ba, bb = plan.bind(), plan.bind()
    a = [ba.kills_attempt() for _ in range(50)]
    b = [bb.kills_attempt() for _ in range(50)]
    assert a == b                      # same seed -> same schedule
    assert any(a) and not all(a)
    c = [FaultPlan(seed=12, kill_task_rate=0.3).bind().kills_attempt()
         for _ in range(1)]
    bound = plan.bind()
    assert bound.retry_budget == plan.max_kill_attempts
    for _ in range(10):
        bound.kills_attempt()
    assert bound.decisions == 10
    assert 0 <= bound.kills <= 10
    assert isinstance(c[0], bool)


def test_fault_schedule_equals_the_reference():
    """Both packages draw the same kills, storms and jitter from a plan."""
    from repro.chaos import FaultPlan as JFaultPlan
    kw = dict(seed=11, kill_task_rate=0.3, kill_batch_rate=0.2,
              storms=((1.0, 2.0),))
    ours, ref = FaultPlan(**kw).bind(), JFaultPlan(**kw).bind()
    for i in range(200):
        assert ours.kills_attempt(batch=i % 3 == 0) == \
            ref.kills_attempt(batch=i % 3 == 0)
    assert [ours.storm_delay(t) for t in (0.5, 1.2, 1.9)] == \
        [ref.storm_delay(t) for t in (0.5, 1.2, 1.9)]


def test_storm_windows():
    bound = FaultPlan(seed=3, storms=((1.0, 2.0), (5.0, 6.0))).bind()
    assert bound.storm_until(0.5) is None
    assert bound.storm_until(1.5) == 2.0
    assert bound.storm_until(5.0) == 6.0
    assert bound.storm_delay(0.5) == 0.0
    d = bound.storm_delay(1.5)
    assert 0.5 <= d < 0.502            # window remainder + <=1ms jitter


# -- mortality invariant: results never change ----------------------------

def test_uts_mortality_bit_identical(uts_base):
    plan = FaultPlan(seed=7, kill_task_rate=0.3, container_mortality=0.3)
    r, pool = _run(_uts(), faults=plan, shape=UTS_SHAPE)
    assert r.output == uts_base.output
    assert r.worker_deaths > 0
    assert r.retries >= r.worker_deaths
    assert r.makespan_s > uts_base.makespan_s  # the mortality tax


def test_ms_mortality_bit_identical(ms_base):
    plan = FaultPlan(seed=5, container_mortality=0.3)
    r, _ = _run(_ms(), faults=plan)
    assert np.array_equal(r.output["image"], ms_base.output["image"])
    assert r.output["filled"] == ms_base.output["filled"]


def test_bc_mortality_bit_identical(bc_base):
    plan = FaultPlan(seed=5, container_mortality=0.3)
    r, _ = _run(_bc(), faults=plan)
    assert np.array_equal(r.output, bc_base.output)


def test_batch_carrier_kills(uts_base):
    """kill_batch_rate targets fused carriers; the whole wave requeues
    and the run still lands bit-identically."""
    plan = FaultPlan(seed=3, kill_batch_rate=0.4)
    r, pool = _run(_uts(), faults=plan, shape=UTS_SHAPE, batching=True)
    assert r.output == uts_base.output
    assert r.worker_deaths > 0


def test_mortality_events_on_timeline():
    plan = FaultPlan(seed=7, container_mortality=0.4)
    r, pool = _run(_uts(), faults=plan, shape=UTS_SHAPE)
    counts = pool.events.counts()
    assert counts.get(WORKER_KILLED, 0) > 0
    # every injected kill also lands the slot-freeing requeue
    assert counts.get(REQUEUE, 0) >= counts[WORKER_KILLED]
    assert pool.snapshot()["worker_deaths"] == counts[WORKER_KILLED]


def test_thread_executor_kills_and_terminal_error(uts_base):
    plan = FaultPlan(seed=5, kill_task_rate=0.3)
    with make_pool("local", max_concurrency=4, invoke_overhead=0.0,
                   faults=plan) as pool:
        r = run_irregular(pool, _uts(), shape=UTS_SHAPE)
        assert pool.stats.snapshot()["worker_deaths"] >= 0
    assert r.output == uts_base.output

    # rate 1.0 exhausts the kill retry budget -> typed terminal error
    doomed = FaultPlan(seed=1, kill_task_rate=1.0, max_kill_attempts=3)
    with make_pool("local", max_concurrency=2, invoke_overhead=0.0,
                   faults=doomed) as pool:
        f = pool.submit(lambda: 42)
        with pytest.raises(WorkerKilledError):
            f.result(timeout=30)
        assert f._task.attempts == 3
        snap = pool.stats.snapshot()
        assert snap["worker_deaths"] == 3
        assert snap["failed"] == 1


def test_cold_start_inflation():
    vts = {}
    for mult in (1.0, 5.0):
        plan = FaultPlan(seed=0, cold_start_multiplier=mult)
        pool = make_pool("sim", max_concurrency=4,
                         provider=ProviderModel.aws_lambda(),
                         faults=plan)
        run_irregular(pool, _uts(), shape=UTS_SHAPE)
        vts[mult] = pool.virtual_time_s
        pool.shutdown()
    assert vts[5.0] > vts[1.0]


# -- storms, backoff, throttled events ------------------------------------

def test_backoff_is_seeded_capped_and_resets():
    a, b = Backoff(seed=4), Backoff(seed=4)
    seq_a = [a.next() for _ in range(12)]
    seq_b = [b.next() for _ in range(12)]
    assert seq_a == seq_b              # seeded -> reproducible
    assert all(d <= 0.05 for d in seq_a)
    assert seq_a[6] > seq_a[0]         # grows until the cap
    a.reset()
    assert a.attempt == 0
    assert a.next() <= 2 * 1e-4        # back to the base tier


def test_sim_storm_throttles_but_preserves_output(uts_base):
    plan = FaultPlan(seed=9, storms=((0.0, 0.05),))
    r, pool = _run(_uts(), faults=plan, shape=UTS_SHAPE)
    assert r.output == uts_base.output
    assert pool.events.counts().get(THROTTLED, 0) >= 1
    assert pool.snapshot()["throttled"] >= 1


# -- cancellation events ---------------------------------------------------

def _boom(x):
    if x == 3:
        raise RuntimeError("nope")
    import time
    time.sleep(0.02)
    return x


def test_map_fail_fast_emits_cancel_events():
    with make_pool("local", max_concurrency=2, invoke_overhead=0.0,
                   max_attempts=1) as pool:
        with pytest.raises(RuntimeError):
            pool.map(_boom, range(12))
        counts = pool.events.counts()
        assert counts.get(CANCEL, 0) > 0
        assert pool.stats.snapshot()["cancelled"] == counts[CANCEL]
        # cancel events carry the failing parent's task id
        cancels = [e for e in pool.events.events() if e.kind == CANCEL]
        assert all(e.parent is not None for e in cancels)


def test_gather_fail_fast_cancels_remainder():
    with make_pool("local", max_concurrency=2, invoke_overhead=0.0,
                   max_attempts=1) as pool:
        # force the decomposing path: fused carriers have no siblings
        # to cancel, the countdown aggregation does
        pool.supports_batching = False
        f = pool.submit_gather(lambda xs: [_boom(x) for x in xs],
                               list(range(12)), item_fn=_boom)
        with pytest.raises(RuntimeError):
            f.result(timeout=30)
        assert pool.events.counts().get(CANCEL, 0) > 0


def test_cancel_round_trips_through_trace_and_replay():
    store = TraceStore(ring_size=32)
    with make_pool("local", max_concurrency=2, invoke_overhead=0.0,
                   max_attempts=1, trace=store) as pool:
        with pytest.raises(RuntimeError):
            pool.map(_boom, range(12))
        wl = extract_workload(store)
    # cancelled tasks are counted distinctly, not as in-flight losses
    assert wl.n_cancelled > 0
    assert wl.n_lost == 0
    store.close()


def test_new_event_kinds_serialize():
    for kind in (WORKER_KILLED, THROTTLED, CANCEL, FOLDED):
        ev = Event(kind=kind, t=1.5, task_id=7,
                   payload={"item": [1, 2], "result": {"c": 3}})
        rt = event_from_dict(event_to_dict(ev))
        assert rt.kind == kind and rt.payload == ev.payload


# -- WAL crash recovery ----------------------------------------------------

def _kill_resume(mk_spec, n_folds, **kw):
    pool = make_pool("sim", max_concurrency=16)
    with pytest.raises(MasterKilledError):
        run_irregular(pool, kill_master_after(mk_spec(), n_folds),
                      wal=True, **kw)
    trace = pool.events
    pool2 = make_pool("sim", max_concurrency=16)
    try:
        r = run_irregular(pool2, mk_spec(), resume_from=trace, **kw)
    finally:
        pool2.shutdown()
        pool.shutdown()
    return r


@pytest.mark.parametrize("n_folds", [1, 5, 12])
def test_uts_kill_resume_bit_identical(uts_base, n_folds):
    r = _kill_resume(_uts, n_folds, shape=UTS_SHAPE)
    assert r.output == uts_base.output
    assert r.recovered_tasks > 0


def test_uts_kill_resume_sharded(uts_base):
    r = _kill_resume(_uts, 7, shape=UTS_SHAPE, shards=3)
    assert r.output == uts_base.output
    assert r.shards == 3


def test_uts_kill_resume_batched(uts_base):
    """Fused chunks journal atomically: a mid-batch master kill must
    not double-count the carrier's banked work on resume."""
    r = _kill_resume(_uts, 6, shape=UTS_SHAPE, batching=True)
    assert r.output == uts_base.output


def test_ms_kill_resume_bit_identical(ms_base):
    r = _kill_resume(_ms, 4)
    assert np.array_equal(r.output["image"], ms_base.output["image"])
    assert r.output["filled"] == ms_base.output["filled"]
    assert r.output["evaluated"] == ms_base.output["evaluated"]


def test_bc_kill_resume_bit_identical(bc_base):
    r = _kill_resume(_bc, 6)
    assert np.array_equal(r.output, bc_base.output)


def test_bc_kill_resume_sharded(bc_base):
    r = _kill_resume(_bc, 6, shards=3)
    assert np.array_equal(r.output, bc_base.output)


def test_resume_from_spilled_trace_file(tmp_path, uts_base):
    """The spilled JSONL alone — what a real crash leaves behind — is a
    sufficient WAL."""
    path = str(tmp_path / "run.jsonl")
    store = TraceStore(path=path, ring_size=32)
    pool = make_pool("sim", max_concurrency=16, trace=store)
    with pytest.raises(MasterKilledError):
        run_irregular(pool, kill_master_after(_uts(), 5),
                      wal=True, shape=UTS_SHAPE)
    store.flush()
    with make_pool("sim", max_concurrency=16) as pool2:
        r = run_irregular(pool2, _uts(), shape=UTS_SHAPE, resume_from=path)
    assert r.output == uts_base.output
    store.close()


def test_recover_frontier_unit():
    pool = make_pool("sim", max_concurrency=16)
    with pytest.raises(MasterKilledError):
        run_irregular(pool, kill_master_after(_uts(), 5),
                      wal=True, shape=UTS_SHAPE)
    rec = recover_frontier(pool.events, _uts(), shape=UTS_SHAPE)
    pending, partial = rec              # tuple unpacking
    assert rec.folded == 5
    assert len(pending) > 0
    assert partial >= 0
    pool.shutdown()


def test_wal_requires_codecs():
    bare = WorkSpec(name="bare", execute=lambda item, shape: item,
                    seed=lambda shape: [1, 2],
                    reduce=lambda s, r: s + r, init=lambda: 0)
    with make_pool("sim", max_concurrency=4) as pool:
        with pytest.raises(ValueError, match="codec"):
            run_irregular(pool, bare, wal=True)


def test_resume_incompatible_with_controller_and_arrivals():
    spec = _uts()
    ctrl = StagedController(initial=UTS_SHAPE, stages=[])
    with make_pool("sim", max_concurrency=4) as pool:
        with pytest.raises(ValueError, match="controller"):
            run_irregular(pool, spec, resume_from=pool.events,
                          controller=ctrl)
        with pytest.raises(ValueError, match="arrivals"):
            run_irregular(pool, spec, resume_from=pool.events,
                          arrivals=[(0.0, None)])


def test_wal_shape_mismatch_detected():
    pool = make_pool("sim", max_concurrency=16)
    with pytest.raises(MasterKilledError):
        run_irregular(pool, kill_master_after(_uts(), 5),
                      wal=True, shape=UTS_SHAPE)
    with pytest.raises(ValueError, match="shape"):
        recover_frontier(pool.events, _uts(),
                         shape=TaskShape(split_factor=13, iters=999))
    pool.shutdown()


def test_result_accounting_fields(uts_base):
    assert uts_base.retries == 0
    assert uts_base.worker_deaths == 0
    assert uts_base.recovered_tasks == 0
    plan = FaultPlan(seed=7, container_mortality=0.3)
    r, _ = _run(_uts(), faults=plan, shape=UTS_SHAPE)
    assert r.worker_deaths > 0 and r.retries >= r.worker_deaths


# -- routing policies ------------------------------------------------------

class _StubPool:
    def __init__(self, cap, idle, pending=0):
        self.max_concurrency = cap
        self._idle = idle
        self._pending = pending
        self.provider = None
        self.invoke_overhead = 0.1

    def idle_capacity(self):
        return self._idle

    def pending(self):
        return self._pending


class _StubHybrid:
    def __init__(self, local, elastic):
        self.local = local
        self.elastic = elastic


def test_local_first_policy():
    pol = LocalFirstPolicy()
    assert pol.route(_StubHybrid(_StubPool(4, 2), _StubPool(8, 8)))
    assert not pol.route(_StubHybrid(_StubPool(4, 0), _StubPool(8, 8)))
    # instances stay plain callables (legacy predicate contract)
    assert pol(_StubHybrid(_StubPool(4, 2), _StubPool(8, 8))) is True


def test_threshold_policy():
    pol = ThresholdPolicy(cost_threshold=2.0)
    h = _StubHybrid(_StubPool(4, 2), _StubPool(8, 8))
    assert pol.route(h, cost_hint=1.0)        # small -> local
    assert not pol.route(h, cost_hint=2.0)    # big -> elastic
    h_full = _StubHybrid(_StubPool(4, 0), _StubPool(8, 8))
    assert not pol.route(h_full, cost_hint=1.0)  # saturated -> spill


def test_random_policy_deterministic():
    a = [RandomPolicy(seed=6, p_local=0.5).route(None) for _ in range(1)]
    pol1, pol2 = RandomPolicy(seed=6), RandomPolicy(seed=6)
    seq1 = [pol1.route(None) for _ in range(40)]
    seq2 = [pol2.route(None) for _ in range(40)]
    assert seq1 == seq2
    assert any(seq1) and not all(seq1)
    assert isinstance(a[0], bool)
    from repro.chaos import RandomPolicy as JRandomPolicy
    ref = JRandomPolicy(seed=6)
    assert seq1 == [ref.route(None) for _ in range(40)]


def test_least_loaded_policy():
    pol = LeastLoadedPolicy()
    # local 2/4 busy vs elastic 8/8 busy -> local
    assert pol.route(_StubHybrid(_StubPool(4, 2), _StubPool(8, 0)))
    # local full + backlog vs idle elastic -> elastic
    assert not pol.route(
        _StubHybrid(_StubPool(4, 0, pending=6), _StubPool(8, 8)))


def test_cost_per_deadline_policy():
    pol = CostPerDeadlinePolicy(deadline_s=1.0, alpha_s_per_cost=1.0)
    idle = _StubHybrid(_StubPool(4, 4), _StubPool(8, 8))
    # idle local meets the deadline at zero marginal cost
    assert pol.route(idle, cost_hint=0.5)
    # deep local backlog blows the deadline; the paid path meets it
    backed_up = _StubHybrid(_StubPool(4, 0, pending=20), _StubPool(8, 8))
    assert not pol.route(backed_up, cost_hint=0.5)
    # neither side meets it -> degrade to the faster side
    doomed = _StubHybrid(_StubPool(4, 0, pending=8), _StubPool(8, 8))
    assert not pol.route(doomed, cost_hint=2.5)
    # ... and an idle donor VM is the faster side for the same task
    assert pol.route(_StubHybrid(_StubPool(4, 4), _StubPool(8, 8)),
                     cost_hint=2.5)
    with pytest.raises(ValueError):
        CostPerDeadlinePolicy(deadline_s=0.0)


def test_make_routing_policy():
    assert isinstance(make_routing_policy("least_loaded"),
                      LeastLoadedPolicy)
    assert isinstance(make_routing_policy("cost-per-deadline",
                                          deadline_s=0.5),
                      CostPerDeadlinePolicy)
    with pytest.raises(ValueError, match="unknown routing policy"):
        make_routing_policy("nope")


def test_hybrid_accepts_routing_policy(uts_base):
    pol = make_routing_policy("least-loaded")
    with make_pool("hybrid", local_concurrency=2, elastic_concurrency=8,
                   policy=pol) as pool:
        r = run_irregular(pool, _uts(), shape=UTS_SHAPE)
        placed = pool.placement_counts()
    assert r.output == uts_base.output
    assert placed["local"] + placed["elastic"] == r.tasks


def test_hybrid_legacy_callable_policy_still_works(uts_base):
    with make_pool("hybrid", local_concurrency=2, elastic_concurrency=8,
                   policy=lambda h: False) as pool:
        r = run_irregular(pool, _uts(), shape=UTS_SHAPE)
        placed = pool.placement_counts()
    assert r.output == uts_base.output
    assert placed["local"] == 0 and placed["elastic"] == r.tasks


def test_hybrid_forwards_faults_to_subpools(uts_base):
    plan = FaultPlan(seed=2, kill_task_rate=0.2)
    with make_pool("hybrid", local_concurrency=2, elastic_concurrency=8,
                   faults=plan) as pool:
        r = run_irregular(pool, _uts(), shape=UTS_SHAPE)
        deaths = pool.stats.worker_deaths
    assert r.output == uts_base.output
    assert deaths > 0


# -- WAL segment checkpointing ---------------------------------------------

def test_checkpoint_requires_codecs_and_single_master():
    spec = _uts()
    bare = spec.__class__(**{**spec.__dict__, "decode_item": None,
                             "encode_state": None, "decode_state": None})
    pool = make_pool("sim", max_concurrency=4)
    with pytest.raises(ValueError, match="checkpoint codecs"):
        run_irregular(pool, bare, shape=UTS_SHAPE, checkpoint_every=5)
    with pytest.raises(ValueError, match="single-master"):
        run_irregular(pool, spec, shape=UTS_SHAPE, checkpoint_every=5,
                      shards=2)
    with pytest.raises(ValueError, match="requires wal"):
        run_irregular(pool, spec, shape=UTS_SHAPE, checkpoint_every=5,
                      wal=False)
    with pytest.raises(ValueError, match=">= 1"):
        run_irregular(pool, spec, shape=UTS_SHAPE, checkpoint_every=0)


def test_checkpointed_output_unchanged(uts_base):
    r, pool = _run(_uts(), shape=UTS_SHAPE, wal=True, checkpoint_every=7)
    assert r.output == uts_base.output
    assert len(pool.events.events(CHECKPOINT)) > 0


def test_checkpoint_kill_resume_replays_tail_only(uts_base):
    pool = make_pool("sim", max_concurrency=16)
    with pytest.raises(MasterKilledError):
        run_irregular(pool, kill_master_after(_uts(), 40),
                      shape=UTS_SHAPE, checkpoint_every=5)
    n_ckpt = len(pool.events.events(CHECKPOINT))
    n_folds = sum(len(e.payload.get("batch", [e.payload]))
                  for e in pool.events.events(FOLDED))
    assert n_ckpt >= 2 and n_folds == 40
    rec = recover_frontier(pool.events, _uts(), shape=UTS_SHAPE)
    assert rec.checkpointed
    # tail-only: strictly fewer replayed folds than the journal holds
    assert rec.folded < n_folds
    resumed, _ = _run(_uts(), shape=UTS_SHAPE, resume_from=pool.events)
    assert resumed.output == uts_base.output


def test_checkpoint_recovery_without_codecs_fails():
    pool = make_pool("sim", max_concurrency=16)
    with pytest.raises(MasterKilledError):
        run_irregular(pool, kill_master_after(_uts(), 40),
                      shape=UTS_SHAPE, checkpoint_every=5)
    spec = _uts()
    bare = spec.__class__(**{**spec.__dict__, "decode_item": None,
                             "decode_state": None})
    with pytest.raises(ValueError, match="checkpoint"):
        recover_frontier(pool.events, bare, shape=UTS_SHAPE)


def test_hundred_thousand_event_journal_recovers_from_tail():
    """A 10^5-event journal with a late checkpoint must recover in
    O(tail): the replay touches only folds past the checkpoint."""
    N, TAIL, UNFOLDED = 100_000, 1_000, 100
    calls = {"reduce": 0, "decode": 0}

    def counting_spec():
        def reduce(s, r):
            calls["reduce"] += 1
            return s + r

        def decode(e):
            calls["decode"] += 1
            return e

        return WorkSpec(
            name="sumN", execute=lambda it, sh: it,
            seed=lambda sh: range(N), reduce=reduce, init=lambda: 0,
            encode_item=lambda it: it, encode_result=lambda r: r,
            decode_result=decode, decode_item=lambda e: e,
            encode_state=lambda s: s, decode_state=lambda e: e)

    log = EventLog(clock=VirtualClock())
    head = N - TAIL
    for i in range(head):
        log.emit(FOLDED, payload={"item": i, "result": i})
    log.emit(CHECKPOINT, payload={"state": sum(range(head)),
                                  "pending": list(range(head, N))})
    for i in range(head, N - UNFOLDED):
        log.emit(FOLDED, payload={"item": i, "result": i})
    assert len(log) >= 99_000
    rec = recover_frontier(log, counting_spec(), shape=TaskShape(1, 1))
    assert rec.checkpointed
    assert rec.folded == TAIL - UNFOLDED
    assert calls["reduce"] == TAIL - UNFOLDED       # tail only
    assert calls["decode"] == TAIL - UNFOLDED
    assert rec.pending == list(range(N - UNFOLDED, N))
    assert rec.partial == sum(range(N - UNFOLDED))


# -- sharded mid-steal master crash ----------------------------------------

def test_kill_on_steal_fires_and_resumes_bit_identical(uts_base):
    pool = make_pool("sim", max_concurrency=16)
    with pytest.raises(MasterKilledError, match="steal"):
        run_irregular(pool,
                      kill_master_after(_uts(), 10**9, kill_on_steal=2),
                      shape=UTS_SHAPE, shards=4, wal=True)
    resumed, _ = _run(_uts(), shape=UTS_SHAPE, shards=4,
                      resume_from=pool.events)
    assert resumed.output == uts_base.output
    assert resumed.recovered_tasks > 0


def test_kill_on_steal_ignored_by_single_master(uts_base):
    # the hook only arms the sharded steal path; shards=1 never steals
    r, _ = _run(kill_master_after(_uts(), 10**9, kill_on_steal=1),
                shape=UTS_SHAPE, wal=True)
    assert r.output == uts_base.output


# -- wall-pool chunk-atomic journaling -------------------------------------

def test_local_batched_wal_every_prefix_recoverable(uts_base):
    """On thread pools a chunk's slots settle across drain batches; with
    chunk-children deferral, every folded-event prefix is a consistent
    recovery point."""
    pool = make_pool("local", max_concurrency=4)
    try:
        r = run_irregular(pool, _uts(), shape=UTS_SHAPE,
                          batching=True, wal=True)
        events = pool.events.events()
    finally:
        pool.shutdown()
    assert r.output == uts_base.output
    checked = 0
    for i, ev in enumerate(events):
        if ev.kind != FOLDED:
            continue
        checked += 1
        rec = recover_frontier(events[:i + 1], _uts(),
                               shape=UTS_SHAPE)  # must not raise
        assert rec.folded >= 1
    assert checked >= 2


def test_sim_batched_checkpoint_defers_past_partial_chunks(uts_base):
    # batching + checkpointing compose: checkpoints only land at cuts
    # with no partially-folded chunk, and resume stays bit-identical
    pool = make_pool("sim", max_concurrency=16)
    with pytest.raises(MasterKilledError):
        run_irregular(pool, kill_master_after(_uts(), 30),
                      shape=UTS_SHAPE, batching=True, checkpoint_every=4)
    resumed, _ = _run(_uts(), shape=UTS_SHAPE, batching=True,
                      resume_from=pool.events)
    assert resumed.output == uts_base.output


# -- the WAL across the two packages ---------------------------------------

#: name -> (port spec, reference spec, run keywords of each, master kill)
_SHAPE_KW = ({"shape": UTS_SHAPE}, {"shape": JTaskShape(4, 50)})
_CASES = {
    "uts": (_uts, lambda: jax_uts_spec(JUTSParams(**UTS)), _SHAPE_KW, {}, 5),
    "uts_checkpointed": (_uts, lambda: jax_uts_spec(JUTSParams(**UTS)),
                         _SHAPE_KW, {"checkpoint_every": 5}, 40),
    "uts_shards": (_uts, lambda: jax_uts_spec(JUTSParams(**UTS)),
                   _SHAPE_KW, {"shards": 3}, 7),
    "ms": (_ms, lambda: jax_ms_spec(JMSParams(**MS)), ({}, {}), {}, 4),
    "bc": (_bc, lambda: jax_bc_spec(JRMATParams(**BC), n_tasks=16),
           ({}, {}), {}, 6),
}
#: one package's entry points, by name
_PKGS = {
    "repro_torch": (make_pool, run_irregular, kill_master_after, TraceStore),
    "repro": (jax_make_pool, jax_run_irregular, jax_kill_master_after,
              JTraceStore),
}


def _same(name, got, want):
    if name.startswith("uts"):
        return got == want
    if name == "ms":
        return (np.array_equal(got["image"], want["image"])
                and got["filled"] == want["filled"]
                and got["evaluated"] == want["evaluated"])
    return np.allclose(got, want, rtol=BC_RTOL, atol=BC_ATOL)


@pytest.mark.parametrize("writer,reader", [("repro", "repro_torch"),
                                           ("repro_torch", "repro")])
@pytest.mark.parametrize("name", sorted(_CASES))
def test_journal_resumes_in_the_other_package(tmp_path, name, writer,
                                              reader):
    """A master killed in one package leaves a spilled journal that the
    other package resumes: UTS and MS bit-identical to the writer's
    unkilled run, BC within the reference's tolerances of both packages'
    unkilled runs."""
    port_mk, ref_mk, (port_kw, ref_kw), run_kw, n_folds = _CASES[name]
    mk = {"repro_torch": (port_mk, port_kw), "repro": (ref_mk, ref_kw)}

    def unkilled(pkg):
        make, run, _, _ = _PKGS[pkg]
        spec, kw = mk[pkg]
        with make("sim", max_concurrency=16) as pool:
            return run(pool, spec(), **kw,
                       **{k: v for k, v in run_kw.items()
                          if k == "shards"}).output

    path = str(tmp_path / "wal.jsonl")
    make, run, kill, Store = _PKGS[writer]
    spec, kw = mk[writer]
    store = Store(path=path, ring_size=64)
    pool = make("sim", max_concurrency=16, trace=store)
    with pytest.raises(Exception) as killed:
        run(pool, kill(spec(), n_folds), wal=True, **kw, **run_kw)
    assert type(killed.value).__name__ == "MasterKilledError"
    store.flush()
    make, run, _, _ = _PKGS[reader]
    spec, kw = mk[reader]
    with make("sim", max_concurrency=16) as pool2:
        r = run(pool2, spec(), resume_from=path, **kw,
                **{k: v for k, v in run_kw.items() if k == "shards"})
    pool.shutdown()
    store.close()
    assert r.recovered_tasks > 0
    assert _same(name, r.output, unkilled(writer))
    if name == "bc":
        assert _same(name, r.output, unkilled(reader))


@pytest.mark.parametrize("name", ["uts", "ms"])
def test_both_packages_journal_the_same_folds(name):
    """The same run journals the same ``folded`` payloads, in order, in
    either package."""
    port_mk, ref_mk, (port_kw, ref_kw), _, _ = _CASES[name]
    payloads = {}
    for pkg, mk, kw in (("repro_torch", port_mk, port_kw),
                        ("repro", ref_mk, ref_kw)):
        make, run, _, _ = _PKGS[pkg]
        with make("sim", max_concurrency=16) as pool:
            run(pool, mk(), wal=True, **kw)
            payloads[pkg] = [e.payload for e in pool.events.events(FOLDED)]
    assert len(payloads["repro"]) > 10
    assert payloads["repro_torch"] == payloads["repro"]
