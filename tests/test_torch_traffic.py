"""The port's ``repro_torch.traffic`` on the CPU: a twin of each test of
``tests/test_traffic.py`` (workload generation, A0-A5 residency, open-loop
serving, SLO autoscale, parent-exact trace replay).  Every twin runs the
reference's case through both packages on the same seeded inputs: the
reference's assertions hold for each, and the port's values equal the
JAX package's (streams bit for bit, reports and virtual seconds float for
float)."""
import importlib
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st


def _pkg(root: str) -> SimpleNamespace:
    def imp(name):
        return importlib.import_module(f"{root}.{name}")
    traffic, residency = imp("traffic"), imp("traffic.residency")
    tel, replay = imp("core.telemetry"), imp("trace.replay")
    irregular = imp("core.irregular")
    return SimpleNamespace(
        **{k: getattr(traffic, k) for k in traffic.__all__},
        **{k: getattr(residency, k) for k in
           ("LOST_BUSY", "LOST_COLD_BLOCKED", "LOST_NO_MEMORY")},
        **{k: getattr(tel, k) for k in
           ("COMPLETE", "PARENT_ROOT", "SUBMIT", "Event", "EventLog")},
        TaskRecord=imp("core.futures").TaskRecord,
        ProviderModel=imp("core.provider").ProviderModel,
        SimPool=imp("core.simpool").SimPool,
        extract_workload=replay.extract_workload, replay=replay.replay,
        WorkSpec=irregular.WorkSpec, run_irregular=irregular.run_irregular,
        make_pool=imp("core").make_pool)


J, T = _pkg("repro"), _pkg("repro_torch")


def both(case, *args):
    """``case`` run through the reference and the port: equal results."""
    want, got = case(J, *args), case(T, *args)
    assert got == want
    return got


def _tenants(m):
    return [
        m.TenantSpec("chat", m.ArrivalModel(kind="poisson", rate=2.0)),
        m.TenantSpec("burst", m.ArrivalModel(kind="mmpp", rate=0.5,
                                             burst_rate=8.0, calm_s=5.0,
                                             burst_s=2.0),
                     prompt_len=m.LengthModel(kind="pareto", mean=200.0,
                                              alpha=1.3, hi=4096)),
    ]


def _key(stream):
    return [(r.rid, r.tenant, r.arrival_s, r.prompt_len, r.decode_len)
            for r in stream]


# -- workload generation -----------------------------------------------------

def test_stream_bit_deterministic():
    def case(m):
        a = m.generate_stream(_tenants(m), horizon_s=50.0, seed=7)
        b = m.generate_stream(_tenants(m), horizon_s=50.0, seed=7)
        assert _key(a) == _key(b)
        c = m.generate_stream(_tenants(m), horizon_s=50.0, seed=8)
        assert _key(a) != _key(c)
        return _key(a), _key(c)
    both(case)


def test_stream_sorted_and_rids_in_order():
    def case(m):
        s = m.generate_stream(_tenants(m), horizon_s=50.0, seed=3)
        assert [r.rid for r in s] == list(range(len(s)))
        assert all(s[i].arrival_s <= s[i + 1].arrival_s
                   for i in range(len(s) - 1))
        assert all(0.0 <= r.arrival_s < 50.0 for r in s)
        return _key(s)
    both(case)


def test_adding_tenant_does_not_perturb_others():
    def case(m):
        solo = m.generate_stream(_tenants(m)[:1], horizon_s=40.0, seed=5)
        two = m.generate_stream(_tenants(m), horizon_s=40.0, seed=5)
        chat = [(r.arrival_s, r.prompt_len, r.decode_len)
                for r in two if r.tenant == "chat"]
        assert chat == [(r.arrival_s, r.prompt_len, r.decode_len)
                        for r in solo]
        return _key(two)
    both(case)


def test_poisson_rate_roughly_matches():
    def case(m):
        s = m.generate_stream(
            [m.TenantSpec("t", m.ArrivalModel(kind="poisson", rate=5.0))],
            horizon_s=200.0, seed=0)
        assert 600 <= len(s) <= 1400  # 1000 expected, very loose CI
        return _key(s)
    both(case)


def test_trace_arrival_model():
    def case(m):
        am = m.ArrivalModel(kind="trace", times=(3.0, 1.0, 99.0, -1.0, 2.0))
        got = am.arrivals(10.0, np.random.default_rng(0))
        assert got == [1.0, 2.0, 3.0]
        with pytest.raises(ValueError):
            m.ArrivalModel(kind="nope").arrivals(1.0,
                                                 np.random.default_rng(0))
        return got
    both(case)


def test_length_models_clip_and_tail():
    def case(m):
        rng = np.random.default_rng(1)
        ln = m.LengthModel(kind="lognormal", mean=64.0, sigma=1.0, lo=4,
                           hi=512)
        xs = [ln.sample(rng) for _ in range(500)]
        assert all(4 <= x <= 512 for x in xs)
        pr = m.LengthModel(kind="pareto", mean=100.0, alpha=1.3, lo=1,
                           hi=100_000)
        ys = [pr.sample(rng) for _ in range(2000)]
        s = sorted(ys)
        med = s[len(s) // 2]
        assert sum(s) / len(s) > 1.5 * med  # heavy tail: mean >> median
        assert 30 <= med <= 300
        with pytest.raises(ValueError):
            m.LengthModel(kind="nope").sample(rng)
        return xs, ys
    both(case)


def test_stream_save_load_roundtrip(tmp_path):
    def case(m, tag):
        s = m.generate_stream(_tenants(m), horizon_s=30.0, seed=2)
        p = str(tmp_path / f"stream_{tag}.jsonl")
        assert m.save_stream(s, p) == len(s)
        assert _key(m.load_stream(p)) == _key(s)
        return _key(s), open(p).read()
    want, got = case(J, "jax"), case(T, "torch")
    assert got == want
    # each package loads the other's file to the same stream
    assert _key(T.load_stream(str(tmp_path / "stream_jax.jsonl"))) == \
        _key(J.load_stream(str(tmp_path / "stream_torch.jsonl")))


def test_scale_rate_scales_offered_load():
    def case(m):
        lo = m.generate_stream(m.scale_rate(_tenants(m), 1.0),
                               horizon_s=100.0, seed=4)
        hi = m.generate_stream(m.scale_rate(_tenants(m), 4.0),
                               horizon_s=100.0, seed=4)
        assert 2.5 * len(lo) < len(hi) < 6.0 * len(lo)
        tr = m.scale_rate([m.TenantSpec("t", m.ArrivalModel(
            kind="trace", times=(2.0, 4.0)))], 2.0)
        assert tr[0].arrival.times == (1.0, 2.0)
        return _key(lo), _key(hi)
    both(case)


# -- residency: FaaS_Sim A0-A5 ----------------------------------------------

def _prov(m):
    return m.ProviderModel.aws_lambda(keep_alive_s=10.0)


def _mb(m):
    return float(_prov(m).memory_mb)


def _adm(a):
    return (a.tenant, a.kind, a.cid, a.overhead_s, a.reason, a.lost)


def test_a0_memory_starts_empty():
    def case(m):
        r = m.ResidencyModel(_prov(m),
                             m.ResidencyConfig(memory_capacity_mb=4 * _mb(m)))
        assert r.resident_mb(0.0) == 0.0 and not r.fleets
        return r.snapshot(0.0)
    both(case)


def test_a5_overheads_warm_vs_cold():
    def case(m):
        prov = _prov(m)
        r = m.ResidencyModel(prov, m.ResidencyConfig())
        cold = r.admit("t", 0.0)
        assert cold.kind == "cold"
        assert cold.overhead_s == pytest.approx(prov.warm_overhead_s
                                                + prov.cold_start_s)
        r.release("t", cold.cid, 1.0)
        warm = r.admit("t", 1.5)
        assert warm.kind == "warm" and warm.cid == cold.cid
        assert warm.overhead_s == pytest.approx(prov.warm_overhead_s)
        return _adm(cold), _adm(warm), r.snapshot(1.5)
    both(case)


def test_a2_a3_per_tenant_cap():
    def case(m):
        prov = _prov(m)
        r = m.ResidencyModel(prov, m.ResidencyConfig(max_per_tenant=1))
        a = r.admit("t", 0.0)
        assert a.kind == "cold"
        blocked = r.admit("t", 0.1)
        assert blocked.lost and blocked.reason == m.LOST_COLD_BLOCKED
        busy = r.admit("t", prov.cold_start_s + 1.0)
        assert busy.lost and busy.reason == m.LOST_BUSY
        r.release("t", a.cid, 2.0)
        warm = r.admit("t", 2.5)
        assert warm.kind == "warm"
        return [_adm(x) for x in (a, blocked, busy, warm)], r.snapshot(2.5)
    both(case)


def test_a1_evicts_longest_idle_across_tenants():
    def case(m):
        r = m.ResidencyModel(_prov(m),
                             m.ResidencyConfig(memory_capacity_mb=2 * _mb(m)))
        a = r.admit("a", 0.0)
        b = r.admit("b", 0.5)
        r.release("a", a.cid, 1.0)
        r.release("b", b.cid, 2.0)
        c = r.admit("c", 3.0)
        assert c.kind == "cold"
        assert r.fleets["a"].evictions == 1
        assert r.fleets["b"].evictions == 0
        again = r.admit("b", 3.5)
        assert again.kind == "warm"
        return [_adm(x) for x in (a, b, c, again)], r.snapshot(3.5)
    both(case)


def test_a1_no_idle_means_lost():
    def case(m):
        r = m.ResidencyModel(_prov(m),
                             m.ResidencyConfig(memory_capacity_mb=2 * _mb(m)))
        r.admit("a", 0.0)
        r.admit("b", 0.0)
        lost = r.admit("c", 0.1)
        assert lost.lost and lost.reason == m.LOST_NO_MEMORY
        return _adm(lost), r.snapshot(0.1)
    both(case)


def test_a4_busy_and_cold_containers_unevictable():
    def case(m):
        r = m.ResidencyModel(_prov(m),
                             m.ResidencyConfig(memory_capacity_mb=_mb(m)))
        a = r.admit("a", 0.0)
        assert not a.lost
        lost = r.admit("b", 0.05)
        assert lost.lost and lost.reason == m.LOST_NO_MEMORY
        assert r.fleets["a"].idle_ids(0.05) == []
        return _adm(a), _adm(lost)
    both(case)


def test_keep_alive_expiry_frees_memory():
    def case(m):
        prov = _prov(m)
        r = m.ResidencyModel(prov, m.ResidencyConfig(memory_capacity_mb=_mb(m)))
        a = r.admit("a", 0.0)
        r.release("a", a.cid, 1.0)
        assert r.admit("b", 2.0).kind == "cold"
        r2 = m.ResidencyModel(prov,
                              m.ResidencyConfig(memory_capacity_mb=_mb(m)))
        a2 = r2.admit("a", 0.0)
        r2.release("a", a2.cid, 1.0)
        late = r2.admit("b", 1.0 + prov.keep_alive_s + 1.0)
        assert late.kind == "cold"
        assert r2.fleets["a"].evictions == 0
        return r.snapshot(2.0), _adm(late), r2.snapshot(12.0)
    both(case)


@settings(max_examples=15)
@given(st.lists(st.tuples(st.integers(0, 2), st.integers(0, 1),
                          st.integers(1, 50)),
                min_size=1, max_size=60),
       st.integers(2, 5))
def test_residency_invariants_hold_under_random_ops(ops, cap_containers):
    def case(m):
        cfg = m.ResidencyConfig(memory_capacity_mb=cap_containers * _mb(m))
        r = m.ResidencyModel(_prov(m), cfg)
        tenants = ["t0", "t1", "t2"]
        outstanding, trail = [], []
        now, n_admit_calls = 0.0, 0
        for tenant_i, do_release, dt in ops:
            now += dt / 10.0
            if do_release and outstanding:
                t, cid = outstanding.pop(0)
                r.release(t, cid, now)
            else:
                n_admit_calls += 1
                adm = r.admit(tenants[tenant_i], now)
                trail.append(_adm(adm))
                if not adm.lost:
                    outstanding.append((adm.tenant, adm.cid))
            assert r.resident_mb(now) <= cfg.memory_capacity_mb + 1e-9
            assert r.busy_count() == len(outstanding)
            for t, f in r.fleets.items():
                busy_cids = {cid for tt, cid in outstanding if tt == t}
                assert busy_cids.isdisjoint(set(f.idle_ids(now)))
        snap = r.snapshot(now)
        assert (snap["admitted_warm"] + snap["admitted_cold"]
                + sum(snap["lost"].values())) == n_admit_calls
        assert snap["busy"] == len(outstanding)
        return trail, snap
    both(case)


# -- open-loop serving harness ----------------------------------------------

def _engine(m):
    return m.EngineModel(prefill_s_per_token=5e-4, decode_s_per_token=5e-3)


def _mini_stream(m, factor=1.0, horizon=20.0, seed=11):
    return m.generate_stream(m.scale_rate(_tenants(m), factor),
                             horizon_s=horizon, seed=seed)


def test_serve_open_loop_deterministic():
    def case(m):
        a = m.serve_open_loop(_mini_stream(m), engine=_engine(m), capacity=4)
        b = m.serve_open_loop(_mini_stream(m), engine=_engine(m), capacity=4)
        assert a.as_dict() == b.as_dict()
        assert a.completed + sum(a.lost.values()) == a.n_requests
        assert a.makespan_s > 0 and a.provisioned_usd > 0
        return a.as_dict()
    both(case)


def test_serve_open_loop_preserves_idle_gaps():
    def case(m):
        stream = _mini_stream(m, horizon=30.0)
        rep = m.serve_open_loop(stream, engine=_engine(m), capacity=64)
        total_service = sum(r.service_s for r in stream)
        assert rep.makespan_s > max(r.arrival_s for r in stream) - 1.0
        assert rep.makespan_s > 2 * total_service / 64
        return rep.as_dict()
    both(case)


def test_loss_under_overload():
    def case(m):
        rep = m.serve_open_loop(
            _mini_stream(m, factor=8.0), engine=_engine(m),
            residency_cfg=m.ResidencyConfig(memory_capacity_mb=8 * _mb(m),
                                            max_per_tenant=4),
            capacity=4)
        assert rep.loss_rate > 0.05
        assert rep.completed + sum(rep.lost.values()) == rep.n_requests
        return rep.as_dict()
    both(case)


def test_knee_p99_rises_with_offered_load():
    def case(m):
        lo = m.serve_open_loop(_mini_stream(m, 1.0, horizon=40.0),
                               engine=_engine(m), capacity=6)
        hi = m.serve_open_loop(_mini_stream(m, 8.0, horizon=40.0),
                               engine=_engine(m), capacity=6)
        assert hi.ttft_p99_s > 1.5 * lo.ttft_p99_s
        return lo.as_dict(), hi.as_dict()
    both(case)


def test_slo_autoscale_holds_target_cheaper_than_static_peak():
    def case(m):
        stream = _mini_stream(m, 4.0, horizon=40.0)
        target = 2.5
        slo = m.serve_open_loop(
            stream, engine=_engine(m), capacity=2,
            autoscale=m.SLOAutoscalePolicy(
                min_capacity=2, max_capacity=128, target_p99_ttft_s=target,
                grow_cooldown_s=0.25, shrink_cooldown_s=2.0))
        static = m.serve_open_loop(stream, engine=_engine(m),
                                   capacity=max(slo.peak_capacity, 3))
        assert slo.resizes > 0
        assert slo.ttft_p99_s <= target
        assert slo.provisioned_usd < static.provisioned_usd
        assert slo.cost_per_token_usd < static.cost_per_token_usd
        return slo.as_dict(), static.as_dict()
    both(case)


def test_slo_policy_defers_then_reacts():
    def case(m):
        pol = m.SLOAutoscalePolicy(min_capacity=1, max_capacity=64,
                                   target_p99_ttft_s=1.0, min_observations=4)
        first = pol.decide(pending=5, idle=0, capacity=4, now=0.0)
        assert first > 4
        for t in (3.0, 3.1, 3.2, 3.3):
            pol.observe_ttft(t, now=0.0)
        grown = pol.decide(pending=2, idle=0, capacity=4, now=1.0)
        assert grown > 4
        pol2 = m.SLOAutoscalePolicy(min_capacity=1, max_capacity=64,
                                    target_p99_ttft_s=10.0,
                                    min_observations=4)
        for t in (0.1, 0.1, 0.1, 0.2):
            pol2.observe_ttft(t, now=0.0)
        shrunk = pol2.decide(pending=0, idle=8, capacity=10, now=1.0)
        assert shrunk < 10
        return first, grown, shrunk
    both(case)


def test_p_quantile_order_statistic():
    def case(m):
        xs = list(range(1, 101))
        got = (m.p_quantile([], 0.99), m.p_quantile([5.0], 0.5),
               m.p_quantile(xs, 0.99), m.p_quantile(xs, 0.50))
        assert got == (0.0, 5.0, 99, 50)
        return got
    both(case)


# -- serving trace -> open-loop replay ---------------------------------------

def test_serving_trace_replays_open_loop_exactly():
    def case(m):
        stream = _mini_stream(m, 1.0, horizon=25.0)
        log = m.EventLog()
        rep = m.serve_open_loop(stream, engine=_engine(m), capacity=8,
                                trace=log)
        wl = m.extract_workload(log)
        assert wl.has_parents and wl.open_loop
        assert wl.n_tasks == rep.completed
        assert max(r.arrival_s for r in wl.roots) > 1.0
        res = m.replay(wl, max_concurrency=8, invoke_overhead=0.0)
        assert abs(res.makespan_s - rep.makespan_s) <= 0.01 * rep.makespan_s
        closed = m.replay(wl, max_concurrency=8, invoke_overhead=0.0,
                          honor_arrivals=False)
        assert closed.makespan_s < 0.5 * res.makespan_s
        return (rep.as_dict(), wl.n_tasks, res.makespan_s, res.cost.total,
                closed.makespan_s, closed.cost.total)
    both(case)


def _ev(m, t, kind, tid=None, parent=None, rec=None):
    return m.Event(t=t, kind=kind, task_id=tid, parent=parent, record=rec)


def _done(m, t0, t1, tid):
    return m.TaskRecord(task_id=tid, worker="w", submit_time=t0,
                        start_time=t0, end_time=t1, cost_hint=1.0,
                        remote=True)


def _tree(wl):
    return sorted((t.task_id, t.body_s, [c.task_id for c in t.children])
                  for t in wl.all_tasks())


def test_explicit_parents_beat_heuristic_attribution():
    def case(m):
        evs = [
            _ev(m, 0.0, m.SUBMIT, 1, parent=m.PARENT_ROOT),
            _ev(m, 0.0, m.SUBMIT, 2, parent=m.PARENT_ROOT),
            _ev(m, 1.0, m.COMPLETE, 1, rec=_done(m, 0.0, 1.0, 1)),
            _ev(m, 2.0, m.COMPLETE, 2, rec=_done(m, 0.0, 2.0, 2)),
            _ev(m, 2.1, m.SUBMIT, 3, parent=1),
            _ev(m, 3.0, m.COMPLETE, 3, rec=_done(m, 2.1, 3.0, 3)),
        ]
        wl = m.extract_workload(evs)
        assert wl.has_parents
        by_id = {t.task_id: t for t in wl.all_tasks()}
        assert [c.task_id for c in by_id[1].children] == [3]
        assert by_id[2].children == []
        assert sorted(r.task_id for r in wl.roots) == [1, 2]
        return _tree(wl)
    both(case)


def test_legacy_traces_fall_back_to_heuristic():
    def case(m):
        evs = [
            _ev(m, 0.0, m.SUBMIT, 1),
            _ev(m, 1.0, m.COMPLETE, 1, rec=_done(m, 0.0, 1.0, 1)),
            _ev(m, 1.0, m.SUBMIT, 2),
            _ev(m, 2.0, m.COMPLETE, 2, rec=_done(m, 1.0, 2.0, 2)),
        ]
        wl = m.extract_workload(evs)
        assert not wl.has_parents and not wl.open_loop
        by_id = {t.task_id: t for t in wl.all_tasks()}
        assert [c.task_id for c in by_id[1].children] == [2]
        assert [r.task_id for r in wl.roots] == [1]
        return _tree(wl)
    both(case)


def test_run_irregular_records_parent_ids():
    def case(m):
        spec = m.WorkSpec(
            name="fanout",
            execute=lambda item, shape: item,
            seed=lambda shape: [1, 2],
            split=lambda result, shape: ([result * 10]
                                         if result < 10 else []),
            reduce=lambda s, r: s + 1, init=lambda: 0)
        pool = m.SimPool(max_concurrency=4, invoke_overhead=1e-3)
        m.run_irregular(pool, spec)
        submits = pool.events.events(m.SUBMIT)
        assert all(e.parent is not None for e in submits)
        roots = [e for e in submits if e.parent == m.PARENT_ROOT]
        children = [e for e in submits if e.parent >= 0]
        assert len(roots) == 2 and len(children) == 2
        pool.shutdown()
        # task ids count per process: compare the tree, renumbered
        order = {e.task_id: i for i, e in enumerate(submits)}
        return [(e.t, order[e.task_id], order.get(e.parent, e.parent))
                for e in submits]
    both(case)


def test_run_irregular_arrivals_requires_run_until():
    def case(m):
        spec = m.WorkSpec(name="x", execute=lambda i, s: i,
                          seed=lambda s: [], split=lambda r, s: [],
                          reduce=lambda s, r: s, init=lambda: 0)
        with m.make_pool("local", max_concurrency=1) as pool:
            with pytest.raises(ValueError) as err:
                m.run_irregular(pool, spec, arrivals=[(0.0, 1)])
        return str(err.value)
    both(case)


def test_run_irregular_open_loop_arrivals():
    def case(m):
        spec = m.WorkSpec(name="arrive", execute=lambda i, s: i,
                          seed=lambda s: [], split=lambda r, s: [],
                          reduce=lambda s, r: s + 1, init=lambda: 0)
        pool = m.SimPool(max_concurrency=2, invoke_overhead=0.0,
                         duration_fn=lambda task, r: 0.5)
        res = m.run_irregular(pool, spec,
                              arrivals=[(0.0, 1), (5.0, 2), (10.0, 3)])
        assert res.output == 3
        assert res.makespan_s >= 10.0
        pool.shutdown()
        return res.output, res.makespan_s, res.cost.total
    both(case)


# -- the serving_knee row, through both packages ----------------------------

def _load(name, rel):
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        name, Path(__file__).resolve().parents[1] / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serving_knee_row_equals_the_reference():
    """``benchmarks/run.py``'s ``serving_knee`` (the JAX package) and
    ``chip_smoke.py``'s port of it at the row's shapes give the same
    derived values, which are the ones the smoke run holds the card to."""
    bench = _load("bench_run", "benchmarks/run.py")
    smoke = _load("chip_smoke", "chip_smoke.py")
    bench.serving_knee()
    want = bench.JSON_ROWS[-1]["derived"]
    assert smoke.serving_knee_row() == want
    assert smoke.SERVING_KNEE_ROW == want
