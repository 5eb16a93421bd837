"""The port's ``repro_torch.trace.replay`` and ``trace.calibrate`` on the
CPU: a twin of each replay and calibration test of ``tests/test_trace.py``
and of its Fig. 4 renderer tests.  Every twin runs the reference's case
through both packages on the same inputs (a UTS run recorded on a sim
pool, a hand-built timeline, a saturating synthetic workload): the
reference's assertions hold for each, and the port's recorded and
replayed virtual makespans and dollars, extracted workloads and fitted
providers equal the JAX package's, float for float.  Then a UTS timeline
recorded by either package replays in the other to the same numbers."""
import dataclasses
import importlib
import os
from types import SimpleNamespace

import pytest
import torch


def _pkg(root: str) -> SimpleNamespace:
    def imp(name):
        return importlib.import_module(f"{root}.{name}")
    trace, core, tel = imp("trace"), imp("core"), imp("core.telemetry")
    return SimpleNamespace(
        **{k: getattr(trace, k) for k in trace.__all__},
        **{k: getattr(tel, k) for k in
           ("CAPACITY_GROW", "COMPLETE", "START", "SUBMIT")},
        EventLog=core.EventLog, VirtualClock=core.VirtualClock,
        ProviderModel=core.ProviderModel, TaskShape=core.TaskShape,
        AutoscalePolicy=core.AutoscalePolicy, make_pool=core.make_pool,
        run_irregular=core.run_irregular,
        TaskRecord=imp("core.futures").TaskRecord,
        algorithms=imp("algorithms"),
        device={} if root == "repro" else {"device": torch.device("cpu")})


J, T = _pkg("repro"), _pkg("repro_torch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; PyTorch's intra-op threads would
    oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(case, *args):
    """``case`` run through the reference and the port: equal results."""
    want, got = case(J, *args), case(T, *args)
    assert got == want
    return got


def _run(r):
    """A run's virtual outcome: tasks, makespan, dollars, cold starts."""
    return (r.output, r.tasks, r.makespan_s, r.cost.total, r.cold_starts)


# -- replay: same-provider fidelity, what-if ------------------------------

def _recorded_uts_run(m, path, provider, max_depth=7):
    p = m.algorithms.UTSParams(seed=19, b0=4.0, max_depth=max_depth,
                               chunk=512)
    store = m.TraceStore(ring_size=256, path=str(path))
    pool = m.make_pool("sim", max_concurrency=64, provider=provider,
                       trace=store)
    r = m.run_irregular(pool, m.algorithms.uts_spec(p, **m.device),
                        shape=m.TaskShape(8, 100))
    pool.shutdown()
    return store, r


def test_replay_same_provider_reproduces_run(tmp_path):
    def case(m):
        prov = m.ProviderModel.aws_lambda(cold_start_s=0.3)
        store, rec = _recorded_uts_run(m, tmp_path / f"{id(m)}.jsonl", prov)
        rep = m.replay(store, recorded_provider=prov, provider=prov,
                       max_concurrency=64)
        assert rep.tasks == rec.tasks
        assert abs(rep.makespan_s - rec.makespan_s) <= 0.01 * rec.makespan_s
        assert abs(rep.cost.total - rec.cost.total) <= 0.01 * rec.cost.total
        store.close()
        return _run(rec), _run(rep)
    both(case)


def test_replay_what_if_alternate_provider_and_policy(tmp_path):
    def case(m):
        prov = m.ProviderModel.aws_lambda(cold_start_s=0.4)
        store, rec = _recorded_uts_run(m, tmp_path / f"{id(m)}.jsonl", prov)
        wl = m.extract_workload(store, provider=prov)
        assert wl.n_tasks == rec.tasks
        assert wl.recorded_cold_starts == rec.cold_starts
        outs = m.what_if(wl, {
            "prewarmed": dict(provider=m.ProviderModel.prewarmed(),
                              max_concurrency=64),
            "gcf": dict(provider=m.ProviderModel.gcf(), max_concurrency=64),
            "ewma": dict(provider=prov, max_concurrency=64,
                         autoscale=m.AutoscalePolicy(
                             min_capacity=4, max_capacity=64,
                             ewma_alpha=0.3, grow_cooldown_s=0.05)),
        })
        assert {o.tasks for o in outs.values()} == {rec.tasks}
        assert outs["prewarmed"].makespan_s < rec.makespan_s
        assert outs["gcf"].makespan_s > outs["prewarmed"].makespan_s
        for o in outs.values():
            assert o.cost is not None and o.cost.total > 0
        store.close()
        return (_run(rec), wl.total_body_s, wl.recorded_makespan_s,
                {k: (_run(o), len(o.autoscale_decisions))
                 for k, o in outs.items()})
    both(case)


def test_replay_providerless_recording_no_double_overhead(tmp_path):
    def case(m):
        p = m.algorithms.UTSParams(seed=19, b0=4.0, max_depth=6, chunk=512)
        store = m.TraceStore(ring_size=128,
                             path=str(tmp_path / f"{id(m)}.jsonl"))
        pool = m.make_pool("sim", max_concurrency=32, invoke_overhead=13e-3,
                           trace=store)
        rec = m.run_irregular(pool, m.algorithms.uts_spec(p, **m.device),
                              shape=m.TaskShape(8, 100))
        pool.shutdown()
        wl = m.extract_workload(store, overhead_s=13e-3)
        rep = m.replay(wl, max_concurrency=32, invoke_overhead=13e-3)
        assert rep.tasks == rec.tasks
        assert abs(rep.makespan_s - rec.makespan_s) <= 0.01 * rec.makespan_s
        store.close()
        return _run(rec), _run(rep)
    both(case)


def test_extract_workload_structure():
    def case(m):
        log = m.EventLog(m.VirtualClock())

        def complete(tid, t0, t1):
            log.emit(m.COMPLETE, t=t1, task_id=tid, ok=True,
                     record=m.TaskRecord(task_id=tid, worker="w",
                                         submit_time=t0, start_time=t0,
                                         end_time=t1, cost_hint=1.0,
                                         remote=True))

        log.emit(m.SUBMIT, t=0.0, task_id=1)
        log.emit(m.START, t=0.0, task_id=1)
        complete(1, 0.0, 1.0)
        log.emit(m.SUBMIT, t=1.0, task_id=2)
        log.emit(m.SUBMIT, t=1.0, task_id=3)
        log.emit(m.START, t=1.0, task_id=2)
        complete(2, 1.0, 2.0)
        log.emit(m.SUBMIT, t=2.0, task_id=4)
        log.emit(m.START, t=2.0, task_id=3)
        complete(3, 2.0, 3.0)
        log.emit(m.START, t=3.0, task_id=4)
        complete(4, 3.0, 4.0)
        wl = m.extract_workload(log)
        assert [r.task_id for r in wl.roots] == [1]
        root = wl.roots[0]
        assert [c.task_id for c in root.children] == [2, 3]
        assert [c.task_id for c in root.children[0].children] == [4]
        assert wl.n_tasks == 4
        assert wl.recorded_makespan_s == 4.0
        return sorted((t.task_id, t.body_s, t.arrival_s,
                       [c.task_id for c in t.children])
                      for t in wl.all_tasks())
    both(case)


# -- calibration -----------------------------------------------------------

def test_fit_provider_recovers_known_preset():
    def case(m):
        true = m.ProviderModel.aws_lambda(
            cold_start_s=0.4, warm_overhead_s=0.02, burst_concurrency=5,
            scaling_ramp_per_min=120.0, keep_alive_s=300.0)
        pool = m.make_pool("sim", max_concurrency=1000, provider=true)
        fs = [pool.submit(lambda: 0, cost_hint=1000 + (i * 7919) % 49000)
              for i in range(300)]
        for f in fs:
            f.result()
        fit = m.calibrate(pool.events, name="fitted-aws")
        pool.shutdown()
        assert fit.n_cold > 0 and fit.n_warm > 0
        assert abs(fit.warm_overhead_s - true.warm_overhead_s) \
            <= 0.25 * true.warm_overhead_s
        assert abs(fit.cold_start_s - true.cold_start_s) \
            <= 0.25 * true.cold_start_s
        assert abs(fit.scaling_ramp_per_min - true.scaling_ramp_per_min) \
            <= 0.30 * true.scaling_ramp_per_min
        assert abs(fit.burst_concurrency - true.burst_concurrency) <= 3
        assert fit.keep_alive_lower_bound_s is None \
            or fit.keep_alive_lower_bound_s <= true.keep_alive_s
        model = m.fit_provider(pool.events, name="fitted-aws")
        assert isinstance(model, m.ProviderModel)
        assert model.name == "fitted-aws"
        return fit.as_dict(), dataclasses.astuple(model)
    both(case)


# -- Fig. 4 renderer -------------------------------------------------------

def test_render_concurrency_figure_artifacts(tmp_path):
    def case(m):
        log = m.EventLog(m.VirtualClock())
        log.emit(m.CAPACITY_GROW, t=0.0, capacity=2)
        for i in range(4):
            log.emit(m.START, t=float(i))
        log.emit(m.CAPACITY_GROW, t=4.0, capacity=8)
        for i in range(4):
            log.emit(m.COMPLETE, t=5.0 + i)
        arts = m.render_concurrency_figure(
            {"static": log, "dynamic": log.concurrency_series()},
            str(tmp_path / f"fig4_{id(m)}"))
        assert os.path.exists(arts["csv"]) and os.path.exists(arts["txt"])
        rows = open(arts["csv"]).read().splitlines()
        assert rows[0] == "label,series,t,value"
        assert any(r.startswith("static,capacity,") for r in rows)
        assert any(r.startswith("dynamic,concurrency,") for r in rows)
        txt = open(arts["txt"]).read()
        assert "peak=4" in txt
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            assert "png" not in arts
        else:
            assert os.path.getsize(arts["png"]) > 0
        return rows, txt
    both(case)


def test_render_requires_traces(tmp_path):
    for m in (J, T):
        with pytest.raises(ValueError):
            m.render_concurrency_figure({}, str(tmp_path / "nope"))


# -- a timeline of either package replays in the other ---------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_recorded_timeline_replays_in_the_other_package(tmp_path, writer):
    """A UTS run spilled by one package's ``TraceStore``: each package's
    ``extract_workload`` reads the file to the same tree, and the same
    what-if replays give the same virtual makespans and dollars."""
    src = J if writer == "jax" else T
    prov = src.ProviderModel.aws_lambda()
    path = tmp_path / "rec.jsonl"
    store, rec = _recorded_uts_run(src, path, prov, max_depth=6)
    store.close(delete=False)

    def case(m):
        prov = m.ProviderModel.aws_lambda()
        events = list(m.read_trace(str(path)))
        wl = m.extract_workload(events, provider=prov)
        assert wl.n_tasks == rec.tasks and wl.has_parents
        outs = m.what_if(wl, {
            "same": dict(provider=prov, max_concurrency=64),
            "gcf": dict(provider=m.ProviderModel.gcf(), max_concurrency=64),
        })
        return wl.n_tasks, wl.total_body_s, {k: _run(o)
                                             for k, o in outs.items()}
    got = both(case)
    assert got[2]["same"][2] == pytest.approx(rec.makespan_s, rel=0.01)


def test_smoke_row_constants_are_the_reference_rows():
    """The values ``chip_smoke.py`` holds the card's ``trace_record_replay``
    to are the JAX package's row in ``benchmarks/BENCH_pr10.json`` (whose
    other rows the CPU tests hold the port to directly)."""
    import importlib.util
    import json
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rows = {r["name"]: r["derived"] for r in json.loads(
        (root / "benchmarks" / "BENCH_pr10.json").read_text())}
    want = dict(rows["trace_replay"])
    want.pop("figure_png")          # says whether matplotlib was importable
    assert smoke.TRACE_REPLAY_ROW == want
    for name in ("serving_knee", "dag_pipeline", "faas_parallelism"):
        assert getattr(smoke, f"{name.upper()}_ROW") == rows[name]
