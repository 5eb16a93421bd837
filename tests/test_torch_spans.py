"""The port's span recorder (``repro_torch.core.telemetry``): off by
default and then silent; on, every master and pool span of a UTS run on
the CPU, each on ``time.monotonic``, tied to the pool's records by task
id, nested as documented; the cap; and, with ``-m cuda``, the UTS launch
path's four spans in order inside their task."""
import sys
import threading
import time
from collections import Counter, defaultdict

import pytest
import torch

from repro_torch.algorithms import UTSParams, uts_spec
from repro_torch.core import TaskShape, WorkSpec, make_pool, run_irregular
from repro_torch.core import telemetry

MASTER = ("master.seed", "master.wait", "master.fold", "master.split",
          "master.dispatch", "master.close")
POOL = ("pool.invoke", "pool.settle")
UTS = ("uts.stage_in", "uts.launch", "uts.wait", "uts.leftover")


@pytest.fixture(autouse=True)
def _recorder():
    """Each test starts with recording off and nothing kept, and leaves
    it so."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    telemetry.enable_spans(False)
    telemetry.clear_spans()
    yield
    telemetry.enable_spans(False)
    telemetry.clear_spans()
    torch.set_num_threads(n)


def _uts_run(device="cpu", depth=6, iters=200):
    """A UTS tree on an elastic pool of 4 (1 ms invocations): the result,
    the pool's records, and monotonic reads before and after."""
    spec = uts_spec(UTSParams(seed=19, b0=4.0, max_depth=depth, chunk=64),
                    device=device)
    with make_pool("elastic", max_concurrency=4, invoke_overhead=1e-3,
                   invoke_rate_limit=None) as pool:
        before = time.monotonic()
        out = run_irregular(pool, spec,
                            shape=TaskShape(split_factor=4, iters=iters))
        after = time.monotonic()
        records = list(pool.stats.records)
    return out, records, before, after


def test_off_by_default_records_nothing():
    assert telemetry.SPANS_ON is False
    out, records, _, _ = _uts_run()
    assert out.output > 0 and records
    assert telemetry.spans() == [] and telemetry.spans_dropped() == 0


def test_on_records_every_master_and_pool_span_on_the_monotonic_clock():
    telemetry.enable_spans(True)
    out, records, before, after = _uts_run()
    spans = telemetry.spans()
    names = Counter(s.name for s in spans)
    assert set(MASTER + POOL) <= set(names)
    assert names["master.seed"] == names["master.close"] == 1
    # one fold, split and settle a completion, one invocation a start
    assert names["master.fold"] == names["master.split"] == len(records)
    assert names["pool.settle"] == names["pool.invoke"] == len(records)
    assert all(before <= s.start <= s.end <= after for s in spans)


def test_each_settle_carries_a_records_task_and_follows_its_end():
    telemetry.enable_spans(True)
    _, records, _, _ = _uts_run()
    by_id = {r.task_id: r for r in records}
    settles = [s for s in telemetry.spans() if s.name == "pool.settle"]
    assert sorted(s.task_id for s in settles) == sorted(by_id)
    for s in settles:
        assert s.start >= by_id[s.task_id].end_time
    for s in telemetry.spans():
        if s.name == "pool.invoke":
            r = by_id[s.task_id]
            assert r.start_time <= s.start and s.end <= r.end_time


def test_split_and_dispatch_nest_inside_their_completions_fold():
    telemetry.enable_spans(True)
    _uts_run()
    spans = telemetry.spans()
    master = {s.thread for s in spans if s.name in MASTER}
    assert len(master) == 1
    folds = {s.task_id: s for s in spans if s.name == "master.fold"}
    for s in spans:
        if s.name in ("master.split", "master.dispatch"):
            f = folds[s.task_id]
            assert f.start <= s.start <= s.end <= f.end
    assert all(s.task_id is None for s in spans
               if s.name in ("master.seed", "master.wait", "master.close"))


def test_a_task_body_sees_its_own_task_as_the_threads_current():
    seen = []

    def execute(item, shape):
        seen.append(telemetry.current_task())
        return item

    spec = WorkSpec(name="ids", seed=lambda shape: [1, 2, 3],
                    execute=execute, reduce=lambda st, r: st + r,
                    init=lambda: 0, shape=TaskShape(1, 1))
    telemetry.enable_spans(True)
    with make_pool("local", max_concurrency=2) as pool:
        assert run_irregular(pool, spec).output == 6
        ids = sorted(r.task_id for r in pool.stats.records)
    assert sorted(seen) == ids
    assert telemetry.current_task() is None


def test_a_failed_task_settles_with_a_span():
    telemetry.enable_spans(True)

    def boom():
        raise ValueError("boom")

    with make_pool("local", max_concurrency=1, max_attempts=1) as pool:
        f = pool.submit(boom)
        with pytest.raises(ValueError):
            f.result()
        tid = f._task.task_id
    settles = [s for s in telemetry.spans() if s.name == "pool.settle"]
    assert [s.task_id for s in settles] == [tid]


def test_spans_past_the_cap_are_counted_not_kept(monkeypatch):
    monkeypatch.setattr(telemetry, "SPAN_CAP", 5)
    for k in range(8):
        telemetry.add_span("x", float(k), float(k) + 0.5, k)
    assert [s.task_id for s in telemetry.spans()] == [0, 1, 2, 3, 4]
    assert telemetry.spans_dropped() == 3
    telemetry.clear_spans()
    assert telemetry.spans() == [] and telemetry.spans_dropped() == 0


def test_threads_racing_past_the_cap_keep_exactly_the_cap(monkeypatch):
    """More threads than cores, a short switch interval: the cap keeps
    exactly its number of spans and counts every other one."""
    monkeypatch.setattr(telemetry, "SPAN_CAP", 10_000)
    threads, each = 16, 2_000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda k=k: [
            telemetry.add_span("x", 0.0, 1.0, k) for _ in range(each)])
            for k in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert len(telemetry.spans()) == 10_000
    assert telemetry.spans_dropped() == threads * each - 10_000


@pytest.mark.cuda
def test_uts_launch_spans_nest_in_order_inside_their_task():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    _uts_run(device="cuda", depth=8, iters=4096)   # builds and warms
    telemetry.enable_spans(True)
    _, records, _, _ = _uts_run(device="cuda", depth=10, iters=4096)
    by_id = {r.task_id: r for r in records}
    per_task = defaultdict(list)
    for s in telemetry.spans():
        if s.name in UTS:
            per_task[s.task_id].append(s)
    assert per_task and set(per_task) <= set(by_id)
    workers = {s.thread for s in telemetry.spans() if s.name in POOL}
    for tid, spans in per_task.items():
        spans.sort(key=lambda s: (s.start, UTS.index(s.name)))
        assert len(spans) % 4 == 0
        assert [s.name for s in spans] == list(UTS) * (len(spans) // 4)
        assert len({s.thread for s in spans}) == 1
        assert spans[0].thread in workers
        r = by_id[tid]
        assert r.start_time <= spans[0].start and spans[-1].end <= r.end_time
        for a, b in zip(spans, spans[1:]):
            assert a.end <= b.start
        for k in range(0, len(spans), 4):
            one = spans[k:k + 4]
            assert all(a.end == b.start for a, b in zip(one, one[1:]))
