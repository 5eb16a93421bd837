"""The readers of the program's spans (``perfbench/spans.py`` and the
four metric files on it) on a hand-made run whose values are worked by
hand: a window of 10 s, the device busy in (0, 2.45), (3, 5), (5.15,
5.55) and (6, 9), two tasks ending in it and one after it, a master and
four workers' spans, and a device trace whose times are 0.05 s early, as
its markers can leave them.  Each reader gives None where the run carries
no spans.  The clock's shift follows a trace whose error drifts.  With
``-m cuda``, the program's spans and the device trace share one clock."""
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import harness, spans as sp

NEW = ("idle_in_sync_share.uts", "launch_host_ms.uts", "pool_settle_ms.uts",
       "master_busy_share.uts")


class _Trace:
    """``DeviceTrace``'s reading side over ``(name, start, end)``."""

    def __init__(self, events):
        self.events = events

    def spans(self, name=None):
        return [(a, b) for n, a, b in self.events
                if name is None or name in n]


#: the device, true times: task 1's kernel ends its first busy stretch,
#: task 2's runs alone in (5.15, 5.55); each starts 0.05 s after its
#: launch began and ends 0.05 s before its wait ends
DEVICE = [("elementwise_kernel", 0.0, 1.25), ("uts_expand_kernel", 1.25, 2.45),
          ("reduce_kernel", 3.0, 5.0), ("uts_expand_kernel", 5.15, 5.55),
          ("elementwise_kernel", 6.0, 9.0)]
#: how early the trace's times come out (its markers' error)
EARLY = 0.05


@pytest.fixture(autouse=True)
def _in_seconds(request, monkeypatch):
    """The hand-made run is in seconds where the card's is in
    milliseconds: one stretch of trace bounds the clock's shift."""
    if "drift" not in request.node.name:
        monkeypatch.setattr(sp, "SHIFT_WINDOW", 20.0)
        monkeypatch.setattr(sp, "SHIFT_BRACKET", 1.0)


def _span(name, start, end, task=None, thread=1):
    return (name, start, end, task, thread)


SPANS = [
    # task 1 on worker 2: one launch, its wait into the gap (2, 3)
    _span("uts.stage_in", 1.0, 1.2, 1, 2), _span("uts.launch", 1.2, 1.3, 1, 2),
    _span("uts.wait", 1.3, 2.5, 1, 2), _span("uts.leftover", 2.5, 2.6, 1, 2),
    _span("pool.settle", 4.0, 4.1, 1, 2),
    # task 2 on worker 3: its whole launch in the gap (5, 6)
    _span("uts.stage_in", 5.0, 5.1, 2, 3), _span("uts.launch", 5.1, 5.2, 2, 3),
    _span("uts.wait", 5.2, 5.6, 2, 3), _span("uts.leftover", 5.6, 5.9, 2, 3),
    _span("pool.settle", 8.0, 8.3, 2, 3),
    # task 3 on worker 4 ends after the window; its invocation overlaps
    # task 1's wait, which comes first
    _span("pool.invoke", 2.2, 2.8, 3, 4),
    _span("uts.stage_in", 9.5, 9.6, 3, 4),
    _span("pool.settle", 12.0, 12.1, 3, 4),
    # the master: seed before the window, two folds with their split and
    # dispatch inside, a wait between them, close past the window's end
    _span("master.seed", -1.0, 0.5),
    _span("master.fold", 4.1, 4.5, 1), _span("master.split", 4.2, 4.3, 1),
    _span("master.dispatch", 4.3, 4.4, 1),
    _span("master.wait", 4.5, 8.3),
    _span("master.fold", 8.3, 9.8, 2), _span("master.split", 8.4, 9.2, 2),
    _span("master.dispatch", 9.2, 9.4, 2),
    _span("master.close", 9.9, 10.5),
]

#: the device idle (2.45, 3), (5, 5.15), (5.55, 6), (9, 10) put down span
#: by span
IDLE = {"uts.wait": 0.05 + 0.05, "uts.stage_in": 0.1 + 0.1, "uts.launch": 0.05,
        "uts.leftover": 0.1 + 0.3, "pool.settle": 0.0, "pool.invoke": 0.2,
        "master.close": 0.1, "master.seed": 0.0, "master.split": 0.2,
        "master.dispatch": 0.2, "master.fold": 0.1 + 0.2,
        "none": 0.2 + 0.1 + 0.1}


def _ctx(spans=SPANS, with_field=True, early=EARLY):
    records = [SimpleNamespace(task_id=k, end_time=t)
               for k, t in ((1, 4.0), (2, 8.0), (3, 12.0))]
    # cell, algorithm, device, t0, t1, setup_s, tasks, pool records,
    # launches, lineage, trace
    ctx = harness.Context(
        None, None, None, 0.0, 10.0, 0.0, [], records, {}, None,
        _Trace([(n, a - early, b - early) for n, a, b in DEVICE]))
    if with_field:
        ctx.spans = spans
    return ctx


def test_the_clock_shift_is_bounded_by_the_launches_and_the_waits():
    # kernel starts 1.2, 5.1 against launches from 1.2, 5.1: at least 0;
    # kernel ends 2.4, 5.5 against waits ending 2.5, 5.6: at most 0.1
    times, shift = sp.clock_shift(_ctx())
    assert shift.tolist() == [pytest.approx(0.05)]
    assert sp.clock_shift(_ctx(early=0.0))[1].tolist() == [
        pytest.approx(0.0)]


def test_the_clock_shift_follows_a_drifting_trace():
    """400 launches 0.05 s apart, each kernel 0.2 ms after its launch
    began and 0.2 ms before its wait ends; the trace's error grows by 0.2
    ms a second from 0.5 ms, and falls back to 0.5 ms at 10 s."""
    t = 0.05 * np.arange(400)
    err = np.where(t < 10.0, 5e-4 + 2e-4 * t, 5e-4)
    events = [("uts_expand_kernel", a + 2e-4 - e, a + 2.2e-3 - e)
              for a, e in zip(t, err)]
    spans = ([("uts.launch", a, a + 1e-4, None, 1) for a in t]
             + [("uts.wait", a + 1e-4, a + 2.4e-3, None, 1) for a in t])
    ctx = SimpleNamespace(spans=spans, trace=_Trace(events))
    times, shift = sp.clock_shift(ctx)
    assert len(times) >= 70
    true = np.where(times < 10.0, 5e-4 + 2e-4 * times, 5e-4)
    assert np.abs(shift - true).max() < 1e-4


def test_idle_in_sync_share_is_the_idle_inside_a_wait_over_the_window():
    # (2.45, 2.5) of task 1's wait and (5.55, 5.6) of task 2's, on the
    # spans' clock; as the trace's early times stand, (2.4, 2.5) and
    # (5.5, 5.6)
    assert sp.idle_in_sync_share(_ctx()) == pytest.approx(0.1 / 10)


def test_launch_host_ms_is_the_mean_of_each_window_tasks_launch_path():
    # task 1: 0.2 + 0.1 + 0.1 s, task 2: 0.1 + 0.1 + 0.3 s; task 3 ends
    # after the window and its stage-in is left out
    assert sp.launch_host_ms(_ctx()) == pytest.approx(450.0)


def test_pool_settle_ms_is_the_mean_settle_of_the_window_tasks():
    assert sp.pool_settle_ms(_ctx()) == pytest.approx(200.0)


def test_master_busy_share_is_the_union_of_its_spans_but_the_wait():
    # seed (0, 0.5), fold (4.1, 4.5), fold (8.3, 9.8), close (9.9, 10)
    assert sp.master_busy_share(_ctx()) == pytest.approx(2.5 / 10)


def test_idle_goes_to_the_first_span_in_order_and_sums_to_the_idle():
    got = sp.idle_by_span(_ctx())
    assert list(got) == list(sp.IDLE_ORDER) + ["none"]
    for name, want in IDLE.items():
        assert got[name] == pytest.approx(want, abs=1e-12), name
    assert sum(got.values()) == pytest.approx(2.15)


def test_the_breakdown_gains_span_entries_after_the_all_ones():
    base = {"device_ops": [["k", 7.0]],
            "idle_gaps": [["all:task_body", 2.0],
                          ["all:master_between_tasks", 1.0],
                          ["task_body@2.000000s", 1.0]]}
    out = sp.with_idle_by_span(base, _ctx())
    names = [e[0] for e in out["idle_gaps"]]
    assert names[:2] == ["all:task_body", "all:master_between_tasks"]
    span_part = out["idle_gaps"][2:]
    assert {e[0] for e in span_part} == {f"span:{k}"
                                         for k, v in IDLE.items() if v > 0}
    values = [v for _, v in span_part]
    assert values == sorted(values, reverse=True)
    assert sum(v for _, v in span_part) == pytest.approx(2.15)
    # two totals and ten span entries: no room for the longest gaps
    assert len(out["idle_gaps"]) == 12 and out["device_ops"] == [["k", 7.0]]
    few = sp.with_idle_by_span(base, _ctx(
        [_span("uts.launch", 1.2, 1.3), _span("uts.wait", 1.3, 2.5),
         _span("uts.launch", 5.1, 5.2), _span("uts.wait", 5.2, 5.6)]))
    assert [e[0] for e in few["idle_gaps"]] == [
        "all:task_body", "all:master_between_tasks", "span:none",
        "span:uts.wait", "span:uts.launch", "task_body@2.000000s"]


@pytest.mark.parametrize("name", NEW)
def test_each_metric_file_reads_its_reader(name):
    want = {"idle_in_sync_share.uts": 0.01, "launch_host_ms.uts": 450.0,
            "pool_settle_ms.uts": 200.0, "master_busy_share.uts": 0.25}
    assert harness.load_metric(name)(_ctx()) == pytest.approx(want[name])


@pytest.mark.parametrize("with_field", [False, True])
@pytest.mark.parametrize("name", NEW)
def test_without_spans_every_reader_gives_none(name, with_field):
    ctx = _ctx(spans=None, with_field=with_field)
    assert harness.load_metric(name)(ctx) is None
    assert sp.idle_by_span(ctx) is None
    base = {"device_ops": [], "idle_gaps": [["all:task_body", 3.0]]}
    assert sp.with_idle_by_span(base, ctx) is base


def test_readers_give_none_where_their_spans_are_missing():
    ctx = _ctx([_span("master.wait", 1.0, 2.0)])
    for name in NEW:
        assert harness.load_metric(name)(ctx) is None
    ctx = _ctx()
    ctx.trace = None
    assert sp.idle_in_sync_share(ctx) is None and sp.idle_by_span(ctx) is None
    assert sp.launch_host_ms(ctx) == pytest.approx(450.0)


def test_without_a_span_for_every_kernel_the_device_readers_give_none():
    """A wait lost (or a kernel the spans never launched) leaves the
    clocks untied: the readers that need them give None."""
    ctx = _ctx([s for s in SPANS if s[1:3] != (5.2, 5.6)])
    assert sp.clock_shift(ctx) is None
    assert sp.idle_in_sync_share(ctx) is None and sp.idle_by_span(ctx) is None
    # bounds that cross: a wait ending before its kernel could
    ctx = _ctx([_span("uts.launch", 1.2, 1.3), _span("uts.wait", 1.3, 1.4),
                _span("uts.launch", 5.1, 5.2), _span("uts.wait", 5.2, 5.6)])
    assert sp.clock_shift(ctx) is None


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
def test_the_programs_spans_and_the_device_trace_share_a_clock(card):
    """A short traced UTS run on four workers: one uts_expand_kernel
    interval in the trace for each uts.launch and uts.wait span; in half
    the stretches of trace or more, the shift that puts the trace on the
    spans' clock bounded on both sides (launches begun before kernels
    start, kernels ended before waits end) to within a millisecond; and
    every such shift under 5 ms: the two are one clock, time.monotonic."""
    import torch
    from perfbench.tracelib import DeviceTrace
    from repro_torch.algorithms import UTSParams, uts_spec
    from repro_torch.core import TaskShape, make_pool, run_irregular
    from repro_torch.core import telemetry

    dev = torch.device("cuda", 0)

    def run(depth):
        spec = uts_spec(UTSParams(seed=19, b0=4.0, max_depth=depth,
                                  chunk=8192), device=dev)
        with make_pool("elastic", max_concurrency=4, invoke_overhead=1e-3,
                       invoke_rate_limit=None) as pool:
            run_irregular(pool, spec,
                          shape=TaskShape(split_factor=8, iters=1 << 16))

    run(9)  # builds and warms the kernels
    trace = DeviceTrace(dev)
    telemetry.clear_spans()
    trace.start()
    telemetry.enable_spans(True)
    try:
        run(13)
    finally:
        telemetry.enable_spans(False)
        torch.cuda.synchronize(dev)
        trace.stop()
    ctx = SimpleNamespace(spans=telemetry.spans(), trace=trace)
    telemetry.clear_spans()
    launched = sum(s.name == "uts.launch" for s in ctx.spans)
    assert launched > 100
    assert len(trace.spans(sp.KERNEL)) == launched
    times, shift = sp.clock_shift(ctx)
    kernels = np.array(trace.spans(sp.KERNEL))
    stretches = (kernels.max() - kernels.min()) / sp.SHIFT_WINDOW
    assert len(times) >= stretches / 2
    assert np.abs(shift).max() < 5e-3
