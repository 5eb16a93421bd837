"""The port's ``repro_torch.trace.store`` on the CPU: twins of the store
tests of ``tests/test_trace.py`` (ring + spill round trip, a closed store,
every pool recording through a store, windowed runs) and of the
``ShardedTraceStore`` tests of ``tests/test_sharded_driver.py``, and a
spill file written by either package read back by the other's
``read_trace``, event for event."""
import pytest
import torch

from repro.core import VirtualClock as JVirtualClock
from repro.trace import TraceStore as JTraceStore
from repro.trace import read_trace as jax_read_trace
from repro_torch.algorithms import UTSParams, uts_sequential, uts_spec
from repro_torch.core import (TaskShape, VirtualClock, WorkSpec, make_pool,
                              run_irregular)
from repro_torch.core.futures import TaskRecord
from repro_torch.core.telemetry import (CAPACITY_GROW, COLD_START, COMPLETE,
                                        START, SUBMIT)
from repro_torch.trace import (ShardedTraceStore, TraceReader, TraceStore,
                               event_to_dict, iter_trace_events, read_trace)

_KINDS = [SUBMIT, COLD_START, START, COMPLETE, CAPACITY_GROW]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; PyTorch's intra-op threads would
    oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mixed_events(n, record=TaskRecord):
    for i in range(n):
        k = i % 5
        if k == 0:
            yield dict(kind=SUBMIT, task_id=i, worker=None)
        elif k == 1:
            yield dict(kind=COLD_START, task_id=i, worker=f"w{i % 7}")
        elif k == 2:
            yield dict(kind=START, task_id=i, worker=f"w{i % 7}")
        elif k == 3:
            yield dict(kind=COMPLETE, task_id=i, worker=f"w{i % 7}",
                       ok=bool(i % 2),
                       record=record(
                           task_id=i, worker=f"w{i % 7}",
                           submit_time=i * 0.25, start_time=i * 0.5,
                           end_time=i * 0.5 + 1 / 3, cost_hint=i * 1.75,
                           remote=bool(i % 3), attempts=1 + i % 4))
        else:
            yield dict(kind=CAPACITY_GROW, capacity=i + 1)


def test_ring_spill_roundtrip_100k(tmp_path):
    """A 100k-event trace spills losslessly while only ring_size events
    stay resident; the seekable reader reproduces it exactly."""
    n = 100_000
    path = str(tmp_path / "big.jsonl")
    store = TraceStore(VirtualClock(), ring_size=512, path=path)
    for i, kw in enumerate(_mixed_events(n)):
        store.emit(t=float(i) * 0.001, **kw)
    assert len(store) == n
    assert store.resident_events == 512          # bounded memory
    assert store.counts()[SUBMIT] == n // 5

    evs = store.events()
    assert len(evs) == n
    for i, e in enumerate(evs):
        assert e.t == i * 0.001
        assert e.kind == _KINDS[i % 5]
    recs = [e.record for e in evs if e.record is not None]
    assert len(recs) == n // 5
    r = recs[1]
    i = r.task_id
    assert (r.submit_time, r.start_time, r.end_time, r.cost_hint) \
        == (i * 0.25, i * 0.5, i * 0.5 + 1 / 3, i * 1.75)
    assert isinstance(r.remote, bool)

    offset = 73_210
    tail = list(store.iter_events(offset))
    assert len(tail) == n - offset
    assert tail[0].t == offset * 0.001

    store.close()
    reader = read_trace(path)
    assert isinstance(reader, TraceReader)
    assert reader.count() == n
    seg = list(reader.iter_from(99_990))
    assert len(seg) == 10 and seg[0].t == 99_990 * 0.001


def test_store_closed_rejects_emit(tmp_path):
    store = TraceStore(path=str(tmp_path / "x.jsonl"))
    store.emit(SUBMIT, task_id=0)
    store.close()
    with pytest.raises(RuntimeError):
        store.emit(SUBMIT, task_id=1)


@pytest.mark.parametrize("kind,cfg", [
    ("local", dict(max_concurrency=3, invoke_overhead=0.0)),
    ("elastic", dict(max_concurrency=3, invoke_overhead=0.0,
                     invoke_rate_limit=None)),
    ("sim", dict(max_concurrency=3, invoke_overhead=1e-3)),
    ("hybrid", dict(local_concurrency=2, elastic_concurrency=3)),
])
def test_pools_record_through_trace_store(kind, cfg, tmp_path):
    """trace= plugs the spill-backed store in behind every backend; the
    lifecycle contract is unchanged."""
    store = TraceStore(ring_size=8, path=str(tmp_path / f"{kind}.jsonl"))
    with make_pool(kind, trace=store, **cfg) as pool:
        fs = [pool.submit(lambda i=i: i * i) for i in range(12)]
        assert sorted(f.result(timeout=30) for f in fs) \
            == [i * i for i in range(12)]
        counts = store.counts()
        assert counts[SUBMIT] == 12
        assert counts[COMPLETE] == 12
        assert store.resident_events == 8
        assert len({r.task_id for r in store.records}) == 12
        assert pool.events.counts()[COMPLETE] >= 12


def test_windowed_runs_on_trace_store(tmp_path):
    """A reused traced pool still bills per run (lazy tail windows)."""
    spec = WorkSpec(name="three", execute=lambda item, shape: item,
                    seed=lambda shape: [1, 2, 3])
    store = TraceStore(ring_size=4, path=str(tmp_path / "w.jsonl"))
    pool = make_pool("sim", max_concurrency=2, invoke_overhead=1e-3,
                     trace=store)
    r1 = run_irregular(pool, spec)
    r2 = run_irregular(pool, spec)
    pool.shutdown()
    assert abs(r1.cost.total - r2.cost.total) < 1e-12
    assert len(r1.concurrency_series) == len(r2.concurrency_series) == 6
    assert abs(r1.makespan_s - r2.makespan_s) < 1e-9


# -- ShardedTraceStore ---------------------------------------------------------

def test_sharded_trace_routes_and_merges():
    store = ShardedTraceStore(3, ring_size=64)
    with make_pool("sim", max_concurrency=12, trace=store) as pool:
        views = pool.shard_views(3)
        for i, v in enumerate(views):
            v.submit(lambda x: x, i).result()
    per_seg = [len(seg) for seg in store.segments]
    assert sum(per_seg) == len(store) > 0
    assert all(n > 0 for n in per_seg)
    ts = [e.t for e in store.iter_events()]
    assert ts == sorted(ts)
    kinds = [e.kind for e in store.events()]
    assert "submit" in kinds and "complete" in kinds


def test_sharded_trace_bind_bounds():
    store = ShardedTraceStore(2)
    with pytest.raises(IndexError):
        store.bind_shard(2)
    with pytest.raises(IndexError):
        store.bind_shard(-1)


def test_sharded_driver_records_to_sharded_store():
    p = UTSParams(seed=19, b0=4.0, max_depth=6, chunk=512)
    store = ShardedTraceStore(4, ring_size=256)
    with make_pool("sim", max_concurrency=32, trace=store) as pool:
        r = run_irregular(pool, uts_spec(p, device="cpu"), shards=4,
                          batching=True, shape=TaskShape(8, 200))
    assert r.output == uts_sequential(p, device="cpu")
    assert sum(len(s) for s in store.segments) == len(store) > 0
    assert store.counts().get("complete", 0) > 0
    assert store.peak_concurrency() >= 1
    store.close()


# -- the spill file across the two packages ------------------------------------

@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_spill_file_reads_back_in_the_other_package(tmp_path, writer):
    """The JSONL one package spills is the other's, line for line: each
    package's reader yields the same events from it."""
    from repro.core.futures import TaskRecord as JTaskRecord
    n = 2_000
    path = str(tmp_path / "spill.jsonl")
    if writer == "repro":
        store = JTraceStore(JVirtualClock(), ring_size=64, path=path)
        events = _mixed_events(n, record=JTaskRecord)
    else:
        store = TraceStore(VirtualClock(), ring_size=64, path=path)
        events = _mixed_events(n)
    for i, kw in enumerate(events):
        store.emit(t=float(i) * 0.001, **kw)
    store.close()
    ours = [event_to_dict(e) for e in iter_trace_events(read_trace(path))]
    theirs = jax_read_trace(path)
    assert theirs.count() == len(ours) == n
    from repro.trace.store import event_to_dict as jax_event_to_dict
    assert ours == [jax_event_to_dict(e) for e in theirs.iter_from(0)]
    assert ours[3]["record"]["end_time"] == 0.5 * 3 + 1 / 3
