"""The port's UTS against the reference package on the CPU: tree sizes,
bit-equal leftovers after a budgeted expansion of the same frontier
(also through ``uts_expand_ref`` and its grow-and-relaunch loop, at
capacities that force the loop to step again), identical counts over
every pool / batching / sharding path, and the same WAL JSON."""
import json

import numpy as np
import pytest
import torch

from repro.algorithms import uts as jax_uts
from repro_torch.algorithms import (Bag, UTSParams, expand_bag,
                                    expected_tree_size, uts_sequential,
                                    uts_spec)
from repro_torch.convert import bag_from_reference, bag_to_reference
from repro_torch.core import TaskShape, make_pool, run_irregular
from repro_torch.kernels import launches
from repro_torch.kernels.uts_hash.ops import expand_relaunching, uts_expand
from repro_torch.kernels.uts_hash.ref import uts_expand_ref

CPU = torch.device("cpu")
UTS_P = dict(seed=19, b0=4.0, max_depth=6, chunk=1024)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; PyTorch's intra-op threads would
    oversubscribe it (the 256x256 dwell test goes from 1 s to minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def uts_expected():
    return jax_uts.uts_sequential(jax_uts.UTSParams(**UTS_P))


@pytest.mark.parametrize("depth", [4, 5, 6, 7, 8])
def test_uts_sequential_matches_reference(depth):
    want = jax_uts.uts_sequential(jax_uts.UTSParams(max_depth=depth))
    assert uts_sequential(UTSParams(max_depth=depth), device="cpu") == want


def test_root_bag_matches_reference():
    ref = jax_uts.Bag.root(jax_uts.UTSParams(seed=7))
    dig, dep = bag_to_reference(Bag.root(UTSParams(seed=7), CPU))
    assert np.array_equal(dig, ref.digests)
    assert np.array_equal(dep, ref.depths)


@pytest.mark.parametrize("warm,budget,chunk", [
    (300, 1000, 256), (50, 777, 64), (2000, 5000, 1024), (10, 3, 8)])
def test_expand_bag_leftovers_match_reference(warm, budget, chunk):
    """A frontier made by the reference, carried across with convert.py,
    expanded by both packages with the same budget: same count, same
    leftover, bit for bit (LIFO head/rest order included)."""
    jp = jax_uts.UTSParams(seed=19, b0=4.0, max_depth=9, chunk=chunk)
    tp = UTSParams(seed=19, b0=4.0, max_depth=9, chunk=chunk)
    _, frontier = jax_uts.expand_bag(jax_uts.Bag.root(jp), warm, jp)
    assert frontier.size > 0
    want_count, want_left = jax_uts.expand_bag(frontier, budget, jp)
    bag = bag_from_reference(frontier.digests, frontier.depths, CPU)
    count, left = expand_bag(bag, budget, tp)
    assert count == want_count
    dig, dep = bag_to_reference(left)
    assert np.array_equal(dig, want_left.digests)
    assert np.array_equal(dep, want_left.depths)


def _peak_stack(digests, depths, budget, **kw):
    """The largest stack a budgeted expansion reaches, one generation at a
    time (a call with ``iters`` = the generation's take runs exactly it)."""
    peak, count = depths.shape[0], 0
    while count < budget and depths.shape[0]:
        take = min(depths.shape[0], budget - count, kw["chunk"])
        done, digests, depths = uts_expand_ref(digests, depths, take, **kw)
        count += done
        peak = max(peak, depths.shape[0])
    return peak


def _counting(step, calls):
    def counted(*args, **kw):
        calls.append(kw["capacity"])
        return step(*args, **kw)
    return counted


@pytest.mark.parametrize("capacity", ["uncapped", "one relaunch", "tiny"])
@pytest.mark.parametrize("warm,budget,chunk", [
    (300, 1000, 256), (50, 777, 64), (2000, 5000, 1024), (10, 3, 8)])
def test_uts_expand_ref_matches_reference(warm, budget, chunk, capacity):
    """``uts_expand_ref`` (the kernel's plain version) against the JAX
    ``expand_bag`` on the same frontier: uncapped, and through the
    grow-and-relaunch loop at a capacity one short of the peak stack
    (exactly one relaunch) and at the least capacity (several)."""
    jp = jax_uts.UTSParams(seed=19, b0=4.0, max_depth=9, chunk=chunk)
    _, frontier = jax_uts.expand_bag(jax_uts.Bag.root(jp), warm, jp)
    want_count, want_left = jax_uts.expand_bag(frontier, budget, jp)
    bag = bag_from_reference(frontier.digests, frontier.depths, CPU)
    kw = dict(b0=4.0, max_depth=9, chunk=chunk)
    calls = []
    if capacity == "uncapped":
        count, dig, dep = uts_expand_ref(bag.digests, bag.depths, budget,
                                         **kw)
    else:
        peak = _peak_stack(bag.digests, bag.depths, budget, **kw)
        assert peak > bag.size
        cap = peak - 1 if capacity == "one relaunch" else 1
        count, dig, dep = expand_relaunching(
            _counting(uts_expand_ref, calls), bag.digests, bag.depths,
            budget, capacity=cap, **kw)
        assert len(calls) == 2 if capacity == "one relaunch" \
            else len(calls) >= 2
    assert count == want_count
    got_dig, got_dep = bag_to_reference(Bag(dig, dep))
    assert np.array_equal(got_dig, want_left.digests)
    assert np.array_equal(got_dep, want_left.depths)


def test_relaunch_loop_at_tiny_capacity_equals_one_uncapped_run():
    """The grow-and-relaunch loop over the plain step, from the root at a
    capacity of one node, doubling many times, against one uncapped run."""
    kw = dict(b0=4.0, max_depth=9, chunk=64)
    root = Bag.root(UTSParams(seed=19), CPU)
    calls = []
    got = expand_relaunching(_counting(uts_expand_ref, calls), root.digests,
                             root.depths, 2**62, capacity=1, **kw)
    want = uts_expand_ref(root.digests, root.depths, 2**62, **kw)
    assert len(calls) >= 8
    assert calls == sorted(calls) and calls[0] == 1
    assert got[0] == want[0] == 115780
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


@pytest.mark.parametrize("size,iters", [(0, 100), (5, 0), (5, -3)])
def test_uts_expand_returns_the_bag_untouched(size, iters):
    """An empty bag or a budget <= 0: the same tensors back, count 0, no
    step of the loop and no launch."""
    _, frontier = jax_uts.expand_bag(
        jax_uts.Bag.root(jax_uts.UTSParams(max_depth=6)), 3,
        jax_uts.UTSParams(max_depth=6))
    bag = bag_from_reference(frontier.digests[:, :size],
                             frontier.depths[:size], CPU)
    before = launches("uts_expand")
    count, dig, dep = uts_expand(bag.digests, bag.depths, iters, b0=4.0,
                                 max_depth=6, chunk=8)
    assert count == 0 and dig is bag.digests and dep is bag.depths
    assert launches("uts_expand") == before

    def no_step(*args, **kw):
        raise AssertionError("stepped")
    assert expand_relaunching(no_step, bag.digests, bag.depths, iters,
                              chunk=8, b0=4.0, max_depth=6) \
        == (0, bag.digests, bag.depths)


def test_uts_expand_unbounded_budget_is_the_whole_tree():
    """iters = 2**62 (``uts_sequential``'s) runs the tree out: the
    reference's count, an empty leftover."""
    root = Bag.root(UTSParams(seed=19), CPU)
    count, dig, dep = uts_expand(root.digests, root.depths, 2**62, b0=4.0,
                                 max_depth=7, chunk=512)
    assert count == jax_uts.uts_sequential(
        jax_uts.UTSParams(max_depth=7, chunk=512)) == 7134
    assert dig.shape == (5, 0) and dep.shape == (0,)


@pytest.mark.parametrize("budget", [40, 10**6])
def test_uts_expand_chunk_larger_than_the_bag(budget):
    """A chunk larger than the bag (and than the tree's widest level):
    every generation takes the whole stack, as the reference does."""
    jp = jax_uts.UTSParams(seed=19, b0=4.0, max_depth=7, chunk=10**6)
    _, frontier = jax_uts.expand_bag(jax_uts.Bag.root(jp), 5, jp)
    want_count, want_left = jax_uts.expand_bag(frontier, budget, jp)
    bag = bag_from_reference(frontier.digests, frontier.depths, CPU)
    assert bag.size < jp.chunk
    count, dig, dep = uts_expand(bag.digests, bag.depths, budget, b0=4.0,
                                 max_depth=7, chunk=jp.chunk)
    assert count == want_count
    got_dig, got_dep = bag_to_reference(Bag(dig, dep))
    assert np.array_equal(got_dig, want_left.digests)
    assert np.array_equal(got_dep, want_left.depths)


@pytest.mark.parametrize("k", [1, 2, 3, 7, 50])
def test_bag_split_matches_reference(k):
    jp = jax_uts.UTSParams(seed=19, max_depth=7)
    _, frontier = jax_uts.expand_bag(jax_uts.Bag.root(jp), 40, jp)
    mine = bag_from_reference(frontier.digests, frontier.depths, CPU)
    ref_parts, parts = frontier.split(k), mine.split(k)
    assert [p.size for p in parts] == [p.size for p in ref_parts]
    for p, r in zip(parts, ref_parts):
        dig, dep = bag_to_reference(p)
        assert np.array_equal(dig, r.digests)
        assert np.array_equal(dep, r.depths)


PATHS = [
    ("local", dict(max_concurrency=3, invoke_overhead=0.0), {}),
    ("local", dict(max_concurrency=3, invoke_overhead=0.0),
     {"batching": True}),
    ("elastic", dict(max_concurrency=8, invoke_overhead=5e-4,
                     invoke_rate_limit=None), {}),
    ("elastic", dict(max_concurrency=8, invoke_overhead=5e-4,
                     invoke_rate_limit=None), {"batching": True}),
    ("local", dict(max_concurrency=4, invoke_overhead=0.0), {"shards": 2}),
    ("elastic", dict(max_concurrency=8, invoke_overhead=5e-4,
                     invoke_rate_limit=None),
     {"shards": 2, "batching": True}),
]


@pytest.mark.parametrize("kind,cfg,kw", PATHS,
                         ids=[f"{p[0]}-{'-'.join(p[2]) or 'plain'}"
                              for p in PATHS])
def test_run_irregular_count_matches_reference(kind, cfg, kw, uts_expected):
    with make_pool(kind, **cfg) as pool:
        r = run_irregular(pool, uts_spec(UTSParams(**UTS_P), device="cpu"),
                          shape=TaskShape(8, 500), **kw)
    assert r.output == uts_expected
    assert r.tasks >= 1


def test_wal_json_matches_reference():
    """encode_item / encode_result emit the reference's JSON for the same
    frontier, and decode back to the same bag."""
    jp = jax_uts.UTSParams(**UTS_P)
    _, frontier = jax_uts.expand_bag(jax_uts.Bag.root(jp), 200, jp)
    ref_spec = jax_uts.uts_spec(jp)
    spec = uts_spec(UTSParams(**UTS_P), device="cpu")
    bag = bag_from_reference(frontier.digests, frontier.depths, CPU)
    assert json.dumps(spec.encode_item(bag)) \
        == json.dumps(ref_spec.encode_item(frontier))
    assert json.dumps(spec.encode_result((17, bag))) \
        == json.dumps(ref_spec.encode_result((17, frontier)))
    empty = jax_uts.Bag.empty()
    assert json.dumps(spec.encode_item(Bag.empty(CPU))) \
        == json.dumps(ref_spec.encode_item(empty))
    c, back = spec.decode_result(ref_spec.encode_result((17, frontier)))
    dig, dep = bag_to_reference(back)
    assert c == 17
    assert np.array_equal(dig, frontier.digests)
    assert np.array_equal(dep, frontier.depths)
    dig, dep = bag_to_reference(spec.decode_item(ref_spec.encode_item(frontier)))
    assert np.array_equal(dig, frontier.digests)


def test_resume_from_waits_for_the_chaos_slice(uts_expected):
    """The chaos slice has landed: ``resume_from=`` an empty journal (a
    master that died before its first fold) recovers the seeds and runs
    the whole tree."""
    with make_pool("local", max_concurrency=2, invoke_overhead=0.0) as pool:
        r = run_irregular(pool, uts_spec(UTSParams(**UTS_P), device="cpu"),
                          resume_from=[])
    assert r.output == uts_expected
    assert r.recovered_tasks > 0


def test_expected_tree_size_matches_reference():
    for b0, d in [(4.0, 14), (2.0, 10), (3.5, 6)]:
        assert expected_tree_size(b0, d) == jax_uts.expected_tree_size(b0, d)
