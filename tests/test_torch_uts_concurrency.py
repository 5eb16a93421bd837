"""Concurrent ``uts_expand`` tasks on one card, and the launch-overlap count.

``uts_expand``'s kernel takes one thread block cluster a task and runs on
the task's own stream, so the pool's tasks share the card.  On the card,
sixteen threads expand sixteen bags of one depth-14 frontier at once, some
at a capacity that forces relaunches: each result is the plain version's
bit for bit, and ``expand_overlap`` shows launches that overlapped.  On the
CPU, the overlap count's bookkeeping alone.  This file imports no JAX, so
it runs as it is on the machine with the card (``python -m pytest -m cuda
tests/test_torch_uts_concurrency.py``); here the card's test skips.
"""
import sys
import threading

import pytest
import torch

from repro_torch.kernels.dispatch import launches
from repro_torch.kernels.uts_hash import ops
from repro_torch.kernels.uts_hash.ops import (Overlap, expand_overlap,
                                              reset_expand_overlap,
                                              root_digest, uts_expand)

WORKERS = 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture
def idle_counter():
    """The overlap count from zero, with no launch in flight."""
    assert ops._IN_FLIGHT[0] == 0
    reset_expand_overlap()
    yield
    assert ops._IN_FLIGHT[0] == 0
    reset_expand_overlap()


def test_overlap_count_reads_resets_and_keeps_the_peak(idle_counter):
    assert expand_overlap() == Overlap(0, 0, 0, 0)
    for _ in range(3):
        ops._launch_began()
    assert expand_overlap() == Overlap(launches=3, overlapped=2, others=3,
                                       peak=3)
    ops._launch_ended()
    ops._launch_began()  # finds two others: the peak stays 3
    assert expand_overlap() == Overlap(4, 3, 5, 3)
    reset_expand_overlap()  # the three in flight stay in flight
    assert expand_overlap() == Overlap(0, 0, 0, 0)
    ops._launch_began()
    assert expand_overlap() == Overlap(1, 1, 3, 4)
    for _ in range(4):
        ops._launch_ended()
    ops._launch_began()
    ops._launch_ended()
    assert expand_overlap() == Overlap(2, 1, 3, 4)


def test_overlap_count_holds_under_threads(idle_counter):
    """Launches from many threads at once, switched often, are each counted
    once, and the in-flight gauge comes back to zero."""
    start = threading.Barrier(WORKERS, timeout=60)

    def work():
        start.wait()
        for _ in range(500):
            ops._launch_began()
            ops._launch_ended()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(WORKERS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    got = expand_overlap()
    assert got.launches == WORKERS * 500
    assert 1 <= got.peak <= WORKERS
    assert got.overlapped <= got.others


@pytest.mark.cuda
def test_concurrent_tasks_match_plain_on_card(cuda_device, idle_counter):
    """Sixteen threads expand sixteen parts of a depth-14 frontier at
    once, 100,000 nodes each at chunk 8192; every fourth at the least
    capacity, which relaunches.  Each count and leftover is the plain
    version's bit for bit, and the launches overlapped."""
    kw = dict(b0=4.0, max_depth=14, chunk=8192)
    root = (root_digest(19, cuda_device),
            torch.zeros(1, dtype=torch.int32, device=cuda_device))
    _, dig, dep = uts_expand(*root, 20_000, backend="ref", **kw)
    bags = list(zip(torch.tensor_split(dig, WORKERS, dim=1),
                    torch.tensor_split(dep, WORKERS)))
    uts_expand(*bags[0], 1_000, backend="cuda", **kw)  # build and load
    reset_expand_overlap()
    before = launches("uts_expand")
    start = threading.Barrier(WORKERS, timeout=60)
    got, errors = [None] * WORKERS, []

    def work(k):
        try:
            start.wait()
            got[k] = uts_expand(*bags[k], 100_000, backend="cuda",
                                capacity=1 if k % 4 == 0 else None, **kw)
        except BaseException as e:  # re-raised below, on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,))
               for k in range(WORKERS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    seen = expand_overlap()
    assert seen.launches == launches("uts_expand") - before > WORKERS
    assert seen.overlapped > 0 and seen.peak >= 2
    for k, (d, p) in enumerate(bags):
        want = uts_expand(d, p, 100_000, backend="ref", **kw)
        assert got[k][0] == want[0] > 0
        assert torch.equal(got[k][1], want[1])
        assert torch.equal(got[k][2], want[2])
