"""The plain reference against hashlib, the published UTS sizes, and the
port's plain versions at small sizes on the CPU."""
import hashlib
import struct

import numpy as np
import pytest
import torch

from perfbench.reference import sha1_uts as ref
from repro_torch.kernels.uts_hash.ops import uts_expand
from repro_torch.kernels.uts_hash.ref import root_digest as port_root

CPU = torch.device("cpu")
#: nodes of the geometric tree of root seed 19, b0 4, by depth (the UTS
#: benchmark's published sizes, as the paper's Table 1 counts them)
PUBLISHED = {4: 101, 5: 416, 6: 1787, 7: 7134, 8: 28844, 9: 115780,
             10: 461459}


def test_sha1_matches_hashlib():
    rng = np.random.default_rng(0)
    parent = rng.integers(0, 2**32, size=(5, 64), dtype=np.int64)
    index = rng.integers(0, 2**32, size=64, dtype=np.int64)
    got = ref.sha1_child(torch.from_numpy(parent), torch.from_numpy(index))
    for j in range(64):
        msg = struct.pack(">6I", *parent[:, j], index[j])
        want = struct.unpack(">5I", hashlib.sha1(msg).digest())
        assert tuple(got[:, j].tolist()) == want


@pytest.mark.parametrize("depth", sorted(PUBLISHED))
def test_published_uts_sizes(depth):
    assert ref.tree_size(19, b0=4.0, max_depth=depth) == PUBLISHED[depth]


def test_root_digest_equals_the_ports():
    for seed in (0, 19, 2**31 + 5):
        want = port_root(seed, CPU).to(torch.int64) & ref.M32
        assert torch.equal(ref.root_digest(seed, CPU), want)


@pytest.mark.parametrize("iters,chunk", [(50, 8), (300, 32), (10**6, 64)])
def test_a_task_equals_the_ports_plain_traversal(iters, chunk):
    kw = dict(b0=4.0, max_depth=7, chunk=chunk)
    bag_d = ref.root_digest(19, CPU)
    bag_p = torch.zeros(1, dtype=torch.int64)
    # a bag of the tree's third generation, as the port holds it
    _, bag_d, bag_p = ref.traverse(bag_d, bag_p, 3, **kw)
    d32 = bag_d.to(torch.int32)   # uint32 bits in int32
    count, left_d, left_p = uts_expand(d32, bag_p.to(torch.int32), iters,
                                       backend="ref", **kw)
    want = ref.traverse(d32, bag_p, iters, **kw)
    assert count == want[0] and count > 0
    assert torch.equal(left_d.to(torch.int64) & ref.M32, want[1])
    assert torch.equal(left_p.to(torch.int64), want[2])


def test_lockstep_tasks_answer_as_tasks_alone():
    kw = dict(b0=4.0, max_depth=7, chunk=16)
    bags = []
    for seed in (19, 20, 21):
        _, d, p = ref.traverse(ref.root_digest(seed, CPU),
                               torch.zeros(1, dtype=torch.int64), 2, **kw)
        bags.append((d, p))
    together = ref.traverse_many(bags, 200, **kw)
    for (d, p), (count, ld, lp) in zip(bags, together):
        alone = ref.traverse(d, p, 200, **kw)
        assert count == alone[0]
        assert torch.equal(ld, alone[1]) and torch.equal(lp, alone[2])


def test_the_bfloat16_control_changes_child_counts():
    word = np.arange(0, 2**32, 2**32 // 4096, dtype=np.int64)
    depth = np.zeros_like(word)
    f32 = ref.child_counts(word, depth, b0=4.0, max_depth=17)
    bf16 = ref.child_counts(word, depth, b0=4.0, max_depth=17,
                            precision="bfloat16")
    assert (f32 != bf16).mean() > 0.01
