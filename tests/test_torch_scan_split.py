"""The scan kernels' lane split adds in the plain versions' order.

``csrc/wkv6.cu`` and ``csrc/selective_scan.cu`` sum over the key index
(or the state index) by lanes: each of L neighbouring lanes of a warp
sums its aligned contiguous range of the n values in the recursive halves
tree, then each lane adds its neighbour's sum by ``__shfl_xor_sync`` at
xor 1, 2, 4 in that order.  This file emulates that in plain PyTorch and
holds it to ``tree_sum`` (the order the plain versions add in) bit for
bit, for every (length, lanes) pair the kernels use: 64/8 and 16/2 for
``wkv6`` (16/4 too, a split it could take), 16/4, 8/4 and 4/4 for
``selective_scan``; and it shows that another split (interleaved
ranges, or the xors in another order) gives other bits, so the contract
in the kernels' notes is not vacuous.  The data is float32 from a numpy
seed, of mixed magnitudes so that the order of the sums shows.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.selective_scan.ref import selective_scan_ref, tree_sum
from repro_torch.kernels.wkv6.ref import wkv6_ref

#: (length, lanes) pairs of the kernels' sums
KERNEL_SPLITS = [(64, 8), (16, 2), (16, 4), (8, 4), (4, 4)]


def _terms(seed: int, n: int, rows: int = 4096) -> torch.Tensor:
    """``rows`` sums of ``n`` float32 terms of mixed signs and magnitudes."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n)) * np.exp(3 * rng.standard_normal(
        (rows, n)))
    return torch.from_numpy(x.astype(np.float32))


def lane_split_sum(x: torch.Tensor, lanes: int, *, interleaved: bool = False,
                   xors=None) -> torch.Tensor:
    """The kernels' sum over the last axis of ``x``, lane by lane: lane l
    owns the range [l n/L, (l + 1) n/L) (or, ``interleaved``, the i with
    i mod L = l), sums it with ``tree_sum``, then every lane adds the sum
    of lane l ^ m for m in ``xors`` (default 1, 2, 4, ... < L).  Returns
    ``[..., lanes]``: what each lane holds at the end."""
    n = x.shape[-1]
    if interleaved:
        ranges = x.unflatten(-1, (n // lanes, lanes)).transpose(-1, -2)
    else:
        ranges = x.unflatten(-1, (lanes, n // lanes))
    held = tree_sum(ranges, -1)                              # [..., lanes]
    if xors is None:
        xors = [1 << b for b in range(lanes.bit_length() - 1)]
    for m in xors:
        partner = torch.arange(lanes) ^ m
        held = held + held[..., partner]
    return held


@pytest.mark.parametrize("n,lanes", KERNEL_SPLITS)
def test_lane_split_equals_tree_sum(n, lanes):
    x = _terms(n * 100 + lanes, n)
    held = lane_split_sum(x, lanes)
    want = tree_sum(x, -1)
    # every lane of a column holds the same bits: a pair adds the same two
    # values, and float addition is commutative
    for lane in range(lanes):
        assert torch.equal(held[:, lane], want), lane


@pytest.mark.parametrize("n,lanes", [(64, 8), (16, 4), (16, 2), (8, 4)])
def test_interleaved_split_differs(n, lanes):
    x = _terms(n * 10 + lanes, n)
    held = lane_split_sum(x, lanes, interleaved=True)
    assert not torch.equal(held[:, 0], tree_sum(x, -1))


@pytest.mark.parametrize("n,lanes", [(64, 8), (16, 4)])
def test_xors_in_another_order_differ(n, lanes):
    x = _terms(n + lanes, n)
    xors = [1 << b for b in range(lanes.bit_length() - 1)][::-1]
    held = lane_split_sum(x, lanes, xors=xors)
    assert not torch.equal(held[:, 0], tree_sum(x, -1))


def _wkv6_lanes(r, k, v, w, u, state, lanes):
    """wkv6 as the kernel computes it, the sum over i by ``lane_split_sum``."""
    o = torch.empty(r.shape, dtype=torch.float32)
    uu = u[None, :, :, None]
    st = state.clone()
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]       # [B, H, hd, hd]
        terms = r[:, t, :, :, None] * (st + uu * kv)
        o[:, t] = lane_split_sum(terms.transpose(-1, -2), lanes)[..., 0]
        st = st * w[:, t, :, :, None] + kv
    return o, st


def _scan_lanes(xi, dt, bm, cm, a, state, lanes):
    """selective_scan as the kernel computes it, the sum over n by
    ``lane_split_sum``."""
    y = torch.empty(xi.shape, dtype=torch.float32)
    st = state.clone()
    for t in range(xi.shape[1]):
        dtt = dt[:, t, :, None]
        st = st * torch.exp(dtt * a) + dtt * (xi[:, t, :, None] *
                                             bm[:, t, None, :])
        y[:, t] = lane_split_sum(st * cm[:, t, None, :], lanes)[..., 0]
    return y, st


@pytest.mark.parametrize("hd,lanes", [(64, 8), (16, 2), (16, 4)])
def test_wkv6_lane_split_equals_plain_version(hd, lanes):
    rng = np.random.default_rng(hd + lanes)
    b, s, h = 2, 9, 3
    f = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))
    r, k, v = f(b, s, h, hd, scale=0.5), f(b, s, h, hd), f(b, s, h, hd)
    w = torch.exp(-torch.exp(f(b, s, h, hd) - 2))
    u, state = f(h, hd, scale=0.1), f(b, h, hd, hd, scale=10.0)
    got_o, got_s = _wkv6_lanes(r, k, v, w, u, state, lanes)
    want_s = state.clone()
    want_o, _ = wkv6_ref(r, k, v, w, u, want_s)
    assert torch.equal(got_o, want_o) and torch.equal(got_s, want_s)


@pytest.mark.parametrize("n", [16, 8, 4])
def test_selective_scan_lane_split_equals_plain_version(n):
    rng = np.random.default_rng(n)
    b, s, di = 2, 9, 40
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    xi, bm, cm = f(b, s, di), f(b, s, n), f(b, s, n)
    dt = torch.nn.functional.softplus(f(b, s, di) - 2)
    a = -torch.arange(1, n + 1, dtype=torch.float32).repeat(di, 1)
    state = f(b, di, n) * 10
    got_y, got_s = _scan_lanes(xi, dt, bm, cm, a, state, 4)
    want_s = state.clone()
    want_y, _ = selective_scan_ref(xi, dt, bm, cm, a, want_s)
    assert torch.equal(got_y, want_y) and torch.equal(got_s, want_s)
