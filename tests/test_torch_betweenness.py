"""The port's betweenness centrality against the reference package on the
CPU (mirrors tests/test_betweenness.py): the R-MAT graph is the
reference's edge for edge; ``bc_batch`` on the CSR graph agrees with the
reference's dense ``bc_batch`` and with networkx's Brandes; the plain
level steps agree with a dense restatement of the reference's loop
bodies, padded source columns included; ``bc_spec`` over the port's pools
equals ``bc_single_node``, bit for bit across shard counts; the WAL
codecs round-trip a partial exactly and write the reference's JSON.
Tests marked ``cuda`` hold each level kernel against its plain version
on the card, bit for bit."""
import json

import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

from repro.algorithms import betweenness as jax_bc
from repro_torch.algorithms import betweenness as port_bc
from repro_torch.algorithms import (CSRGraph, RMATParams, bc_batch,
                                    bc_single_node, bc_spec, rmat_graph)
from repro_torch.configs.paper_workloads import BC_SCALED
from repro_torch.core import make_pool, run_irregular
from repro_torch.kernels.bc.ops import (INF, bc_backward_level,
                                        bc_backward_level_cuda,
                                        bc_forward_level,
                                        bc_forward_level_cuda,
                                        sum_over_sources)

# the reference's own tolerances (tests/test_betweenness.py)
RTOL, ATOL = 1e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; PyTorch's intra-op threads would
    oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _nx_bc(adj):
    g = nx.from_numpy_array(adj, create_using=nx.DiGraph)
    d = nx.betweenness_centrality(g, normalized=False)
    return np.array([d[i] for i in range(adj.shape[0])])


def _ref_adj(scale, seed):
    return jax_bc.rmat_graph(jax_bc.RMATParams(scale=scale, seed=seed))


# -- the graph -------------------------------------------------------------------

@pytest.mark.parametrize("seed", [2, 7])
@pytest.mark.parametrize("scale", [5, 6, 7, 8])
def test_rmat_graph_is_the_reference_edge_set(scale, seed):
    mine = rmat_graph(RMATParams(scale=scale, seed=seed)).to_dense()
    ref = _ref_adj(scale, seed)
    assert mine.dtype == ref.dtype == np.float32
    assert np.array_equal(mine, ref)


def test_csr_rows_sorted_distinct_and_transposed():
    g = rmat_graph(RMATParams(scale=7, seed=2))
    assert g.out_indptr.dtype == g.in_indices.dtype == np.int32
    assert g.n_edges == int(g.to_dense().sum()) == g.in_indices.shape[0]
    for indptr, indices in ((g.out_indptr, g.out_indices),
                            (g.in_indptr, g.in_indices)):
        for r in range(g.n):
            row = indices[indptr[r]:indptr[r + 1]]
            assert np.all(np.diff(row) > 0) and r not in row
    rows = np.repeat(np.arange(g.n), np.diff(g.in_indptr))
    transposed = np.zeros((g.n, g.n), np.float32)
    transposed[g.in_indices, rows] = 1.0
    assert np.array_equal(transposed, g.to_dense())


def test_from_dense_rejects_weights_and_round_trips():
    adj = _ref_adj(5, 2)
    assert np.array_equal(CSRGraph.from_dense(adj).to_dense(), adj)
    with pytest.raises(ValueError, match="unweighted"):
        CSRGraph.from_dense(adj * 2)
    with pytest.raises(ValueError, match="square"):
        CSRGraph.from_dense(adj[:4])


# -- bc_batch against the reference and networkx ---------------------------------

@pytest.mark.parametrize("max_levels", [None, 1, 2, 4])
@pytest.mark.parametrize("scale", [6, 7])
def test_bc_batch_matches_reference(scale, max_levels):
    adj = _ref_adj(scale, 2)
    sources = np.random.RandomState(scale).choice(
        adj.shape[0], size=40, replace=False).astype(np.int32)
    want = np.asarray(jax_bc.bc_batch(jnp.asarray(adj), jnp.asarray(sources),
                                      max_levels=max_levels))
    got = bc_batch(CSRGraph.from_dense(adj), torch.from_numpy(sources),
                   max_levels=max_levels)
    assert got.dtype == torch.float32 and got.shape == (adj.shape[0],)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [2, 7])
@pytest.mark.parametrize("scale", [5, 6])
def test_matches_networkx(scale, seed):
    adj = _ref_adj(scale, seed)
    ours = bc_single_node(adj, n_tasks=3, device="cpu")
    np.testing.assert_allclose(ours, _nx_bc(adj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours, jax_bc.bc_single_node(adj, n_tasks=3),
                               rtol=RTOL, atol=ATOL)


def test_partition_invariance():
    g = rmat_graph(RMATParams(scale=6, seed=2))
    a = bc_single_node(g, n_tasks=1, device="cpu")
    b = bc_single_node(g, n_tasks=7, device="cpu")
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)


def test_sources_swept_in_chunks_add_in_chunk_order(monkeypatch):
    g = rmat_graph(RMATParams(scale=6, seed=2))
    src = torch.arange(3, 43)
    whole = bc_batch(g, src)
    monkeypatch.setattr(port_bc, "MAX_SOURCES", 32)
    chunked = bc_batch(g, src)
    assert torch.equal(chunked, bc_batch(g, src[:32]) + bc_batch(g, src[32:]))
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-4)


# -- the plain level steps against the reference's loop bodies ---------------------

def _dense_forward(adj, dist, sigma, level):
    """betweenness.py:104-112, [S, N] float32, in torch."""
    frontier = (dist == level).float()
    reach = (sigma * frontier) @ adj
    newfront = (dist == INF) & (reach > 0)
    dist = torch.where(newfront, level + 1, dist)
    sigma = sigma + torch.where(newfront, reach, 0.0)
    return dist, sigma


def _dense_backward(adj, dist, sigma, delta, lvl):
    """betweenness.py:118-127."""
    safe_sigma = torch.where(sigma > 0, sigma, 1.0)
    w_mask = (dist == lvl).float()
    coeff = w_mask * (1.0 + delta) / safe_sigma
    back = coeff @ adj.T
    v_mask = (dist == lvl - 1).float()
    return delta + v_mask * sigma * back


@pytest.mark.parametrize("pad", [0, 5, 27])
def test_level_steps_match_dense_restatement(pad):
    adj_np = _ref_adj(6, 7)
    n = adj_np.shape[0]
    adj = torch.from_numpy(adj_np)
    g = CSRGraph.from_dense(adj_np).to("cpu")
    src = torch.tensor([0, 5, 9, 33, 60])
    s = src.shape[0]
    dist_t = torch.full((s, n), INF, dtype=torch.int32)
    dist_t[torch.arange(s), src] = 0
    sigma_t = torch.zeros((s, n))
    sigma_t[torch.arange(s), src] = 1.0
    # the port's vertex-major state, with `pad` columns that are no source
    dist = torch.full((n, s + pad), INF, dtype=torch.int32)
    dist[:, :s] = dist_t.T
    sigma = torch.zeros((n, s + pad))
    sigma[:, :s] = sigma_t.T
    live = torch.zeros(s + pad, dtype=torch.int32)
    live[:s] = 1
    level = 0
    while True:
        live = bc_forward_level(g.in_indptr, g.in_indices, dist, sigma, live,
                                level)
        dist_t, sigma_t = _dense_forward(adj, dist_t, sigma_t, level)
        level += 1
        # path counts are small integers: both sums are exact
        assert torch.equal(dist[:, :s], dist_t.T)
        assert torch.equal(sigma[:, :s], sigma_t.T)
        assert torch.equal(live[:s].bool(), (dist_t == level).any(dim=1))
        if not bool(live.any()):
            break
    assert level >= 3
    delta = torch.zeros_like(sigma)
    delta_t = torch.zeros_like(sigma_t)
    for lvl in range(level, 0, -1):
        bc_backward_level(g.out_indptr, g.out_indices, dist, sigma, delta, lvl)
        delta_t = _dense_backward(adj, dist_t, sigma_t, delta_t, lvl)
        np.testing.assert_allclose(delta[:, :s].numpy(), delta_t.T.numpy(),
                                   rtol=1e-6, atol=1e-6)
    assert (dist[:, s:] == INF).all()
    assert not sigma[:, s:].any() and not delta[:, s:].any()


def test_forward_level_skips_sources_that_are_not_live():
    g = rmat_graph(RMATParams(scale=6, seed=2)).to("cpu")
    dist = torch.full((g.n, 32), INF, dtype=torch.int32)
    sigma = torch.zeros((g.n, 32))
    src = torch.tensor([1, 2])
    dist[src, torch.arange(2)] = 0
    sigma[src, torch.arange(2)] = 1.0
    live = bc_forward_level(g.in_indptr, g.in_indices, dist, sigma,
                            torch.tensor([1] + [0] * 31, dtype=torch.int32), 0)
    assert live[0] == int(g.out_indptr[2] > g.out_indptr[1]) and \
        not live[1:].any()
    assert (dist[:, 1] == INF).sum() == g.n - 1


def test_sum_over_sources_is_pairwise_halving():
    x = torch.from_numpy(np.random.RandomState(0).rand(7, 8)
                         .astype(np.float32))
    want = ((x[:, 0] + x[:, 4]) + (x[:, 2] + x[:, 6])) + \
        ((x[:, 1] + x[:, 5]) + (x[:, 3] + x[:, 7]))
    assert torch.equal(sum_over_sources(x), want)
    with pytest.raises(ValueError, match="power of two"):
        sum_over_sources(x[:, :6])


# -- bc_spec over the port's pools --------------------------------------------------

@pytest.mark.parametrize("kind,cfg,batching", [
    ("local", dict(max_concurrency=2, invoke_overhead=0.0), False),
    ("local", dict(max_concurrency=2, invoke_overhead=0.0), True),
    ("elastic", dict(max_concurrency=4, invoke_overhead=0.0,
                     invoke_rate_limit=None), False),
], ids=["local", "local-batching", "elastic"])
def test_bc_spec_matches_single_node(kind, cfg, batching):
    p = RMATParams(scale=6, seed=2)
    expected = bc_single_node(rmat_graph(p), n_tasks=8, device="cpu")
    with make_pool(kind, **cfg) as pool:
        r = run_irregular(pool, bc_spec(p, n_tasks=8, device="cpu"),
                          batching=batching)
    assert r.tasks == 8
    assert r.output.dtype == np.float64
    if batching:
        # fused blocks share one sweep: the same function, another order
        np.testing.assert_allclose(r.output, expected, rtol=RTOL, atol=ATOL)
    else:
        # the same blocks, summed in the same order
        assert np.array_equal(r.output, expected)
    np.testing.assert_allclose(
        r.output, jax_bc.bc_single_node(jax_bc.rmat_graph(
            jax_bc.RMATParams(scale=6, seed=2)), n_tasks=1),
        rtol=RTOL, atol=ATOL)


def test_bc_spec_ships_a_given_graph():
    p = RMATParams(scale=5, seed=7)
    adj = _ref_adj(5, 7)
    expected = bc_single_node(adj, n_tasks=4, device="cpu")
    with make_pool("local", max_concurrency=2, invoke_overhead=0.0) as pool:
        r = run_irregular(pool, bc_spec(p, n_tasks=4, regenerate_graph=False,
                                        adj=adj, device="cpu"))
    assert np.array_equal(r.output, expected)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_bc_bit_identical_across_shards(shards):
    def drive(k):
        with make_pool("elastic", max_concurrency=4, invoke_overhead=0.0,
                       invoke_rate_limit=None) as pool:
            return run_irregular(pool, bc_spec(BC_SCALED, n_tasks=16,
                                               device="cpu"),
                                 shards=k, batching=False).output
    assert np.array_equal(drive(shards), drive(1))


def test_wal_codecs_round_trip_and_match_reference():
    p = RMATParams(scale=5, seed=2)
    spec = bc_spec(p, n_tasks=4, device="cpu")
    ref_spec = jax_bc.bc_spec(jax_bc.RMATParams(scale=5, seed=2), n_tasks=4)
    block = spec.seed(None)[1]
    assert spec.encode_item(block) == ref_spec.encode_item(block)
    key, partial = spec.execute(block, None)
    # values that need every digit of their shortest repr
    partial = partial + np.float32(1 / 3)
    wire = json.loads(json.dumps(spec.encode_result((key, partial))))
    k2, back = spec.decode_result(wire)
    assert k2 == key and back.dtype == partial.dtype == np.float32
    assert np.array_equal(back.view(np.uint32), partial.view(np.uint32))
    assert wire == json.loads(json.dumps(ref_spec.encode_result(
        (key, partial))))
    k3, ref_back = ref_spec.decode_result(wire)
    assert k3 == key and np.array_equal(ref_back, partial)


def test_no_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=None means the CUDA card"):
        bc_spec(BC_SCALED)
    with pytest.raises(RuntimeError, match="CUDA"):
        bc_single_node(_ref_adj(5, 2))


def test_cuda_wrappers_reject_cpu_tensors():
    g = rmat_graph(RMATParams(scale=5, seed=2)).to("cpu")
    dist = torch.full((g.n, 32), INF, dtype=torch.int32)
    sigma = torch.zeros((g.n, 32))
    live = torch.ones(32, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bc_forward_level_cuda(g.in_indptr, g.in_indices, dist, sigma, live,
                              level=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bc_backward_level_cuda(g.out_indptr, g.out_indices, dist, sigma,
                               sigma.clone(), level=1)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        bc_forward_level(g.in_indptr, g.in_indices, dist, sigma, live, 0,
                         backend="cuda")


def test_steps_hook_sees_every_level_in_order():
    g = rmat_graph(RMATParams(scale=7, seed=2))
    src = torch.arange(0, 128, 3)
    calls = []

    def forward(*args, **kw):
        calls.append(("forward", args[5]))
        return bc_forward_level(*args, **kw)

    def backward(*args, **kw):
        calls.append(("backward", args[5]))
        return bc_backward_level(*args, **kw)

    got = bc_batch(g, src, steps=(forward, backward))
    assert torch.equal(got, bc_batch(g, src))
    fwd = [lvl for kind, lvl in calls if kind == "forward"]
    assert len(fwd) >= 3 and fwd == list(range(len(fwd)))
    assert calls[len(fwd):] == [("backward", lvl)
                                for lvl in range(len(fwd), 0, -1)]


# -- the kernels on the card ----------------------------------------------------------

class _TwinSteps:
    """Level steps for ``bc_batch(steps=...)``: every level of a sweep
    through the kernel and the plain version, on twin states, held bit
    for bit after each level."""

    def __init__(self):
        self.levels = 0

    def forward(self, indptr, indices, dist, sigma, live, level, *,
                backend=None):
        if level == 0:
            self.twin, self.delta_ref = [dist.clone(), sigma.clone()], None
        f = bc_forward_level(indptr, indices, dist, sigma, live, level,
                             backend="cuda")
        f_ref = bc_forward_level(indptr, indices, *self.twin, live, level,
                                 backend="ref")
        assert torch.equal(f, f_ref)
        assert torch.equal(dist, self.twin[0])
        assert torch.equal(sigma, self.twin[1])
        self.levels += 1
        return f

    def backward(self, indptr, indices, dist, sigma, delta, level, *,
                 backend=None):
        if self.delta_ref is None:
            self.delta_ref = delta.clone()
        bc_backward_level(indptr, indices, dist, sigma, delta, level,
                          backend="cuda")
        bc_backward_level(indptr, indices, dist, sigma, self.delta_ref,
                          level, backend="ref")
        assert torch.equal(delta, self.delta_ref)
        return delta


@pytest.mark.cuda
def test_level_kernels_match_plain_on_card(cuda_device):
    g = rmat_graph(RMATParams(scale=12, seed=2)).to(cuda_device)
    src = torch.from_numpy(np.random.RandomState(3).choice(
        g.n, 40, replace=False)).to(cuda_device)
    steps = _TwinSteps()
    bc_batch(g, src, steps=(steps.forward, steps.backward))
    assert steps.levels >= 4


@pytest.mark.cuda
def test_bc_batch_on_card_matches_cpu(cuda_device):
    g = rmat_graph(RMATParams(scale=9, seed=7))
    src = torch.arange(0, 512, 5)
    got = bc_batch(g, src.to(cuda_device)).cpu()
    assert torch.equal(got, bc_batch(g, src))
