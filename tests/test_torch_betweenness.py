"""The port's betweenness centrality against the reference package on the
CPU (mirrors tests/test_betweenness.py): the R-MAT graph is the
reference's edge for edge; ``bc_batch`` on the CSR graph agrees with the
reference's dense ``bc_batch`` and with networkx's Brandes; the plain
level steps agree with a dense restatement of the reference's loop
bodies, padded source columns included; ``bc_spec`` over the port's pools
equals ``bc_single_node``, bit for bit across shard counts; the WAL
codecs round-trip a partial exactly and write the reference's JSON.  The
plain level steps' bit-packed masks and ``live`` words are held against
numpy's packing of a plain BFS's distances, and their level-ordered
values against its path counts and the coefficient's formula, at every
level.  Tests marked ``cuda`` hold each level kernel against its plain
version on the card, the whole state bit for bit."""
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
from repro_torch.kernels.bc.ops import (bc_backward_level,
                                        bc_backward_level_cuda,
                                        bc_forward_level,
                                        bc_forward_level_cuda, level_values,
                                        pack_bits, put_level,
                                        sum_over_sources, sweep_state,
                                        unpack_bits)

# the reference's own tolerances (tests/test_betweenness.py)
RTOL, ATOL = 1e-4, 1e-3
# the reference's distance of a vertex not reached (betweenness.py's _INF)
INF = 2**30


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


def _level_state(dist, sigma, n_real):
    """The port's state for the vertex-major level-0 ``dist`` and
    ``sigma`` [N, S']: ``sigma`` in level order, ``coeff``, the masks
    (the first ``n_real`` columns live) and level 0's ``base``."""
    at0 = dist == 0
    base = torch.zeros((dist.shape[0], max(1, dist.shape[1] // 512)),
                       dtype=torch.int32)
    sig = torch.zeros_like(sigma)
    put_level(sig, at0, sigma, base)
    return (sig, torch.zeros_like(sig), pack_bits(dist != INF),
            pack_bits(at0), base,
            pack_bits(torch.arange(dist.shape[1]) < n_real))


def _dense_sigma(sig, on, base):
    """The level-ordered ``sig`` back in source order, every level's."""
    s = sig.shape[1]
    return sum(level_values(sig, unpack_bits(o, s), b)
               for o, b in zip(on, base))


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
    sig, coeff, visited, on0, base0, live = _level_state(dist, sigma, s)
    on, base = [on0], [base0]
    level = 0
    while True:
        nxt, at, live = bc_forward_level(g.in_indptr, g.in_indices, sig,
                                         visited, on[level], base[level],
                                         live, level)
        on.append(nxt)
        base.append(at)
        dist_t, sigma_t = _dense_forward(adj, dist_t, sigma_t, level)
        level += 1
        # the masks are the distances; path counts are small integers, so
        # both sums are exact
        for lvl, o in enumerate(on):
            at_lvl = unpack_bits(o, s + pad)
            assert torch.equal(at_lvl[:, :s], (dist_t == lvl).T)
            assert not at_lvl[:, s:].any()
        assert torch.equal(_dense_sigma(sig, on, base)[:, :s], sigma_t.T)
        assert torch.equal(unpack_bits(live, s + pad)[:s],
                           (dist_t == level).any(dim=1))
        if not bool(live.any()):
            break
    assert level >= 3
    delta = torch.zeros_like(sig)
    delta_t = torch.zeros_like(sigma_t)
    for lvl in range(level, 0, -1):
        bc_backward_level(g.out_indptr, g.out_indices, sig, delta, coeff,
                          on[lvl], on[lvl - 1], base[lvl], base[lvl - 1], lvl)
        delta_t = _dense_backward(adj, dist_t, sigma_t, delta_t, lvl)
        np.testing.assert_allclose(delta[:, :s].numpy(), delta_t.T.numpy(),
                                   rtol=1e-6, atol=1e-6)
    assert not delta[:, s:].any()


def test_forward_level_skips_sources_that_are_not_live():
    g = rmat_graph(RMATParams(scale=6, seed=2)).to("cpu")
    dist = torch.full((g.n, 32), INF, dtype=torch.int32)
    sigma = torch.zeros((g.n, 32))
    src = torch.tensor([1, 2])
    dist[src, torch.arange(2)] = 0
    sigma[src, torch.arange(2)] = 1.0
    sig, _, visited, on0, base0, _ = _level_state(dist, sigma, 2)
    nxt, _, live = bc_forward_level(g.in_indptr, g.in_indices, sig, visited,
                                    on0, base0,
                                    pack_bits(torch.arange(32) < 1), 0)
    live = unpack_bits(live, 32)
    assert live[0] == bool(g.out_indptr[2] > g.out_indptr[1]) and \
        not live[1:].any()
    assert not unpack_bits(nxt, 32)[:, 1].any()


# -- the plain versions' masks, live words and values at every level --------------

def _np_pack(mask) -> np.ndarray:
    """numpy's packing of a bool ``[..., S]``: int32 words, bit b of word
    j for column ``32 j + b``, the last word padded with zeros."""
    m = np.asarray(mask, bool)
    s = m.shape[-1]
    pad = -s % 32
    m = np.concatenate([m, np.zeros(m.shape[:-1] + (pad,), bool)], axis=-1)
    return np.packbits(m, axis=-1, bitorder="little").view("<i4")


def _bfs(g, sources):
    """Distances and shortest-path counts from each source, by a plain
    queue-based BFS over the CSR: ``[N, S]`` each, -1 if not reached."""
    ip, ix = np.asarray(g.out_indptr), np.asarray(g.out_indices)
    dist = np.full((g.n, len(sources)), -1)
    sigma = np.zeros((g.n, len(sources)))
    for c, s in enumerate(sources):
        dist[s, c], sigma[s, c] = 0, 1.0
        queue = [s]
        for v in queue:
            for w in ix[ip[v]:ip[v + 1]]:
                if dist[w, c] < 0:
                    dist[w, c] = dist[v, c] + 1
                    queue.append(w)
                if dist[w, c] == dist[v, c] + 1:
                    sigma[w, c] += sigma[v, c]
    return dist, sigma


class _Recorder:
    """Level steps for ``bc_batch(steps=...)`` through the plain versions
    that keep what every level left behind."""

    def __init__(self):
        self.fwd, self.bwd = [], []

    def forward(self, *args, backend=None):
        *_, sig, visited, on, base, live, level = args
        if level == 0:
            self.start = {"sig": sig.clone(), "visited": visited.clone(),
                          "on": on.clone(), "base": base.clone(),
                          "live": live.clone()}
        nxt, at, live_next = bc_forward_level(*args, backend="ref")
        self.fwd.append({"level": level, "sig": sig.clone(),
                         "visited": visited.clone(), "on": nxt, "base": at,
                         "live": live_next})
        return nxt, at, live_next

    def backward(self, *args, backend=None):
        *_, sig, delta, coeff, on, on_below, base, base_below, level = args
        if not self.bwd:
            self.coeff_before = coeff.clone()
        bc_backward_level(*args, backend="ref")
        self.bwd.append({"level": level, "delta": delta.clone(),
                         "coeff": coeff.clone(), "on": on,
                         "on_below": on_below, "base_below": base_below})
        return delta


#: real sources of a sweep: low bits of one word; every bit of one word,
#: bit 31 (the sign bit) included; and a second word (S' = 64)
SWEEP_SOURCES = [5, 32, 40]


def _recorded_sweep(n_src: int):
    g = rmat_graph(RMATParams(scale=7, seed=2))
    src = np.random.RandomState(n_src).choice(
        np.flatnonzero(np.diff(g.out_indptr) > 0), n_src, replace=False)
    rec = _Recorder()
    bc_batch(g, torch.from_numpy(src), steps=(rec.forward, rec.backward))
    assert len(rec.fwd) >= 3
    s_pad = rec.fwd[0]["sig"].shape[1]
    assert s_pad == (64 if n_src > 32 else 32)
    dist, sigma = _bfs(g, src)
    pad = np.zeros((g.n, s_pad - n_src))
    return (rec, np.concatenate([dist, pad - 1], axis=1).astype(int),
            np.concatenate([sigma, pad], axis=1).astype(np.float32))


@pytest.mark.parametrize("n_src", SWEEP_SOURCES)
def test_plain_masks_are_the_packing_of_the_distances(n_src):
    rec, dist, _ = _recorded_sweep(n_src)
    start = rec.start
    assert np.array_equal(start["on"].numpy(), _np_pack(dist == 0))
    assert np.array_equal(start["visited"].numpy(), _np_pack(dist == 0))
    for r in rec.fwd:
        lvl = r["level"] + 1
        assert np.array_equal(r["on"].numpy(), _np_pack(dist == lvl))
        assert np.array_equal(r["visited"].numpy(),
                              _np_pack((dist >= 0) & (dist <= lvl)))
    assert not (dist > len(rec.fwd)).any()
    if n_src >= 32:
        # a real source in bit 31: its word is negative where it is set
        assert (start["on"][:, 0] < 0).sum() == 1


@pytest.mark.parametrize("n_src", SWEEP_SOURCES)
def test_plain_live_words_are_the_per_source_live_flags(n_src):
    rec, dist, _ = _recorded_sweep(n_src)
    s_pad = dist.shape[1]
    assert np.array_equal(rec.start["live"].numpy(),
                          _np_pack(np.arange(s_pad) < n_src))
    for r in rec.fwd:
        # a source is live at the next level iff a pair of it joined
        flags = (dist == r["level"] + 1).any(axis=0)
        assert np.array_equal(r["live"].numpy(), _np_pack(flags))
        assert np.array_equal(unpack_bits(r["live"], s_pad).numpy(), flags)


def _runs(values, dist, lvl):
    """numpy's level-ordered row: each row's pairs on levels < lvl, then
    those on lvl, in column order; the ones on lvl as (start, values)."""
    below = ((dist >= 0) & (dist < lvl)).sum(axis=1)
    return below, [values[v][dist[v] == lvl] for v in range(dist.shape[0])]


@pytest.mark.parametrize("n_src", SWEEP_SOURCES)
def test_plain_sigma_is_kept_in_level_order(n_src):
    rec, dist, sigma = _recorded_sweep(n_src)
    for r in [{"level": -1, "sig": rec.start["sig"],
               "base": torch.zeros_like(rec.start["base"])}] + rec.fwd:
        lvl = r["level"] + 1
        start, runs = _runs(sigma, dist, lvl)
        assert np.array_equal(r["base"].numpy()[:, 0], start)
        sig = r["sig"].numpy()
        for v, run in enumerate(runs):
            assert np.array_equal(sig[v, start[v]:start[v] + run.size], run)
            # nothing past the levels reached so far
            assert not sig[v, start[v] + run.size:].any()


@pytest.mark.parametrize("n_src", SWEEP_SOURCES)
def test_plain_coeff_of_finalised_pairs_is_the_formula(n_src):
    rec, dist, sigma = _recorded_sweep(n_src)
    top = len(rec.fwd)
    # the forward sweep writes no coeff; the backward sweep starts at the
    # empty level the BFS ran out on, whose launch writes the deepest
    # pairs' coeff, 1 / sigma (their delta is 0)
    assert not rec.coeff_before.any()
    assert not (dist == top).any() and not rec.bwd[0]["on"].any()
    assert [r["level"] for r in rec.bwd] == list(range(top, 0, -1))
    for r in rec.bwd:
        # the level below's delta is final: its coefficients, in level order
        lvl = r["level"] - 1
        delta, coeff = r["delta"].numpy(), r["coeff"].numpy()
        assert np.array_equal(unpack_bits(r["on_below"], dist.shape[1])
                              .numpy(), dist == lvl)
        want = (np.float32(1.0) + delta) / np.where(sigma > 0, sigma,
                                                    np.float32(1.0))
        start, runs = _runs(want, dist, lvl)
        assert np.array_equal(r["base_below"].numpy()[:, 0], start)
        assert want.dtype == np.float32 and any(run.size for run in runs)
        for v, run in enumerate(runs):
            assert np.array_equal(coeff[v, start[v]:start[v] + run.size]
                                  .view(np.uint32), run.view(np.uint32))


def test_pack_bits_round_trips_the_sign_bit_and_ragged_words():
    rng = np.random.RandomState(0)
    for shape in ((7, 32), (5, 64), (3, 37), (40,)):
        mask = rng.rand(*shape) < 0.5
        mask[..., min(31, shape[-1] - 1)] = True
        words = pack_bits(torch.from_numpy(mask))
        assert words.dtype == torch.int32
        assert np.array_equal(words.numpy(), _np_pack(mask))
        assert np.array_equal(unpack_bits(words, shape[-1]).numpy(), mask)
    top = torch.zeros(32, dtype=torch.bool)
    top[31] = True
    assert pack_bits(top).tolist() == [-2**31]
    assert pack_bits(torch.ones(32, dtype=torch.bool)).tolist() == [-1]


def test_level_order_runs_by_parts_of_512():
    rng = np.random.RandomState(1)
    vals = rng.rand(3, 1024).astype(np.float32)
    mask = rng.rand(3, 1024) < 0.3
    base = rng.randint(0, 100, size=(3, 2)).astype(np.int32)
    packed = torch.zeros((3, 1024))
    put_level(packed, torch.from_numpy(mask), torch.from_numpy(vals),
              torch.from_numpy(base))
    got = packed.numpy()
    for r in range(3):
        for p in range(2):
            cols = slice(512 * p, 512 * p + 512)
            run = vals[r, cols][mask[r, cols]]
            at = 512 * p + base[r, p]
            assert np.array_equal(got[r, at:at + run.size], run)
            assert got[r, cols].astype(bool).sum() == run.size
    back = level_values(packed, torch.from_numpy(mask),
                        torch.from_numpy(base))
    assert np.array_equal(back.numpy(), np.where(mask, vals, np.float32(0)))


def test_sweep_state_sets_one_bit_a_source():
    src = torch.tensor([3, 9, 3, 0] + list(range(10, 46)))   # a repeat
    st = sweep_state(64, src, 64)
    at0 = np.zeros((64, 64), bool)
    at0[src.numpy(), np.arange(src.shape[0])] = True
    assert np.array_equal(st["on"].numpy(), _np_pack(at0))
    assert np.array_equal(st["visited"].numpy(), st["on"].numpy())
    assert np.array_equal(st["live"].numpy(),
                          _np_pack(np.arange(64) < src.shape[0]))
    assert not st["base"].any() and not st["coeff"].any()
    # each source pair's sigma, 1, at the front of its row
    assert np.array_equal(st["sigma"].numpy(),
                          (np.arange(64) < at0.sum(axis=1)[:, None])
                          .astype(np.float32))


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
    sig, coeff, visited, on, base, live = _level_state(
        dist, torch.zeros((g.n, 32)), 32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bc_forward_level_cuda(g.in_indptr, g.in_indices, sig, visited, on,
                              base, live, level=0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bc_backward_level_cuda(g.out_indptr, g.out_indices, sig, sig.clone(),
                               coeff, on, on, base, base, level=1)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        bc_forward_level(g.in_indptr, g.in_indices, sig, visited, on, base,
                         live, 0, backend="cuda")


def test_steps_hook_sees_every_level_in_order():
    g = rmat_graph(RMATParams(scale=7, seed=2))
    src = torch.arange(0, 128, 3)
    calls = []

    def forward(*args, **kw):
        calls.append(("forward", args[-1]))
        return bc_forward_level(*args, **kw)

    def backward(*args, **kw):
        calls.append(("backward", args[-1]))
        return bc_backward_level(*args, **kw)

    got = bc_batch(g, src, steps=(forward, backward))
    assert torch.equal(got, bc_batch(g, src))
    fwd = [lvl for kind, lvl in calls if kind == "forward"]
    assert len(fwd) >= 3 and fwd == list(range(len(fwd)))
    assert calls[len(fwd):] == [("backward", lvl)
                                for lvl in range(len(fwd), 0, -1)]


@pytest.mark.parametrize("max_levels", [1, 2])
def test_cut_sweep_starts_backward_at_an_empty_level(max_levels):
    g = rmat_graph(RMATParams(scale=7, seed=2))
    src = torch.arange(0, 128, 3)
    rec = _Recorder()
    got = bc_batch(g, src, max_levels, steps=(rec.forward, rec.backward))
    assert torch.equal(got, bc_batch(g, src, max_levels))
    assert [r["level"] for r in rec.fwd] == list(range(max_levels))
    assert [r["level"] for r in rec.bwd] == list(range(max_levels + 1, 0,
                                                       -1))
    first = rec.bwd[0]
    assert not first["on"].any() and first["on_below"].any()
    # the cut level's pairs: delta 0 and coeff 1 / sigma, bit for bit
    below = unpack_bits(first["on_below"], first["delta"].shape[1])
    assert not first["delta"][below].any()
    sig = level_values(rec.fwd[-1]["sig"], below, first["base_below"])
    coeff = level_values(first["coeff"], below, first["base_below"])
    assert torch.equal(coeff[below].view(torch.int32),
                       (1.0 / sig[below]).view(torch.int32))


def test_backward_level_writes_delta_of_the_level_below_unread():
    g = rmat_graph(RMATParams(scale=7, seed=2))
    src = torch.arange(0, 128, 3)

    def backward(*args, **kw):
        # what delta held there before the launch must not matter
        *_, delta, coeff, on, on_below, base, base_below, level = args
        delta[unpack_bits(on_below, delta.shape[1])] = 7.0
        return bc_backward_level(*args, **kw)

    assert torch.equal(bc_batch(g, src, steps=(bc_forward_level, backward)),
                       bc_batch(g, src))


# -- the kernels on the card ----------------------------------------------------------

class _TwinSteps:
    """Level steps for ``bc_batch(steps=...)``: every level of a sweep
    through the kernel and the plain version, on twin states, the whole
    state held bit for bit after each level: ``sigma``, ``visited`` and
    the next level's ``on``, ``base`` and live words forward; ``delta``
    and ``coeff`` backward."""

    def __init__(self):
        self.levels = 0

    def forward(self, indptr, indices, sig, visited, on, base, live, level,
                *, backend=None):
        if level == 0:
            self.twin = [t.clone() for t in (sig, visited)]
            self.on, self.base, self.back = [on.clone()], [base.clone()], None
        got = bc_forward_level(indptr, indices, sig, visited, on, base, live,
                               level, backend="cuda")
        want = bc_forward_level(indptr, indices, *self.twin, self.on[level],
                                self.base[level], live, level, backend="ref")
        for a, b in zip((*got, sig, visited), (*want, *self.twin)):
            assert torch.equal(a, b)
        self.on.append(want[0])
        self.base.append(want[1])
        self.levels += 1
        return got

    def backward(self, indptr, indices, sig, delta, coeff, on, on_below,
                 base, base_below, level, *, backend=None):
        if self.back is None:
            self.back = [delta.clone(), coeff.clone()]
        # delta of the level below is written, not read: poison it in both
        below = unpack_bits(on_below, delta.shape[1])
        delta[below] = 7.0
        self.back[0][below] = 7.0
        bc_backward_level(indptr, indices, sig, delta, coeff, on, on_below,
                          base, base_below, level, backend="cuda")
        bc_backward_level(indptr, indices, sig, *self.back, on, on_below,
                          base, base_below, level, backend="ref")
        assert torch.equal(delta, self.back[0])
        assert torch.equal(coeff, self.back[1])
        return delta


@pytest.mark.cuda
@pytest.mark.parametrize("n_src", [40, 1024])
def test_level_kernels_match_plain_on_card(cuda_device, n_src):
    g = rmat_graph(RMATParams(scale=12, seed=2)).to(cuda_device)
    src = torch.from_numpy(np.random.RandomState(3).choice(
        g.n, n_src, replace=False)).to(cuda_device)
    steps = _TwinSteps()
    bc_batch(g, src, steps=(steps.forward, steps.backward))
    assert steps.levels >= 4


@pytest.mark.cuda
def test_bc_batch_on_card_matches_cpu(cuda_device):
    g = rmat_graph(RMATParams(scale=9, seed=7))
    src = torch.arange(0, 512, 5)
    got = bc_batch(g, src.to(cuda_device)).cpu()
    assert torch.equal(got, bc_batch(g, src))
