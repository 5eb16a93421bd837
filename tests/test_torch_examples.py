"""The port's examples (``repro_torch.examples``) on the CPU at small
sizes: each ``main(device="cpu", ...)`` passes its own oracle, as the
reference's ``examples/*.py`` do, and what it computes equals the JAX
package's: the UTS count, the Mariani-Silver dwell map it saves, and the
betweenness map (within the reference's BC test tolerances), which
networkx's exact Brandes confirms as the reference example does."""
import networkx as nx
import numpy as np
import pytest
import torch

from repro.algorithms import MSParams as JMSParams
from repro.algorithms import RMATParams as JRMATParams
from repro.algorithms import UTSParams as JUTSParams
from repro.algorithms import naive_render as jax_naive_render
from repro.algorithms import rmat_graph as jax_rmat_graph
from repro.algorithms import uts_sequential as jax_uts_sequential
from repro_torch.algorithms import RMATParams, rmat_graph
from repro_torch.examples import (betweenness_centrality, mandelbrot_render,
                                  quickstart)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; PyTorch's intra-op threads would
    oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_counts_the_reference_tree():
    out = quickstart.main("cpu", max_depth=6)
    want = jax_uts_sequential(JUTSParams(seed=19, b0=4.0, max_depth=6,
                                         chunk=4096))
    assert out["nodes"] == want == 1787
    assert out["elastic"]["tasks"] >= 1 and out["sim"]["virtual_s"] > 0
    assert out["controller"]["tasks"] >= 1


def test_mandelbrot_render_saves_the_reference_dwell_map(tmp_path):
    path = str(tmp_path / "dwell.npy")
    out = mandelbrot_render.main("cpu", side=32, max_dwell=64,
                                 initial_subdivision=2, max_depth=2,
                                 out=path)
    want = jax_naive_render(JMSParams(width=32, height=32, max_dwell=64,
                                      initial_subdivision=2, max_depth=2))
    assert np.array_equal(np.load(path), want)
    assert out["out"] == path
    assert out["local"]["tasks"] == out["elastic"]["tasks"] == \
        out["hybrid"]["tasks"] > 0


def test_betweenness_centrality_matches_the_reference_and_networkx():
    out = betweenness_centrality.main("cpu", scale=6, n_tasks=4)
    adj = jax_rmat_graph(JRMATParams(scale=6, edge_factor=8, seed=2))
    g = nx.from_numpy_array(adj, create_using=nx.DiGraph)
    ref = nx.betweenness_centrality(g, normalized=False)
    ref = np.array([ref[i] for i in range(adj.shape[0])])
    assert out["vertices"] == 64 and out["edges"] == int(adj.sum())
    assert out["tasks"] == 4
    np.testing.assert_allclose(out["centrality"], ref, rtol=1e-4, atol=1e-3)


def test_host_brandes_equals_networkx():
    graph = rmat_graph(RMATParams(scale=5, edge_factor=8, seed=3))
    got = betweenness_centrality.brandes(graph.n, graph.out_indptr,
                                         graph.out_indices)
    g = nx.DiGraph()
    g.add_nodes_from(range(graph.n))
    for v in range(graph.n):
        for w in graph.out_indices[graph.out_indptr[v]:
                                   graph.out_indptr[v + 1]]:
            g.add_edge(v, int(w))
    ref = nx.betweenness_centrality(g, normalized=False)
    np.testing.assert_allclose(got, [ref[i] for i in range(graph.n)],
                               rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("example", [quickstart, mandelbrot_render,
                                     betweenness_centrality],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_example_without_cuda_raises(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=None means the CUDA card"):
        example.main()
