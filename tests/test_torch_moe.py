"""The port's MoE block against the reference package.

Twins of ``tests/test_moe.py`` (route normalisation, counts, the dense
mixture at high capacity, drops, the shard partition, the convex combine)
run on the port, and direct parity cases feed ``_route`` and
``moe_block_local`` of both packages the same numpy weights and tokens in
float32 at the **default** capacity factor (1.25), where pairs are
dropped: the experts picked, the per-expert counts and so the dropped
pairs must be equal exactly, the outputs within 1e-5 (float32 sums in
another order) and the routing weights and aux loss within 1e-6.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.config import MoEConfig as JaxMoEConfig
from repro.models.moe import _route as jax_route
from repro.models.moe import moe_block_local as jax_moe_block
from repro_torch.models.config import MoEConfig
from repro_torch.models.moe import (_route, expert_capacity, init_moe,
                                    moe_apply, moe_block_local)

CFG = MoEConfig(n_experts=8, top_k=2, d_expert=16, n_shared=0,
                capacity_factor=8.0)
D = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(t, cfg=CFG, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = init_moe(gen, D, cfg, torch.float32, torch.device("cpu"))
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (t, D)).astype(np.float32))
    return params, x


def _local(params, x, cfg=CFG, **kw):
    kw = {"n_shards": 1, "shard_ix": 0, "tp_axis": None, **kw}
    return moe_block_local(params, x, cfg, **kw)


# -- twins of tests/test_moe.py -----------------------------------------------

def test_route_weights_normalized():
    params, x = _setup(64)
    w, e, aux = _route(params["router"]["w"], x, CFG)
    assert w.shape == (64, CFG.top_k)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert int(e.min()) >= 0 and int(e.max()) < CFG.n_experts
    assert float(aux) >= 1.0 - 1e-5  # E*sum(f*p) >= 1 by Cauchy-Schwarz


def test_counts_match_routing():
    params, x = _setup(128)
    _, top_e, _ = _route(params["router"]["w"], x, CFG)
    _, _, counts = _local(params, x)
    hist = np.bincount(top_e.numpy().ravel(), minlength=CFG.n_experts)
    np.testing.assert_array_equal(counts.numpy(), hist)
    assert int(counts.sum()) == 128 * CFG.top_k


def test_high_capacity_equals_dense_mixture():
    """With capacity >= T*k no token drops: the output equals the explicit
    dense mixture sum_k w_k * FFN_{e_k}(x)."""
    params, x = _setup(32)
    w, e, _ = _route(params["router"]["w"], x, CFG)
    out, _, _ = _local(params, x)
    gate, up, down = (params[k].numpy() for k in ("gate", "up", "down"))
    xn = x.numpy()
    expected = np.zeros_like(xn)
    for t in range(32):
        for k in range(CFG.top_k):
            ex = int(e[t, k])
            h = xn[t] @ gate[ex]
            h = (h / (1 + np.exp(-h))) * (xn[t] @ up[ex])  # silu gate
            expected[t] += float(w[t, k]) * (h @ down[ex])
    np.testing.assert_allclose(out.numpy(), expected, rtol=2e-4, atol=2e-4)


def test_capacity_drops_reduce_output_norm():
    tight = dataclasses.replace(CFG, capacity_factor=0.25)
    params, x = _setup(256)
    full, _, _ = _local(params, x)
    dropped, _, _ = _local(params, x, tight)
    # some tokens lost their expert -> strictly less mass, never more
    assert float(torch.linalg.norm(dropped)) < float(torch.linalg.norm(full))


def test_expert_shard_partition_sums_to_whole():
    """The per-shard partial outputs over all shards sum to the
    single-shard output (the psum the reference's shard_map performs)."""
    params, x = _setup(64)
    whole, _, _ = _local(params, x)
    e_loc = CFG.n_experts // 4
    acc = torch.zeros_like(whole)
    for s in range(4):
        shard = {"router": params["router"],
                 **{k: params[k][s * e_loc:(s + 1) * e_loc]
                    for k in ("gate", "up", "down")}}
        part, _, _ = _local(shard, x, n_shards=4, shard_ix=s)
        acc = acc + part
    np.testing.assert_allclose(acc.numpy(), whole.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("t,k", [(4, 1), (17, 2), (50, 3), (96, 4)])
def test_combine_is_convex_in_magnitude(t, k):
    cfg = dataclasses.replace(CFG, top_k=k)
    params, x = _setup(t, cfg)
    out, _, counts = _local(params, x, cfg)
    assert out.shape == x.shape
    assert bool(torch.isfinite(out).all())
    assert int(counts.sum()) <= t * k


def test_mesh_paths_raise():
    """The mesh paths are ported and raise no more: ``moe_block_local``
    with a ``tp_axis`` runs the same body (its caller reduces over the
    axis), and ``moe_apply`` on a world of 1 (a 1 x 1 CPU mesh over gloo,
    n_shards 1) gives ``moe_block_local``'s output bit for bit: the
    replicated dispatch at the block's capacity, the all-to-all dispatch
    at its own per-expert capacity ``c_loc`` (at one shard ``c_send``
    keeps every pair).  Worlds of 4 against the reference:
    ``tests/test_torch_moe_mesh.py``."""
    from repro_torch.launch.mesh import make_host_mesh
    params, x = _setup(16)
    want = _local(params, x)
    got = _local(params, x, tp_axis="model")
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    mesh = make_host_mesh(1, 1, device="cpu")
    y, aux, counts = moe_apply(params, x[None], CFG, mesh=mesh,
                               dp_axes=("data",), tp_axis="model")
    assert torch.equal(y[0], want[0]) and torch.equal(aux, want[1])
    assert torch.equal(counts, want[2])
    pairs = 16 * CFG.top_k
    c_send = max(4, int(pairs * CFG.capacity_factor + 0.999))
    c_loc = max(4, int(c_send * CFG.capacity_factor / CFG.n_experts + 0.999))
    at_c_loc = dataclasses.replace(CFG, capacity_factor=c_loc * CFG.n_experts
                                   / pairs)
    want = _local(params, x, at_c_loc)
    y, aux, _ = moe_apply(params, x[None], CFG, mesh=mesh,
                          dp_axes=("data",), tp_axis="model", dispatch="a2a")
    assert torch.equal(y[0], want[0]) and torch.equal(aux, want[1])


# -- parity with the reference at the default capacity -------------------------

#: (tokens, experts, top-k, act, shards): the default capacity factor 1.25
#: with a router skewed towards the low experts, so that pairs drop
PARITY = [(64, 8, 2, "silu", 1), (200, 16, 4, "silu", 1),
          (96, 8, 3, "gelu", 1), (128, 8, 2, "silu", 4),
          (33, 4, 2, "silu", 1)]


def _parity_inputs(t, e, k, seed):
    rng = np.random.default_rng(seed)
    de = 16
    w = {"router": {"w": (rng.standard_normal((D, e)) / D ** 0.5
                          + np.linspace(1.0, -1.0, e)[None] / D)
                    .astype(np.float32)},
         "gate": (rng.standard_normal((e, D, de)) / D ** 0.5)
         .astype(np.float32),
         "up": (rng.standard_normal((e, D, de)) / D ** 0.5).astype(np.float32),
         "down": (rng.standard_normal((e, de, D)) / de ** 0.5)
         .astype(np.float32)}
    # a shared component in every token skews the router's choices
    x = (rng.standard_normal((t, D)) + 2.0).astype(np.float32)
    return w, x


def _tree(w, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in w.items()}


@pytest.mark.parametrize("t,e,k,act,shards", PARITY)
def test_route_matches_reference(t, e, k, act, shards):
    cfg = MoEConfig(n_experts=e, top_k=k, d_expert=16)
    w, x = _parity_inputs(t, e, k, seed=t)
    jw, je, jaux = jax_route(jnp.asarray(w["router"]["w"]), jnp.asarray(x),
                             JaxMoEConfig(**dataclasses.asdict(cfg)))
    tw, te, taux = _route(torch.from_numpy(w["router"]["w"]),
                          torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("t,e,k,act,shards", PARITY)
def test_block_matches_reference_with_drops(t, e, k, act, shards):
    cfg = MoEConfig(n_experts=e, top_k=k, d_expert=16)
    jcfg = JaxMoEConfig(**dataclasses.asdict(cfg))
    w, x = _parity_inputs(t, e, k, seed=t)
    e_loc = e // shards
    cap = expert_capacity(t, cfg)
    dropped = 0
    for s in range(shards):
        local = {"router": w["router"],
                 **{n: w[n][s * e_loc:(s + 1) * e_loc]
                    for n in ("gate", "up", "down")}}
        jout, jaux, jcounts = jax_moe_block(
            _tree(local, jnp.asarray), jnp.asarray(x), jcfg,
            n_shards=shards, shard_ix=jnp.int32(s), tp_axis=None, act=act)
        out, aux, counts = moe_block_local(
            _tree(local, torch.from_numpy), torch.from_numpy(x), cfg,
            n_shards=shards, shard_ix=s, tp_axis=None, act=act)
        np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
        dropped += int(np.maximum(counts.numpy() - cap, 0).sum())
    assert dropped > 0, "the case must drop pairs"
