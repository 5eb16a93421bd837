"""The port's optimizer against the reference package.

Twins of ``tests/test_optim.py`` (all eight, on the port's tensors), then
parity with the reference on inputs made from a numpy seed: one
``adamw_update`` of a whole smoke model (deepseek-v3-671b: stacked stage
leaves, the float32 router, MLA, the MTP head's unstacked block; and
gemma3-1b in bf16), which pins the weight-decay choice per leaf (the
reference decays a stacked stage leaf such as a block's norm scale,
[n_periods, D], and not ``final_norm.scale`` [D]) and the clip's round
trip through a bf16 gradient's dtype; ``ef_roundtrip`` and ``compress``
bit for bit.  Float32 leaves agree to 1e-5 of each leaf's largest value
(two float32 evaluations of the same formula, rounding at the update's
scale, with the clip's global norm summed in another order); bf16 leaves
also to one bf16 ulp (at most 2**-7 of the value) where the two float32
results straddle a rounding boundary.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, strategies as st

from repro.configs import get_smoke_config as jax_smoke
from repro.models import init_params as jax_init
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import compress as jax_compress
from repro.optim import ef_roundtrip as jax_ef_roundtrip
from repro.optim import init_ef as jax_init_ef
from repro.optim import init_opt_state as jax_init_opt_state
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (opt_state_from_jax, opt_state_to_jax,
                                 params_from_jax, params_to_jax)
from repro_torch.optim import (AdamWConfig, adamw_update, compress,
                               cosine_schedule, decay_mask, decompress,
                               ef_roundtrip, global_norm, init_ef,
                               init_opt_state, tree_leaves)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- twins of tests/test_optim.py ---------------------------------------------

def test_adamw_minimizes_quadratic():
    cfg = AdamWConfig(peak_lr=0.1, warmup_steps=1, total_steps=200,
                      weight_decay=0.0, grad_clip=10.0)
    params = {"w": torch.tensor([3.0, -2.0, 1.5])}
    state = init_opt_state(params, cfg)
    loss = lambda p: torch.sum(p["w"] ** 2)
    l0 = float(loss(params))
    for _ in range(100):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw_update(params, grads, state, cfg)
    assert float(loss(params)) < 1e-2 * l0


def test_grad_clip_bounds_update():
    cfg = AdamWConfig(peak_lr=1.0, warmup_steps=0, total_steps=10,
                      grad_clip=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = init_opt_state(params, cfg)
    _, _, metrics = adamw_update(params, {"w": torch.full((4,), 1e6)}, state,
                                 cfg)
    assert float(metrics["grad_norm"]) > 1e5  # pre-clip norm reported


def test_schedule_warmup_and_decay():
    cfg = AdamWConfig(peak_lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    lr = cosine_schedule(cfg)
    assert float(lr(torch.tensor(0, dtype=torch.int32))) == 0.0
    assert abs(float(lr(torch.tensor(10))) - 1.0) < 1e-6
    assert float(lr(torch.tensor(55))) < 1.0
    assert abs(float(lr(torch.tensor(100))) - 0.1) < 1e-6


def test_moment_dtypes_configurable():
    cfg = AdamWConfig(m_dtype="bfloat16", v_dtype="bfloat16")
    state = init_opt_state({"w": torch.zeros((4, 4))}, cfg)
    assert state["m"]["w"].dtype == torch.bfloat16
    assert state["v"]["w"].dtype == torch.bfloat16
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0


@given(st.lists(st.floats(-100, 100, allow_nan=False), min_size=1,
                max_size=64))
def test_compress_bounded_error(xs):
    x = torch.tensor(xs, dtype=torch.float32)
    q, scale = compress(x)
    err = (decompress(q, scale) - x).abs()
    assert float(err.max()) <= float(scale) * 0.5 + 1e-6


def test_compression_ratio_is_4x():
    x = torch.ones((1024,), dtype=torch.float32)
    q, _ = compress(x)
    assert q.dtype == torch.int8
    assert q.numel() * q.element_size() * 4 == x.numel() * x.element_size()


def test_error_feedback_preserves_mean_signal():
    """Over repeated identical gradients the dequantized stream's mean is
    within one quantization step of the truth, and the residual stays
    within half a step."""
    g = {"w": torch.tensor([0.05, 5.0, -3.0, 0.02])}
    ef = init_ef(g)
    total = torch.zeros(4)
    n = 60
    for _ in range(n):
        deq, ef = ef_roundtrip(g, ef)
        total = total + deq["w"]
    quantum = 5.0 / 127.0
    err = (total / n - g["w"]).abs()
    assert float(err.max()) <= quantum, (err, quantum)
    assert float(ef["w"].abs().max()) <= quantum / 2 + 1e-6


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert abs(float(global_norm(t)) - 5.0) < 1e-6


# -- parity with the reference -----------------------------------------------

def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _grads_like(tree, rng, scale):
    """Random gradients shaped and typed like ``tree`` (numpy, from rng)."""
    return jax.tree.map(
        lambda a: (rng.standard_normal(np.shape(a)) * scale).astype(
            np.asarray(a).dtype), tree)


def _assert_tree_close(got, want, what):
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            gl):
        g = np.asarray(g).view(np.asarray(w).dtype) \
            if np.asarray(w).dtype.name == "bfloat16" else np.asarray(g)
        w32, g32 = (np.asarray(x, np.float32) for x in (w, g))
        assert g.shape == w32.shape, (what, path)
        # float32: 1e-5 of the leaf's largest value (p - lr * delta rounds
        # at the update's scale, and the clip's global norm is a float32 sum
        # over every gradient taken in another order by XLA and PyTorch);
        # bf16: one ulp of the value besides
        bound = 1e-5 * np.abs(w32).max()
        if np.asarray(w).dtype.name == "bfloat16":
            bound = bound + 2**-7 * np.abs(w32)
        assert np.all(np.abs(g32 - w32) <= bound), (
            what, jax.tree_util.keystr(path),
            float(np.abs(g32 - w32).max()))


@pytest.mark.parametrize("arch,dtype,clip", [
    ("deepseek-v3-671b", "float32", 1.0),   # clip on: the norm is ~30
    ("gemma3-1b", "bfloat16", 1.0),
    ("deepseek-moe-16b", "float32", 1e9),   # clip off
])
def test_whole_model_adamw_update_matches_reference(arch, dtype, clip):
    cfg = dataclasses.replace(jax_smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    params = jax.jit(jax_init, static_argnums=0)(cfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    opt_cfg = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10,
                   grad_clip=clip, weight_decay=0.1)
    jcfg, pcfg = JaxAdamWConfig(**opt_cfg), AdamWConfig(**opt_cfg)
    state = jax_init_opt_state(params, jcfg)
    # one step first, so the moments are not zero
    for step in range(2):
        grads = _grads_like(_np_tree(params), rng, 0.3)
        tparams = params_from_jax(tcfg, _np_tree(params), device="cpu")
        tstate = opt_state_from_jax(tcfg, _np_tree(state), device="cpu")
        tgrads = params_from_jax(tcfg, grads, device="cpu")
        params, state, metrics = jax.jit(jax_adamw_update, static_argnums=3)(
            params, jax.tree.map(jnp.asarray, grads), state, jcfg)
        tparams, tstate, tmetrics = adamw_update(tparams, tgrads, tstate,
                                                 pcfg)
        _assert_tree_close(params_to_jax(tcfg, tparams), _np_tree(params),
                           f"params after step {step}")
        tst = opt_state_to_jax(tcfg, tstate)
        _assert_tree_close(tst["m"], _np_tree(state["m"]), "m")
        _assert_tree_close(tst["v"], _np_tree(state["v"]), "v")
        assert int(tst["step"]) == int(state["step"]) == step + 1
        assert tst["step"].dtype == np.int32
        for k in ("grad_norm", "lr"):
            # the global norm: a float32 sum in another order
            np.testing.assert_allclose(float(tmetrics[k]), float(metrics[k]),
                                       rtol=1e-5)


def test_decay_mask_follows_the_stacked_leaf():
    """A stage leaf counts the reference's leading n_periods axis: a
    block's norm scale is decayed, the final norm's and the MTP block's
    (not stacked) are not, matrices are."""
    tcfg = get_smoke_config("deepseek-v3-671b")
    from repro_torch.models import init_params
    mask = decay_mask(init_params(tcfg, 0, device="cpu"))
    assert mask["stage0"][0]["block0"]["norm1"]["scale"] is True
    assert mask["final_norm"]["scale"] is False
    assert mask["mtp"]["block"]["norm1"]["scale"] is False
    assert mask["mtp"]["combine"]["w"] is True
    assert mask["embed"]["table"] is True


def test_ef_roundtrip_and_compress_match_reference_bit_for_bit():
    rng = np.random.default_rng(7)
    grads = {"a": rng.standard_normal((5, 7)).astype(np.float32),
             "b": {"c": (rng.standard_normal(11) * 1e-3).astype(np.float32)}}
    jef = jax_init_ef(jax.tree.map(jnp.asarray, grads))
    tef = init_ef({"a": torch.zeros(5, 7), "b": {"c": torch.zeros(11)}})
    for _ in range(3):
        jdeq, jef = jax_ef_roundtrip(jax.tree.map(jnp.asarray, grads), jef)
        tdeq, tef = ef_roundtrip(jax.tree.map(torch.from_numpy, grads), tef)
        for j, t in zip(jax.tree.leaves(jdeq) + jax.tree.leaves(jef),
                        tree_leaves(tdeq) + tree_leaves(tef)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    x = rng.standard_normal(1000).astype(np.float32) * 3
    x[:4] = [0.5, 1.5, -2.5, 2.5]   # halves: round to even in both
    jq, js = jax_compress(jnp.asarray(x))
    tq, ts = compress(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_large_leaves_update_a_slice_at_a_time_with_the_same_bits(
        dtype, monkeypatch):
    """With ``SLICE_ELEMS`` below the leaves' sizes the update walks each
    leaf a few rows at a time (3-D, 2-D, 1-D, and a leaf with one row); the
    parameters and moments are those of the whole-leaf update bit for bit."""
    import repro_torch.optim.adamw as adamw_mod
    gen = torch.Generator().manual_seed(0)
    shapes = {"e": (5, 6, 7), "w": (9, 4), "b": (40,), "one": (1, 50)}
    params = {k: torch.randn(s, generator=gen).to(dtype)
              for k, s in shapes.items()}
    grads = {k: torch.randn(s, generator=gen).to(dtype)
             for k, s in shapes.items()}
    cfg = AdamWConfig(warmup_steps=1, total_steps=10)
    runs = []
    for slice_elems in (adamw_mod.SLICE_ELEMS, 11):
        monkeypatch.setattr(adamw_mod, "SLICE_ELEMS", slice_elems)
        p = {k: t.clone() for k, t in params.items()}
        state = init_opt_state(p, cfg)
        for _ in range(2):
            adamw_update(p, grads, state, cfg)
        runs.append((p, state))
    (p1, s1), (p2, s2) = runs
    for k in shapes:
        assert torch.equal(p1[k], p2[k])
        assert torch.equal(s1["m"][k], s2["m"][k])
        assert torch.equal(s1["v"][k], s2["v"][k])
