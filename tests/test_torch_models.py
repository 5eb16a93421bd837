"""The port's model stack against the reference package.

Smoke configs of every ported family: gemma3-1b (GELU, tied head,
local/global windows, G = 2), glm4-9b and chatglm3-6b (SiLU-gated MLP,
partial rotary_dim), starcoder2-15b (plain GELU MLP), the frontend stubs
musicgen-medium and llava-next-mistral-7b (``embeds`` in, no token
embedding), deepseek-moe-16b (a dense layer, then MoE with a shared
expert), deepseek-v3-671b (MLA, MoE and the MTP head's parameters),
rwkv6-1.6b (RWKV-6 time and channel mix, no attention) and jamba-v0.1-52b
(Mamba, one attention layer, MLP and MoE, in one period).
Both packages run the same weights: the JAX ``init_params`` pytree goes to
the port through ``convert.params_from_jax``.  In float32, with the MoE
capacity factor at 16 as in ``tests/test_models_consistency.py`` (no pair
drops, so discrete routing cannot flip on float noise; deepseek-moe-16b
also at its default capacity, where pairs drop), the port's ``forward``,
``prefill`` and decode-after-prefill match the reference to 5e-4 (that
file's tolerance) and the prefill caches agree (the recurrent layers'
states and shifted inputs, which have no sequence axis, included); the
bfloat16 cases are held against the reference's own bf16 error, as stated
where they are used.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import decode_step as jax_decode
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init
from repro.models import prefill as jax_prefill
from repro.models.layers import apply_rope as jax_rope
from repro.models.layers import mlp_block as jax_mlp
from repro.models.layers import rms_norm as jax_rms
from repro.models.layers import rope_freqs as jax_freqs
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro.models import init_cache as jax_init_cache
from repro_torch.models import (MambaConfig, ShardCtx, decode_step, forward,
                                init_cache, init_params, prefill)
from repro_torch.models.layers import apply_rope, mlp_block, rms_norm, \
    rope_freqs

ARCHS = ["gemma3-1b", "glm4-9b", "chatglm3-6b", "starcoder2-15b",
         "musicgen-medium", "llava-next-mistral-7b", "deepseek-moe-16b",
         "deepseek-v3-671b", "rwkv6-1.6b", "jamba-v0.1-52b"]
#: the recurrent families (their caches carry states, not sequences)
RECURRENT = ["rwkv6-1.6b", "jamba-v0.1-52b"]
#: the forward and prefill/decode cases: every arch at capacity factor 16,
#: and deepseek-moe-16b once more at its default, where pairs drop
CASES = [pytest.param(a, 16.0, id=a) for a in ARCHS] + [
    pytest.param("deepseek-moe-16b", None,
                 id="deepseek-moe-16b-default-capacity")]
B, S = 2, 12
TOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _setup(arch, dtype="float32", seed=2, capacity_factor=16.0):
    def cfg_of(c):
        c = dataclasses.replace(c, dtype=dtype)
        if c.moe is not None and capacity_factor is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=capacity_factor))
        return c

    cfg = cfg_of(jax_smoke(arch))
    params = jax_init(cfg, jax.random.PRNGKey(seed))
    tcfg = cfg_of(get_smoke_config(arch))
    tparams = params_from_jax(tcfg, _np_tree(params), device="cpu")
    rng = np.random.default_rng(seed)
    if cfg.frontend is not None:
        toks = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    else:
        toks = rng.integers(0, cfg.vocab_size, (B, S))
    return cfg, params, tcfg, tparams, toks


def _tok(toks, a, b):
    if toks.ndim == 3:
        return {"embeds": torch.from_numpy(toks[:, a:b].copy())}
    return {"tokens": torch.from_numpy(toks[:, a:b].astype(np.int64))}


def _jtok(toks, a, b):
    if toks.ndim == 3:
        return {"embeds": jnp.asarray(toks[:, a:b])}
    return {"tokens": jnp.asarray(toks[:, a:b], jnp.int32)}


def test_registry_mirrors_reference():
    """Every config of the reference's registry is ported and equals the
    reference's, field by field; an unknown id raises."""
    assert ARCH_IDS == JAX_ARCH_IDS
    assert sorted(ARCHS) == sorted(ARCH_IDS)
    for arch in ARCHS:
        for mine, ref in ((get_config(arch), jax_get_config(arch)),
                          (get_smoke_config(arch), jax_smoke(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("nope")


def test_params_from_jax_unstacks_every_leaf():
    cfg, params, tcfg, tparams, _ = _setup("gemma3-1b")
    stacked = params["stage0"]["block2"]["mixer"]["wq"]["w"]
    n = tcfg.stages[0].n_periods
    assert len(tparams["stage0"]) == n == stacked.shape[0]
    for p in range(n):
        np.testing.assert_array_equal(
            tparams["stage0"][p]["block2"]["mixer"]["wq"]["w"].numpy(),
            np.asarray(stacked[p]))
    # the port's own init has the same names and shapes
    mine = init_params(tcfg, 0, device="cpu")
    flat = lambda t: {k: tuple(v.shape) for k, v in _flatten(t)}
    assert flat(mine) == flat(tparams)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b"])
def test_params_from_jax_carries_moe_mla_and_mtp_trees(arch):
    """The expert stacks [E, ...] (and the float32 router), MLA's latent
    projections and the top-level ``mtp`` subtree (not stacked: one block)
    go across leaf for leaf, in the port's own init's names, shapes and
    dtypes."""
    cfg, params, tcfg, tparams, _ = _setup(arch, dtype="bfloat16")
    mine = init_params(tcfg, 0, device="cpu")
    shapes = lambda t: {k: (tuple(v.shape), v.dtype) for k, v in _flatten(t)}
    assert shapes(mine) == shapes(tparams)
    want = dict(_flatten(jax.tree.map(np.asarray, params)))
    moe = tparams["stage1"][1]["block0"]["ffn"]
    assert moe["gate"].shape[0] == tcfg.moe.n_experts
    assert moe["router"]["w"].dtype == torch.float32
    for name, got in _flatten(tparams):
        if name.startswith("/stage"):
            # /stage1[1]/block0/... <- /stage1/block0/... at period 1
            stage, rest = name[1:].split("[", 1)
            period, rest = rest.split("]", 1)
            ref = want[f"/{stage}{rest}"][int(period)]
        else:
            ref = want[name]
        assert got.shape == ref.shape, name
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, np.float32))
    assert ("mtp" in tparams) == bool(tcfg.mtp_depth)
    if tcfg.mla is not None:
        assert "wkv_b" in tparams["stage0"][0]["block0"]["mixer"]
        assert set(tparams["mtp"]) == {"combine", "block"}


@pytest.mark.parametrize("arch", RECURRENT)
def test_params_and_cache_from_jax_carry_recurrent_trees(arch):
    """The Mamba and RWKV-6 parameter trees (float32 A_log, D, dt_bias,
    u, w_bias beside the bf16 projections) and their caches go across leaf
    for leaf, bit for bit, in the port's own init's names, shapes and
    dtypes."""
    cfg, params, tcfg, tparams, toks = _setup(arch, dtype="bfloat16")
    mine = init_params(tcfg, 0, device="cpu")
    shapes = lambda t: {k: (tuple(v.shape), v.dtype) for k, v in _flatten(t)}
    assert shapes(mine) == shapes(tparams)
    want = dict(_flatten(jax.tree.map(np.asarray, params)))
    for name, got in _flatten(tparams):
        if name.startswith("/stage"):
            stage, rest = name[1:].split("[", 1)
            period, rest = rest.split("]", 1)
            ref = want[f"/{stage}{rest}"][int(period)]
        else:
            ref = want[name]
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref, np.float32))
    first = tparams["stage0"][0]["block0"]
    assert first["mixer"]["A_log" if arch.startswith("jamba") else
                          "u"].dtype == torch.float32
    # the caches: a zeroed one, and a prefill's
    _, pre_cache = jax_prefill(cfg, params, _jtok(toks, 0, S))
    for ref in (jax_init_cache(cfg, B, S), pre_cache):
        got = cache_from_jax(tcfg, _np_tree(ref), device="cpu")
        mine = init_cache(tcfg, B, S, device="cpu")
        assert set(dict(_flatten(got))) == set(dict(_flatten(mine)))
        refd = dict(_flatten(_np_tree(ref)))
        for name, t in _flatten(got):
            stage, rest = name[1:].split("[", 1)
            period, rest = rest.split("]", 1)
            r = refd[f"/{stage}{rest}"][int(period)]
            assert tuple(t.shape) == r.shape
            np.testing.assert_array_equal(t.float().numpy(),
                                          np.asarray(r, np.float32))
    rec = first["mixer"]
    assert set(rec) >= ({"A_log", "D", "conv_w"} if arch.startswith("jamba")
                        else {"u", "w_bias", "mix"})


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    pos = np.arange(5)[None].repeat(2, 0)
    for rd in (8, 4):
        jc, js = jax_freqs(jnp.asarray(pos), rd, 1e4)
        tc, ts = rope_freqs(torch.from_numpy(pos), rd, 1e4)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
        want = np.asarray(jax_rope(jnp.asarray(x), jc, js, rd))
        got = apply_rope(torch.from_numpy(x), tc, ts, rd).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
    h = rng.standard_normal((2, 5, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        rms_norm({"scale": torch.from_numpy(scale)}, torch.from_numpy(h)),
        np.asarray(jax_rms({"scale": jnp.asarray(scale)}, jnp.asarray(h))),
        atol=1e-6, rtol=1e-6)
    w = {k: rng.standard_normal(s).astype(np.float32) * 0.3
         for k, s in (("up", (16, 24)), ("gate", (16, 24)),
                      ("down", (24, 16)))}
    for act in ("gelu", "silu"):
        tw = {k: {"w": torch.from_numpy(v)} for k, v in w.items()}
        jw = {k: {"w": jnp.asarray(v)} for k, v in w.items()}
        np.testing.assert_allclose(
            mlp_block(tw, torch.from_numpy(h), act).numpy(),
            np.asarray(jax_mlp(jw, jnp.asarray(h), act)), atol=1e-5,
            rtol=1e-5)


@pytest.mark.parametrize("arch,cf", CASES)
def test_forward_matches_reference(arch, cf):
    cfg, params, tcfg, tparams, toks = _setup(arch, capacity_factor=cf)
    want, want_aux = jax_forward(cfg, params, _jtok(toks, 0, S),
                                 remat="none")
    got, aux = forward(tcfg, tparams, _tok(toks, 0, S))
    assert got.shape == (B, S, cfg.vocab_size)
    # the MoE layers' load-balance losses, summed (0 without MoE)
    assert (float(aux) > 0) == (cfg.moe is not None)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("arch,cf", CASES)
def test_prefill_cache_and_decode_match_reference(arch, cf):
    cfg, params, tcfg, tparams, toks = _setup(arch, seed=3,
                                              capacity_factor=cf)
    pre = S - 3
    want_fwd, _ = jax_forward(cfg, params, _jtok(toks, 0, S), remat="none")
    want_lp, want_cache = jax_prefill(cfg, params, _jtok(toks, 0, pre))
    with torch.inference_mode():
        lp, cache = prefill(tcfg, tparams, _tok(toks, 0, pre))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), atol=TOL)
    ref_cache = dict(_flatten(cache_from_jax(tcfg, _np_tree(want_cache),
                                             device="cpu")))
    got_cache = dict(_flatten(cache))
    # two leaves a layer: k and v, MLA's c_kv and k_pe, Mamba's conv and
    # ssm, or RWKV-6's state and x_prev, and then its channel mix's x_prev
    assert set(got_cache) == set(ref_cache)
    assert len(got_cache) == sum(
        (2 + (spec.ffn == "rwkv6_cmix")) * st.n_periods
        for st in tcfg.stages for spec in st.pattern)
    arena = init_cache(tcfg, B, S, device="cpu")
    for name, dst in _flatten(arena):
        got, want = got_cache[name], ref_cache[name]
        assert got.shape == want.shape and got.dtype == want.dtype
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        # decode on from the prefill cache, in an arena of length S: the
        # attention caches padded, the recurrent states as they are
        if dst.shape == got.shape:
            dst.copy_(got)
        else:
            assert got.shape[:2] == (B, pre)
            dst[:, :pre] = got
    jarena = jax.tree.map(
        lambda d, c: c if d.shape == c.shape else jnp.pad(
            c, [(0, n - m) for n, m in zip(d.shape, c.shape)]),
        jax_init_cache(cfg, B, S), want_cache)
    for t in range(pre, S):
        pos = np.full((B,), t, np.int32)
        with torch.inference_mode():
            lg, arena = decode_step(tcfg, tparams, arena, _tok(toks, t, t + 1),
                                    torch.from_numpy(pos.astype(np.int64)))
        jlg, jarena = jax_decode(cfg, params, jarena, _jtok(toks, t, t + 1),
                                 jnp.asarray(pos))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=TOL)
        if cf is not None:
            # at the default capacity the forward's late tokens may lose
            # pairs that one-token decode steps keep
            np.testing.assert_allclose(lg.numpy(),
                                       np.asarray(want_fwd[:, t]), atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Twin of ``tests/test_models_consistency.py::test_decode_matches_forward``
    on the port alone: token by token from an empty cache, each decode
    step's logits equal the forward's at that position (for MLA, the
    absorbed form against the expanded one)."""
    _, _, tcfg, tparams, toks = _setup(arch, seed=4)
    with torch.inference_mode():
        want, _ = forward(tcfg, tparams, _tok(toks, 0, S))
        cache = init_cache(tcfg, B, S, device="cpu")
        for t in range(S):
            lg, cache = decode_step(tcfg, tparams, cache,
                                    _tok(toks, t, t + 1),
                                    torch.full((B,), t, dtype=torch.long))
            np.testing.assert_allclose(lg.numpy(), want[:, t].numpy(),
                                       atol=TOL)


def _route_as(monkeypatch, experts):
    """Both packages' MoE layers route to ``experts`` (one [T, k] tensor
    per MoE layer, in order of execution) instead of their own top-k,
    weighted by their own renormalised router probabilities."""
    import repro.models.moe as jax_moe
    import repro_torch.models.moe as torch_moe
    calls = {"torch": 0, "jax": 0}

    def pick(pkg):
        e = experts[calls[pkg] % len(experts)]
        calls[pkg] += 1
        return e

    def torch_route(router_w, x, cfg):
        e = pick("torch")
        w = torch.softmax(x.float() @ router_w, dim=-1).gather(1, e)
        return w / w.sum(-1, keepdim=True).clamp_min(1e-9), e, \
            torch.zeros(())

    def jax_route(router_w, x, cfg):
        e = jnp.asarray(pick("jax").numpy(), jnp.int32)
        probs = jax.nn.softmax(x.astype(jnp.float32) @ router_w, axis=-1)
        w = jnp.take_along_axis(probs, e, axis=1)
        return w / jnp.maximum(w.sum(-1, keepdims=True), 1e-9), e, \
            jnp.float32(0)

    monkeypatch.setattr(torch_moe, "_route", torch_route)
    monkeypatch.setattr(jax_moe, "_route", jax_route)


def _float32_routing(tcfg, tparams, toks, monkeypatch):
    """The experts each MoE layer of the port picks, in order, running
    the same weights in float32."""
    import repro_torch.models.moe as torch_moe
    kept = []
    route = torch_moe._route

    def keep(router_w, x, cfg):
        out = route(router_w, x, cfg)
        kept.append(out[1])
        return out

    cfg32 = dataclasses.replace(tcfg, dtype="float32")
    f32 = jax.tree.map(lambda t: t.float(), tparams)
    with monkeypatch.context() as m:
        m.setattr(torch_moe, "_route", keep)
        forward(cfg32, f32, _tok(toks, 0, S))
    return kept


def _bf16_forward_case(arch, monkeypatch=None, near=2**-5):
    """With ``monkeypatch``, both packages' MoE layers take the routing of
    the float32 model (``_route_as``).  ``near``: the logits' largest
    distance from the reference's bf16 ones, as a share of their largest
    value; None holds instead the largest distance from the float32
    logits to 1.25 times the reference's own."""
    cfg, params, tcfg, tparams, toks = _setup(arch, dtype="bfloat16")
    if monkeypatch is not None:
        _route_as(monkeypatch, _float32_routing(tcfg, tparams, toks,
                                                monkeypatch))
    want, _ = jax_forward(cfg, params, _jtok(toks, 0, S), remat="none")
    f32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    exact, _ = jax_forward(dataclasses.replace(cfg, dtype="float32"), f32,
                           _jtok(toks, 0, S), remat="none")
    got, _ = forward(tcfg, tparams, _tok(toks, 0, S))
    assert got.dtype == torch.bfloat16
    want, exact = np.asarray(want, np.float32), np.asarray(exact)
    got = got.float().numpy()
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))
    assert rms(got - exact) <= 1.25 * rms(want - exact)
    if near is None:
        assert np.abs(got - exact).max() <= 1.25 * np.abs(want - exact).max()
    else:
        np.testing.assert_allclose(got, want, atol=near * np.abs(want).max(),
                                   rtol=0)


def test_bf16_forward_matches_reference():
    """bfloat16 weights and activations.  Both packages round to bf16 at
    nearly the same places (the reference's XLA flash also rounds its
    accumulator per key chunk); what differs most is the order of the
    float32 sums inside each bf16 product, so an output differs by an ulp
    here and there and the gap grows over the layers.  The yardstick is the reference's own
    bf16 error: on the same weights in float32 (exact upcasts), the port's
    bf16 logits may stray from the float32 reference no more than 1.25
    times as far (in rms) as the reference's bf16 logits do.  The logits
    also stay within 2**-5 of the largest logit of the reference's bf16
    ones."""
    _bf16_forward_case("gemma3-1b")


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v3-671b"])
def test_bf16_moe_and_mla_forward_match_reference(arch):
    """The same two bounds as ``test_bf16_forward_matches_reference`` for
    the MoE and MLA families in bfloat16 (capacity factor 16, float32
    router): MLA's float32 q and k against bf16 v, the experts' batched
    products and the combine in bf16."""
    _bf16_forward_case(arch)


@pytest.mark.parametrize("arch,near", [("rwkv6-1.6b", 2**-5),
                                       ("jamba-v0.1-52b", None)])
def test_bf16_recurrent_forward_match_reference(arch, near, monkeypatch):
    """The same two bounds for the recurrent families in bfloat16: Mamba's
    prefill convolution summed in bf16 in the reference's order, its scan
    and RWKV-6's in float32 from bf16 projections, and jamba's attention
    and MoE layers beside them (capacity factor 16).  jamba's 4 experts
    have near-ties (router probabilities 0.1902 against 0.1901 in this
    case) that bf16 rounding flips in either package at its own tokens,
    moving that token's logits by a tenth of their scale: so both
    packages route as the float32 model does, which leaves the rounding
    of each as the only difference.  jamba's bf16 logits stray from the
    float32 ones by up to 5.9 % of their scale in the reference itself
    (0.227 of 3.84, more than 2**-5), so its second bound is the
    reference's own worst error, times 1.25, as the first is in rms."""
    _bf16_forward_case(arch, monkeypatch, near)


def test_bf16_prefill_cache_dtypes_match_reference():
    """In a bf16 model RoPE returns float32 k, as the reference's does, so
    the prefill cache holds float32 k and bf16 v in both packages."""
    cfg, params, tcfg, tparams, toks = _setup("glm4-9b", dtype="bfloat16")
    _, want = jax_prefill(cfg, params, _jtok(toks, 0, S))
    with torch.inference_mode():
        _, cache = prefill(tcfg, tparams, _tok(toks, 0, S))
    ref = cache_from_jax(tcfg, _np_tree(want), device="cpu")
    pairs = list(zip(_flatten(cache), _flatten(ref)))
    assert len(pairs) == 2 * tcfg.n_layers
    for (name, got), (rname, exp) in pairs:
        assert name == rname and got.shape == exp.shape
        assert got.dtype == exp.dtype == (
            torch.float32 if name.endswith("/k") else torch.bfloat16)


def test_unported_blocks_raise():
    """What still raises, naming ROADMAP.md: a block kind the reference
    does not have.  ``ShardCtx`` and the MoE mesh path are ported:
    ``ShardCtx`` carries the reference's axes (``tests/test_torch_mesh.py``
    runs it).  The Mamba and RWKV-6 blocks are ported: each mixer and ffn
    pairing that used to raise builds and runs, in any combination with
    the others (a gemma3-1b smoke period with its first block swapped)."""
    ctx = ShardCtx(mesh=None)
    assert (ctx.dp_axes, ctx.tp_axis, ctx.param_specs) == (("data",),
                                                          "model", None)
    base = get_smoke_config("gemma3-1b")
    for kind in ({"mixer": "conv"}, {"ffn": "kan"}):
        odd = dataclasses.replace(base, stages=(dataclasses.replace(
            base.stages[0], pattern=(dataclasses.replace(
                base.stages[0].pattern[0], **kind),)),))
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            init_params(odd, 0, device="cpu")
    cfg = dataclasses.replace(get_smoke_config("gemma3-1b"), dtype="float32",
                              mamba=MambaConfig(d_state=4, d_conv=2),
                              rwkv_head_size=16)
    spec = cfg.stages[0].pattern[0]
    toks = torch.arange(10)[None] % cfg.vocab_size
    for mixer, ffn in (("mamba", "mlp"), ("rwkv6", "mlp"),
                       ("rwkv6", "rwkv6_cmix"), ("attn", "rwkv6_cmix")):
        mixed = dataclasses.replace(cfg, stages=(dataclasses.replace(
            cfg.stages[0], pattern=(dataclasses.replace(
                spec, mixer=mixer, ffn=ffn),)),))
        params = init_params(mixed, 0, device="cpu")
        assert params["stage0"][0]["block0"]["mixer"]
        logits, aux = forward(mixed, params, {"tokens": toks})
        assert logits.shape == (1, 10, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all()) and float(aux) == 0
