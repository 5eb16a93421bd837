"""The port's recurrent mixers against the reference package, on the CPU.

Mamba (``repro_torch.models.mamba``) and RWKV-6's time and channel mix
(``repro_torch.models.rwkv6``) run the reference's weights, carried by
``convert.params_from_jax``, on inputs made from a numpy seed, in float32;
every output and cache is held within 1e-5 of the largest |value| of the
reference's (float32 rounding: the two frameworks sum in other orders).
The plain scans (``kernels/selective_scan/ref.py``, ``kernels/wkv6/ref.py``)
are held against the reference's own step functions at several shapes:
selective_scan against a loop over ``_ssm_step``; wkv6 against the
reference's ``lax.scan`` inside ``_tmix_full``, fed the same r, k, v and
w.  The per-head norm is held against the reference's on a case where
``torch.var``'s default (the unbiased variance) would fail.  The CUDA
wrappers refuse CPU tensors and wrong dtypes, and a build without
``nvcc`` raises; the kernels themselves are held against the plain
versions on the card by ``tests/test_torch_recurrent_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.rwkv6 as jax_rwkv
from repro.models import mamba as jax_mamba
from repro.models.config import MambaConfig as JaxMambaConfig
from repro_torch.convert import params_from_jax
from repro_torch.kernels import _build
from repro_torch.kernels.selective_scan.ops import (selective_scan,
                                                    selective_scan_cuda,
                                                    selective_scan_ref)
from repro_torch.kernels.wkv6.ops import wkv6, wkv6_cuda, wkv6_ref
from repro_torch.models import mamba, rwkv6
from repro_torch.models.config import MambaConfig

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL):
    """|got - want| within ``rel`` of the largest |want|."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _carry(tree):
    """A reference parameter or cache subtree -> the port's tensors."""
    return params_from_jax(None, {"t": jax.tree.map(np.asarray, tree)},
                           device="cpu")["t"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the plain scans against the reference's steps ----------------------------

def _scan_inputs(rng, b, s, di, n):
    xi = rng.standard_normal((b, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)) - 2)).astype(
        np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (di, 1))
    state = rng.standard_normal((b, di, n)).astype(np.float32)
    return xi, dt, bm, cm, a, state


@pytest.mark.parametrize("b,s,di,n", [(1, 1, 8, 4), (2, 9, 16, 4),
                                      (3, 17, 24, 8), (1, 33, 64, 16),
                                      (2, 5, 130, 16)])
def test_plain_selective_scan_matches_ssm_step(b, s, di, n):
    """y at every step and the final state, against a loop over the
    reference's ``_ssm_step`` (which takes x * B formed beforehand)."""
    rng = np.random.default_rng(b * 1000 + s)
    xi, dt, bm, cm, a, state = _scan_inputs(rng, b, s, di, n)
    st = jnp.asarray(state)
    want = []
    for t in range(s):
        bx = jnp.einsum("bd,bn->bdn", xi[:, t], bm[:, t])
        st, y = jax_mamba._ssm_step(st, (jnp.asarray(dt[:, t]), bx,
                                         jnp.asarray(cm[:, t])),
                                    jnp.asarray(a))
        want.append(np.asarray(y))
    state_t = _t(state.copy())
    y, out = selective_scan(_t(xi), _t(dt), _t(bm), _t(cm), _t(a), state_t)
    assert out is state_t                       # updated in place
    _close(y, np.stack(want, axis=1))
    _close(state_t, st)


def _reference_wkv(r, k, v, w, u, state, monkeypatch):
    """The reference's scan of ``_tmix_full`` over the given r, k, v, w
    ([B, S, H, hd]): its projections are replaced by these operands and
    ``jax.lax.scan``'s own result is kept.  Returns (o, final state)."""
    b, s, h, hd = r.shape
    d = h * hd
    flat = [jnp.asarray(a.reshape(b, s, d)) for a in (r, k, v, w)]
    ones = jnp.ones((b, s, d), jnp.float32)
    monkeypatch.setattr(jax_rwkv, "_tmix_inputs",
                        lambda params, x, x_prev: (*flat[:3], ones, flat[3]))
    kept = {}
    real_scan = jax.lax.scan

    def scan(*args, **kw):
        kept["out"] = real_scan(*args, **kw)
        return kept["out"]

    monkeypatch.setattr(jax.lax, "scan", scan)
    params = {"u": jnp.asarray(u), "ln_out": {"scale": jnp.ones(d)},
              "wo": {"w": jnp.eye(d, dtype=jnp.float32)}}
    jax_rwkv._tmix_full(params, jnp.zeros((b, s, d), jnp.float32), hd,
                        jnp.asarray(state), jnp.zeros((b, d), jnp.float32))
    monkeypatch.undo()
    final, outs = kept["out"]
    return np.moveaxis(np.asarray(outs), 0, 1), np.asarray(final)


def _wkv_inputs(rng, b, s, h, hd):
    r, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((b, s, h, hd)) - 2)).astype(
        np.float32)
    u = (rng.standard_normal((h, hd)) * 0.1).astype(np.float32)
    state = rng.standard_normal((b, h, hd, hd)).astype(np.float32)
    return r, k, v, w, u, state


@pytest.mark.parametrize("b,s,h,hd", [(1, 1, 1, 16), (2, 7, 2, 16),
                                      (1, 20, 3, 64), (3, 4, 2, 8)])
def test_plain_wkv6_matches_reference_scan(b, s, h, hd, monkeypatch):
    rng = np.random.default_rng(b * 100 + s * 10 + h)
    r, k, v, w, u, state = _wkv_inputs(rng, b, s, h, hd)
    want_o, want_state = _reference_wkv(r, k, v, w, u, state, monkeypatch)
    state_t = _t(state.copy())
    o, out = wkv6(_t(r), _t(k), _t(v), _t(w), _t(u), state_t)
    assert out is state_t                       # updated in place
    assert o.shape == (b, s, h, hd) and o.dtype == torch.float32
    _close(o, want_o)
    _close(state_t, want_state)


def test_group_norm_is_population_variance(monkeypatch):
    """The per-head norm of the reference takes ``jnp.var``, the population
    variance; ``torch.var`` defaults to the unbiased one (hd / (hd - 1)
    times larger), which would move this case's output by some 3 %."""
    rng = np.random.default_rng(5)
    b, s, h, hd = 2, 3, 2, 16
    d = h * hd
    o = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    g = rng.standard_normal((b, s, d)).astype(np.float32)
    scale = rng.standard_normal(d).astype(np.float32)
    wo = rng.standard_normal((d, d)).astype(np.float32)
    zeros = jnp.zeros((b, s, d), jnp.float32)
    monkeypatch.setattr(jax_rwkv, "_tmix_inputs", lambda params, x, x_prev: (
        zeros, zeros, zeros, jnp.asarray(g), jnp.ones((b, s, d))))
    monkeypatch.setattr(jax.lax, "scan", lambda *a, **kw: (
        None, jnp.moveaxis(jnp.asarray(o), 1, 0)))
    params = {"u": jnp.zeros((h, hd)), "ln_out": {"scale": jnp.asarray(scale)},
              "wo": {"w": jnp.asarray(wo)}}
    want, _ = jax_rwkv._tmix_full(params, zeros, hd, None,
                                  jnp.zeros((b, d), jnp.float32))
    monkeypatch.undo()
    tparams = {"ln_out": {"scale": _t(scale)}, "wo": {"w": _t(wo)}}
    got = rwkv6._mix_out(tparams, _t(o), _t(g), torch.float32)
    _close(got, want)
    # the default (unbiased) variance misses by far more than the tolerance
    ot = _t(o)
    mu = ot.mean(-1, keepdim=True)
    biased = ((ot - mu) * torch.rsqrt(ot.var(-1, keepdim=True) + 64e-5))
    wrong = (biased.reshape(b, s, d) * _t(scale)) * _t(g) @ _t(wo)
    gap = float((wrong - _t(np.array(want))).abs().max())
    assert gap > 100 * REL * float(np.abs(np.asarray(want)).max())


# -- Mamba against the reference ----------------------------------------------

MAMBA_CASES = [
    # (batch, seq, d_model, d_state, d_conv, expand); a prefill's cache holds
    # the last d_conv - 1 inputs, so seq is at least that
    (1, 3, 16, 4, 4, 2), (2, 11, 32, 4, 4, 2), (2, 9, 32, 16, 4, 2),
    (3, 6, 24, 8, 2, 1),
]


def _mamba_setup(b, s, d, n, k, e, seed=0):
    jcfg = JaxMambaConfig(d_state=n, d_conv=k, expand=e)
    cfg = MambaConfig(d_state=n, d_conv=k, expand=e)
    params = jax_mamba.init_mamba(jax.random.PRNGKey(seed), d, jcfg,
                                  dtype=jnp.float32)
    # the init's dt_bias and conv_b are 0: give them values, so their paths
    # count too
    rng = np.random.default_rng(seed)
    params["dt_bias"] = jnp.asarray(rng.standard_normal(
        params["dt_bias"].shape).astype(np.float32) * 0.5)
    params["conv_b"] = jnp.asarray(rng.standard_normal(
        params["conv_b"].shape).astype(np.float32) * 0.1)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    return jcfg, cfg, params, _carry(params), x


@pytest.mark.parametrize("b,s,d,n,k,e", MAMBA_CASES)
def test_mamba_train_matches_reference(b, s, d, n, k, e):
    jcfg, cfg, params, tparams, x = _mamba_setup(b, s, d, n, k, e)
    want = jax_mamba.mamba_train(params, jnp.asarray(x), jcfg)
    _close(mamba.mamba_train(tparams, _t(x), cfg), want)


@pytest.mark.parametrize("b,s,d,n,k,e", MAMBA_CASES)
def test_mamba_prefill_and_decode_match_reference(b, s, d, n, k, e):
    """The prefill's output and cache (conv window, ssm state), then three
    decode steps on from it, each output and the cache after it (which
    the port updates in place)."""
    jcfg, cfg, params, tparams, x = _mamba_setup(b, s, d, n, k, e, seed=1)
    rng = np.random.default_rng(2)
    steps = rng.standard_normal((3, b, 1, d)).astype(np.float32)
    want, jc = jax_mamba.mamba_prefill(params, jnp.asarray(x), jcfg)
    got, c = mamba.mamba_prefill(tparams, _t(x), cfg)
    _close(got, want)
    assert set(c) == {"conv", "ssm"}
    for key in c:
        _close(c[key], jc[key])
    for t in range(3):
        want, jc = jax_mamba.mamba_decode(params, jc, jnp.asarray(steps[t]),
                                          jcfg)
        got, c2 = mamba.mamba_decode(tparams, c, _t(steps[t]), cfg)
        assert c2 is c
        _close(got, want)
        for key in c:
            _close(c[key], jc[key])


def test_mamba_cache_init_matches_reference():
    jcfg = JaxMambaConfig(d_state=4, d_conv=4, expand=2)
    want = jax_mamba.init_mamba_cache(3, 16, jcfg, dtype=jnp.bfloat16)
    got = mamba.init_mamba_cache(3, 16, MambaConfig(d_state=4, d_conv=4,
                                                    expand=2),
                                 torch.bfloat16, torch.device("cpu"))
    for key in ("conv", "ssm"):
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)
        assert not got[key].any()


# -- RWKV-6 against the reference ---------------------------------------------

RWKV_CASES = [
    # (batch, seq, d_model, head_size, d_ff)
    (1, 1, 32, 16, 64), (2, 10, 32, 16, 64), (1, 7, 64, 64, 96),
    (3, 5, 48, 16, 32),
]


def _rwkv_setup(b, s, d, hs, dff, seed=0):
    tm = jax_rwkv.init_rwkv_tmix(jax.random.PRNGKey(seed), d, hs,
                                 dtype=jnp.float32)
    cm = jax_rwkv.init_rwkv_cmix(jax.random.PRNGKey(seed + 1), d, dff,
                                 dtype=jnp.float32)
    # a decay bias that keeps the state from fading to nothing in a few
    # steps, so the recurrence is exercised
    rng = np.random.default_rng(seed)
    tm["w_bias"] = jnp.asarray(rng.uniform(-3, 0, d).astype(np.float32))
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    return tm, cm, _carry(tm), _carry(cm), x


@pytest.mark.parametrize("b,s,d,hs,dff", RWKV_CASES)
def test_rwkv_tmix_train_matches_reference(b, s, d, hs, dff):
    tm, _, ttm, _, x = _rwkv_setup(b, s, d, hs, dff)
    want = jax_rwkv.rwkv_tmix_train(tm, jnp.asarray(x), hs)
    _close(rwkv6.rwkv_tmix_train(ttm, _t(x), hs), want)


@pytest.mark.parametrize("b,s,d,hs,dff", RWKV_CASES)
def test_rwkv_tmix_prefill_and_decode_match_reference(b, s, d, hs, dff):
    tm, _, ttm, _, x = _rwkv_setup(b, s, d, hs, dff, seed=3)
    steps = np.random.default_rng(4).standard_normal((3, b, 1, d)).astype(
        np.float32)
    want, jc = jax_rwkv.rwkv_tmix_prefill(tm, jnp.asarray(x), hs)
    got, c = rwkv6.rwkv_tmix_prefill(ttm, _t(x), hs)
    _close(got, want)
    assert set(c) == {"state", "x_prev"}
    for key in c:
        _close(c[key], jc[key])
    for t in range(3):
        want, jc = jax_rwkv.rwkv_tmix_decode(tm, jc, jnp.asarray(steps[t]),
                                             hs)
        got, c2 = rwkv6.rwkv_tmix_decode(ttm, c, _t(steps[t]), hs)
        assert c2 is c
        _close(got, want)
        for key in c:
            _close(c[key], jc[key])


@pytest.mark.parametrize("b,s,d,hs,dff", RWKV_CASES)
def test_rwkv_cmix_matches_reference(b, s, d, hs, dff):
    """train, prefill (output and cache) and three decode steps."""
    _, cm, _, tcm, x = _rwkv_setup(b, s, d, hs, dff, seed=5)
    steps = np.random.default_rng(6).standard_normal((3, b, 1, d)).astype(
        np.float32)
    _close(rwkv6.rwkv_cmix_train(tcm, _t(x)),
           jax_rwkv.rwkv_cmix_train(cm, jnp.asarray(x)))
    want, jc = jax_rwkv.rwkv_cmix_prefill(cm, jnp.asarray(x))
    got, c = rwkv6.rwkv_cmix_prefill(tcm, _t(x))
    _close(got, want)
    _close(c["x_prev"], jc["x_prev"])
    for t in range(3):
        want, jc = jax_rwkv.rwkv_cmix_decode(cm, jc, jnp.asarray(steps[t]))
        got, c2 = rwkv6.rwkv_cmix_decode(tcm, c, _t(steps[t]))
        assert c2 is c
        _close(got, want)
        _close(c["x_prev"], jc["x_prev"])


def test_rwkv_cache_init_matches_reference():
    want_t = jax_rwkv.init_rwkv_tmix_cache(2, 32, 16, dtype=jnp.bfloat16)
    want_c = jax_rwkv.init_rwkv_cmix_cache(2, 32, dtype=jnp.bfloat16)
    cpu = torch.device("cpu")
    got_t = rwkv6.init_rwkv_tmix_cache(2, 32, 16, torch.bfloat16, cpu)
    got_c = rwkv6.init_rwkv_cmix_cache(2, 32, torch.bfloat16, cpu)
    for got, want in ((got_t, want_t), (got_c, want_c)):
        assert set(got) == set(want)
        for key in got:
            assert tuple(got[key].shape) == want[key].shape
            assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype)


def test_init_trees_match_reference():
    """The port's own init: the reference's names, shapes and dtypes, and
    its deterministic leaves (A_log = log(1..N), D = 1, dt_bias = 0;
    w_bias = -6, ln_out scale 1)."""
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(0)
    jcfg = JaxMambaConfig(d_state=4, d_conv=4, expand=2)
    cases = (
        (mamba.init_mamba(gen, 16, MambaConfig(d_state=4, d_conv=4,
                                               expand=2),
                          torch.bfloat16, cpu),
         jax_mamba.init_mamba(jax.random.PRNGKey(0), 16, jcfg)),
        (rwkv6.init_rwkv_tmix(gen, 32, 16, torch.bfloat16, cpu),
         jax_rwkv.init_rwkv_tmix(jax.random.PRNGKey(0), 32, 16)),
        (rwkv6.init_rwkv_cmix(gen, 32, 64, torch.bfloat16, cpu),
         jax_rwkv.init_rwkv_cmix(jax.random.PRNGKey(0), 32, 64)))
    for mine, ref in cases:
        want = {jax.tree_util.keystr(p): a for p, a in
                jax.tree_util.tree_leaves_with_path(ref)}
        got = {jax.tree_util.keystr(p): a for p, a in
               jax.tree_util.tree_leaves_with_path(mine)}
        assert set(got) == set(want)
        for key, a in want.items():
            assert tuple(got[key].shape) == a.shape, key
            assert str(got[key].dtype).split(".")[-1] == str(a.dtype), key
    m, t = cases[0][0], cases[1][0]
    np.testing.assert_array_equal(m["A_log"].numpy(),
                                  np.asarray(cases[0][1]["A_log"]))
    assert bool((m["D"] == 1).all()) and not m["dt_bias"].any()
    assert bool((t["w_bias"] == -6).all())
    assert bool((t["ln_out"]["scale"] == 1).all())


# -- the CUDA wrappers on the CPU ---------------------------------------------

def test_selective_scan_cuda_wrapper_rejects_cpu_tensors_and_wrong_dtypes():
    ops = [torch.zeros(s) for s in ((1, 2, 8), (1, 2, 8), (1, 2, 4),
                                    (1, 2, 4), (8, 4), (1, 8, 4))]
    with pytest.raises(ValueError, match="CUDA tensors"):
        selective_scan_cuda(*ops)
    for i in range(len(ops)):
        bad = list(ops)
        bad[i] = bad[i].to(torch.bfloat16)
        with pytest.raises(TypeError, match="float32"):
            selective_scan_cuda(*bad)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        selective_scan(*ops, backend="cuda")


def test_wkv6_cuda_wrapper_rejects_cpu_tensors_and_wrong_dtypes():
    ops = [torch.zeros(s) for s in ((1, 2, 2, 16),) * 4 + ((2, 16),
                                                          (1, 2, 16, 16))]
    with pytest.raises(ValueError, match="CUDA tensors"):
        wkv6_cuda(*ops)
    for i in range(len(ops)):
        bad = list(ops)
        bad[i] = bad[i].double()
        with pytest.raises(TypeError, match="float32"):
            wkv6_cuda(*bad)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        wkv6(*ops, backend="cuda")


@pytest.mark.parametrize("name", ["selective_scan", "wkv6"])
def test_scan_kernel_build_without_nvcc_raises(name, monkeypatch, tmp_path):
    """No compiler, no kernel: the build raises instead of falling back."""
    monkeypatch.setattr(_build, "_build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    assert name in _build.KERNELS
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load(name)
    assert list(tmp_path.iterdir()) == []


def test_plain_versions_are_the_registered_reference_bodies():
    from repro_torch.kernels.dispatch import get_kernel
    assert get_kernel("selective_scan").reference_body is selective_scan_ref
    assert get_kernel("wkv6").reference_body is wkv6_ref
