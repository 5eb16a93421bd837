"""The port's training loss and its gradients against the reference package.

``loss_fn`` and its gradient with respect to every parameter, for all ten
smoke configs, against ``jax.value_and_grad(loss_fn)`` of the reference on
the same weights (``convert.params_from_jax``) and the same batch (numpy,
from a seed), in float32 (MoE at capacity factor 16, so that no pair is
dropped and routing cannot flip on float noise).  This covers the dense
families, the attention layers through the ``FlashAttention`` autograd
function (its CPU backward: autograd over the plain version), MoE's
router aux loss, deepseek-v3's MLA and MTP head, the frontend configs'
``embeds``, and Mamba and RWKV-6 through the plain scans.  Tolerances:
the loss to 1e-5 relative, each leaf's gradient to 1e-4 of its largest
value (float32 sums in other orders over a few thousand terms; measured:
at most 1.6e-7 and 1.2e-5).  ``remat`` changes no value: "none", "full"
and "dots" give the same bits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import init_params as jax_init
from repro.models import loss_fn as jax_loss_fn
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.convert import BF16Bits, params_from_jax, params_to_jax
from repro_torch.models import loss_fn
from repro_torch.optim import tree_leaves, tree_map

B, S = 2, 12
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def setup(arch, dtype, seed=1):
    """(reference cfg, port cfg, reference params, port params, batch)."""
    def cfg_of(c):
        c = dataclasses.replace(c, dtype=dtype)
        if c.moe is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=16.0))
        return c
    cfg, tcfg = cfg_of(jax_smoke(arch)), cfg_of(get_smoke_config(arch))
    params = jax.jit(jax_init, static_argnums=0)(cfg, jax.random.PRNGKey(seed))
    tparams = params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    rng = np.random.default_rng(seed)
    if cfg.frontend is not None:
        batch = {"embeds": rng.standard_normal((B, S, cfg.d_model))
                 .astype(np.float32),
                 "labels": rng.integers(0, cfg.vocab_size, (B, S))
                 .astype(np.int32)}
    else:
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    return cfg, tcfg, params, tparams, batch


def jax_value_and_grad(cfg, params, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(cfg, p, b), has_aux=True))
    (loss, metrics), grads = fn(params, jax.tree.map(jnp.asarray, batch))
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        jax.tree.map(np.asarray, grads)


def port_value_and_grad(tcfg, tparams, batch, remat="full"):
    """(loss, metrics, gradients in the reference's layout as numpy)."""
    leaves = tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = loss_fn(tcfg, tparams,
                            {k: torch.from_numpy(v) for k, v in
                             batch.items()}, remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(t): g if g is not None else torch.zeros_like(t)
             for t, g in zip(leaves, grads)}
    gtree = params_to_jax(tcfg, tree_map(lambda t: by_id[id(t)], tparams))
    return float(loss.detach()), {k: float(v.detach()) for k, v in
                                  metrics.items()}, gtree


def as_float32(a) -> np.ndarray:
    if isinstance(a, BF16Bits):
        a = (a.view(np.ndarray).astype(np.uint32) << 16).view(np.float32)
    return np.asarray(a, np.float32)


def leaf_errors(got, want) -> dict:
    """{path: max |got - want| / max |want|} over the reference's leaves."""
    out = {}
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        w32, g32 = as_float32(w), as_float32(g)
        assert g32.shape == w32.shape, jax.tree_util.keystr(path)
        out[jax.tree_util.keystr(path)] = float(
            np.abs(g32 - w32).max() / max(np.abs(w32).max(), 1e-30))
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference_float32(arch):
    cfg, tcfg, params, tparams, batch = setup(arch, "float32")
    jl, jm, jg = jax_value_and_grad(cfg, params, batch)
    tl, tm, tg = port_value_and_grad(tcfg, tparams, batch)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL, atol=1e-7)
    if cfg.mtp_depth:
        assert "mtp_nll" in tm
    if cfg.moe:
        assert tm["router_aux"] > 0
    errs = leaf_errors(tg, jg)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])


@pytest.mark.parametrize("arch", ["gemma3-1b", "jamba-v0.1-52b"])
def test_remat_policies_change_no_value(arch):
    _, tcfg, _, tparams, batch = setup(arch, "float32")
    outs = [port_value_and_grad(tcfg, tparams, batch, remat=r)
            for r in ("none", "full", "dots")]
    for loss, metrics, grads in outs[1:]:
        assert loss == outs[0][0] and metrics == outs[0][1]
        for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(outs[0][2])):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="remat"):
        loss_fn(tcfg, tparams, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, remat="some")
