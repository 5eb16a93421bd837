"""The port's training step and driver against the reference package.

* Twin of ``tests/test_arch_smoke.py::test_train_step_finite_and_updates``
  over every arch: one step of ``plan_cell``'s train step on the CPU has a
  finite loss and gradient norm, moves the parameters and counts one
  optimizer step.
* Three steps of the port's step against three reference steps of
  ``jax.value_and_grad(loss_fn)`` + ``adamw_update`` from the same weights
  and batches (float32, two untied dense configs): losses to 1e-5
  relative, parameters to 1e-4 of each leaf's largest value.  (With a tied
  head, gemma3-1b's, most embedding rows get gradients near float32's
  noise, which Adam's division by sqrt(v) turns into updates of either
  sign; the loss still agrees, the parameters of those rows do not.)
* ``loss_fn`` and its gradients in bf16 against the reference's bf16, on a
  dense, a MoE, a recurrent and a frontend config: the loss within twice
  the reference's own bf16 error against its float32 loss (plus 1e-4), and
  each gradient leaf within twice the reference's own bf16 error for that
  leaf (at least 2**-8), relative to the leaf's largest value; measured:
  at most 1.63 times.
* The contract of ``tests/test_system.py::test_training_loss_decreases_
  with_restart`` (whose reference run fails: see ROADMAP.md) on glm4-9b's
  smoke config: the loss falls and a restart runs only the remaining
  steps; and a run killed and resumed trains on the unbroken run's batches
  and gives its losses bit for bit.
* MoE's dispatch and combine (``index_add_``, ``scatter_``, gathers) under
  ``torch.autograd.gradcheck``; the production mesh raises without its
  world; the prefill and decode kinds of ``plan_cell``;
  the ``train_lm`` and ``serve_lm`` example twins at small sizes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import loss_fn as jax_loss_fn
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import init_opt_state as jax_init_opt_state
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch.steps import plan_cell
from repro_torch.launch.train import train
from repro_torch.models import init_params
from repro_torch.models.moe import moe_block_local
from repro_torch.optim import AdamWConfig, init_opt_state, tree_leaves

from test_torch_loss import (as_float32, jax_value_and_grad, leaf_errors,
                             port_value_and_grad, setup)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train_shape(b=2, s=16):
    return ShapeSpec("custom", s, b, "train")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_finite_and_updates(arch):
    cfg = get_smoke_config(arch)
    params = init_params(cfg, 1, device="cpu")
    before = [t.clone() for t in tree_leaves(params)]
    opt_cfg = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    opt = init_opt_state(params, opt_cfg)
    plan = plan_cell(cfg, _train_shape(), opt_cfg=opt_cfg, device="cpu")
    batch = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=16, global_batch=2,
        embed_dim=cfg.d_model if cfg.frontend else None)).batch(0)
    p2, o2, metrics = plan.step(params, opt, batch)
    assert p2 is params and o2 is opt              # updated in place
    assert bool(torch.isfinite(metrics["loss"])), f"{arch}: non-finite loss"
    gnorm = float(metrics["grad_norm"])
    assert np.isfinite(gnorm) and gnorm > 0.0
    assert any(not torch.equal(a, b) for a, b in
               zip(before, tree_leaves(params))), f"{arch}: no update"
    assert int(opt["step"]) == 1
    want = {"loss", "nll", "router_aux", "grad_norm", "lr"}
    if cfg.mtp_depth:
        want.add("mtp_nll")
    assert set(metrics) == want


@pytest.mark.parametrize("arch", ["glm4-9b", "starcoder2-15b"])
def test_three_plan_cell_steps_match_reference(arch):
    cfg, tcfg, params, tparams, _ = setup(arch, "float32", seed=5)
    opt_kw = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10)
    jcfg = JaxAdamWConfig(**opt_kw)
    state = jax_init_opt_state(params, jcfg)
    plan = plan_cell(tcfg, _train_shape(), opt_cfg=AdamWConfig(**opt_kw),
                     device="cpu")
    topt = init_opt_state(tparams, plan.opt_cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=2))

    @jax.jit
    def jstep(p, o, b):
        (loss, _), grads = jax.value_and_grad(
            lambda q: jax_loss_fn(cfg, q, b), has_aux=True)(p)
        p2, o2, _ = jax_adamw_update(p, grads, o, jcfg)
        return p2, o2, loss

    for step in range(3):
        batch = data.batch(step)
        params, state, jloss = jstep(params, state,
                                     jax.tree.map(jnp.asarray, batch))
        tparams, topt, metrics = plan.step(tparams, topt, batch)
        np.testing.assert_allclose(float(metrics["loss"]), float(jloss),
                                   rtol=1e-5)
    from repro_torch.convert import params_to_jax
    for (path, w), g in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree.leaves(params_to_jax(tcfg, tparams))):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), \
            jax.tree_util.keystr(path)
    assert int(topt["step"]) == int(state["step"]) == 3


@pytest.mark.parametrize("arch", ["gemma3-1b", "deepseek-moe-16b",
                                  "rwkv6-1.6b", "llava-next-mistral-7b"])
def test_loss_and_grads_match_reference_bfloat16(arch):
    cfg32, _, p32, _, batch = setup(arch, "float32")
    l32, _, g32 = jax_value_and_grad(cfg32, p32, batch)
    cfg, tcfg, params, tparams, batch = setup(arch, "bfloat16")
    jl, _, jg = jax_value_and_grad(cfg, params, batch)
    tl, _, tg = port_value_and_grad(tcfg, tparams, batch)
    assert abs(tl - jl) <= 2 * abs(jl - l32) + 1e-4 * abs(jl)
    e_port, e_ref = leaf_errors(tg, jg), leaf_errors(jg, g32)
    over = {k: (e_port[k], e_ref[k]) for k in e_port
            if e_port[k] > 2 * max(e_ref[k], 2**-8)}
    assert over == {}
    assert all(np.isfinite(as_float32(g)).all() for g in jax.tree.leaves(tg))


def test_training_contract_with_restart(tmp_path):
    """The reference test's contract, on the port: the loss falls, and a
    restart runs only the remaining steps.  The reference test trains 8
    steps; there the logged loss moves less than its batch-to-batch noise
    in either package (the reference's own steps, run without its mesh:
    6.051 -> 6.010; the port's init: 5.953 -> 5.989), so the twin trains
    24 (the port: 5.953 -> 5.732) and restarts to 32."""
    kw = dict(smoke=True, global_batch=4, seq_len=32, ckpt_every=12,
              peak_lr=5e-3, log_every=1, device="cpu")
    out1 = train("glm4-9b", steps=24, ckpt_dir=str(tmp_path), **kw)
    assert out1["final_loss"] < out1["first_loss"]
    out2 = train("glm4-9b", steps=32, ckpt_dir=str(tmp_path), resume=True,
                 **kw)
    assert out2["steps"] == 8 and out2["start_step"] == 24
    assert [s for s, _ in out2["losses"]] == list(range(24, 32))


def test_resumed_run_is_the_unbroken_run(tmp_path):
    """As the reference does not: a run killed at step 6 of 12 (its
    schedule's horizon 12) and resumed trains on the unbroken run's
    batches from the restored state, so its losses are the unbroken run's
    bit for bit."""
    kw = dict(smoke=True, global_batch=4, seq_len=32, peak_lr=5e-3,
              log_every=1, device="cpu")
    killed = train("glm4-9b", steps=6, total_steps=12, ckpt_every=6,
                   ckpt_dir=str(tmp_path / "a"), **kw)
    resumed = train("glm4-9b", steps=12, ckpt_dir=str(tmp_path / "a"), **kw)
    whole = train("glm4-9b", steps=12, ckpt_dir=str(tmp_path / "b"),
                  ckpt_every=100, **kw)
    assert resumed["start_step"] == 6 and resumed["steps"] == 6
    assert killed["losses"] == whole["losses"][:6]
    assert resumed["losses"] == whole["losses"][6:]


def test_moe_dispatch_and_combine_pass_gradcheck():
    """The MoE block's gradient (routing, the slot gather, the expert
    products, the weighted combine) against finite differences.  The
    router runs in float32 by design, so the check is in float32:
    eps 1e-2 and 1e-2 tolerances (float32 differences of a step 1e-2 keep
    about 5 digits; the routing does not flip at these inputs)."""
    moe = dataclasses.replace(get_smoke_config("deepseek-moe-16b").moe,
                              n_experts=4, top_k=2, d_expert=3,
                              capacity_factor=1.0)
    g = torch.Generator().manual_seed(0)
    d, t = 5, 6
    shapes = ((t, d), (d, 4), (4, d, 3), (4, d, 3), (4, 3, d))
    ins = [torch.randn(sh, generator=g).requires_grad_() for sh in shapes]

    def f(x, rw, gate, up, down):
        p = {"router": {"w": rw}, "gate": gate, "up": up, "down": down}
        out, aux, counts = moe_block_local(p, x, moe, n_shards=1,
                                           shard_ix=0, tp_axis=None)
        return out, aux

    # capacity 4 for 12 pairs on 4 experts: pairs are dropped, too
    assert torch.autograd.gradcheck(f, ins, eps=1e-2, atol=1e-2, rtol=1e-2)


def test_one_device_limits_raise():
    """Meshes are ported (``tests/test_torch_mesh.py``); what one process
    cannot do still raises: the production mesh needs a world of 256
    (512 multi-pod) processes.  Without a mesh ``fsdp`` changes
    nothing."""
    cfg = get_smoke_config("glm4-9b")
    plan = plan_cell(cfg, _train_shape(), fsdp=True, device="cpu")
    assert plan.mesh is None and plan.ctx is None and not plan.shardings
    for multi_pod in (False, True):
        with pytest.raises((RuntimeError, ValueError), match="256|512"):
            train("glm4-9b", steps=1, production_mesh=True,
                  multi_pod=multi_pod, device="cpu")


def test_prefill_and_decode_kinds():
    cfg = get_smoke_config("gemma3-1b")
    params = init_params(cfg, 0, device="cpu")
    toks = np.arange(8, dtype=np.int32)[None] % cfg.vocab_size
    pre = plan_cell(cfg, ShapeSpec("p", 8, 1, "prefill"), device="cpu")
    logits, cache = pre.step(params, {"tokens": toks})
    assert logits.shape == (1, cfg.vocab_size)
    from repro_torch.models import init_cache, prefill
    want, _ = prefill(cfg, params, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(logits, want)
    dec = plan_cell(cfg, ShapeSpec("d", 16, 1, "decode"), device="cpu")
    arena = init_cache(cfg, 1, 16, device="cpu")
    step_logits, _ = dec.step(params, arena, {"tokens": toks[:, :1]},
                              np.array([0]))
    assert step_logits.shape == (1, cfg.vocab_size)


def test_train_lm_and_serve_lm_twins():
    from repro_torch.examples import serve_lm, train_lm
    out = train_lm.main("cpu", steps=3, batch=2, seq=16, log_every=1)
    assert out["steps"] == 3 and np.isfinite(out["final_loss"])
    assert train_lm.make_100m().name == "gemma3-100m"
    from repro_torch import configs
    assert "gemma3-100m" not in configs._MODULES     # unregistered after
    rep = serve_lm.main("cpu", n_requests=4, max_seq=64)
    assert rep["static"]["requests"] == rep["adaptive"]["requests"] == 4
