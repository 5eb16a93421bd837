"""The port's checkpoints and elastic restart against the reference package.

Twins of the first six tests of ``tests/test_checkpoint_elastic.py`` (the
seventh, speculation, is twinned in ``tests/test_torch_pools.py``) on the
port's ``checkpoint`` and ``runtime.elastic``; then checkpoints crossing
packages in both directions, bit for bit: a smoke model's parameters and
AdamW state, in the training driver's layout (``{"params", "opt"}``, the
reference's stacked leaves and names, bf16 as tagged ``uint16``), written
by one package and restored by the other; and the port's ``train``
resuming from a checkpoint the reference wrote.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_pytree as jax_restore
from repro.checkpoint import save_pytree as jax_save
from repro.configs import get_smoke_config as jax_smoke
from repro.models import init_params as jax_init
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import init_opt_state as jax_init_opt_state
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_pytree, save_pytree)
from repro_torch.configs import get_smoke_config
from repro_torch.convert import BF16Bits, params_from_jax
from repro_torch.launch.train import checkpoint_tree, restore_state, train
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig, init_opt_state, tree_leaves
from repro_torch.runtime import (ElasticRunner, FailureInjector,
                                 rescale_batch_schedule, reshard_tree)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    return {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "stats": {"b16": torch.ones((5,), dtype=torch.bfloat16) * 1.5,
                  "step": torch.tensor(7, dtype=torch.int32)},
    }


# -- twins of tests/test_checkpoint_elastic.py --------------------------------

def test_roundtrip_exact(tmp_path):
    tree = _tree()
    d = str(tmp_path / "ck")
    save_pytree(tree, d)
    got = restore_pytree(tree, d)
    for a, b in zip(tree_leaves(tree), tree_leaves(got)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_restore_rejects_shape_mismatch(tmp_path):
    d = str(tmp_path / "ck")
    save_pytree({"w": torch.zeros((2, 2))}, d)
    with pytest.raises(ValueError):
        restore_pytree({"w": torch.zeros((3, 2))}, d)
    with pytest.raises(KeyError):
        restore_pytree({"v": torch.zeros((2, 2))}, d)


def test_manager_retention_and_latest(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (10, 20, 30):
        m.save(s, {"w": torch.full((2,), float(s))})
    assert latest_step(str(tmp_path)) == 30
    assert sorted(os.listdir(tmp_path)) == ["step_20", "step_30"]
    step, tree = m.restore_latest({"w": torch.zeros((2,))})
    assert step == 30
    assert float(tree["w"][0]) == 30.0


def test_async_save_then_restore(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    w = torch.ones((4,))
    m.save(1, {"w": w})
    w.fill_(5.0)            # the snapshot was taken before save returned
    m.wait()
    step, tree = m.restore_latest({"w": torch.zeros((4,))})
    assert step == 1 and torch.equal(tree["w"], torch.ones(4))


def test_elastic_runner_failure_recovery(tmp_path):
    """Lose 'devices' mid-run; the final state equals the unbroken run's
    (restart from checkpoint + deterministic data replay)."""
    batches = [np.float32(i + 1) for i in range(40)]
    kw = dict(make_mesh=lambda n_data: n_data,
              make_state=lambda mesh: torch.tensor(0.0),
              make_step=lambda mesh: (lambda s, b: s + b),
              data_shards=4, checkpoint_every=5)
    baseline = ElasticRunner(
        **kw, manager=CheckpointManager(str(tmp_path / "a"), keep=2,
                                        async_save=False)).run(batches, 20)
    failing = ElasticRunner(
        **kw, injector=FailureInjector({12: 1, 17: 1}),
        manager=CheckpointManager(str(tmp_path / "b"), keep=2,
                                  async_save=False))
    out = failing.run(batches, 20)
    assert float(out) == float(baseline) == sum(range(1, 21))
    assert len(failing.events) == 2
    assert failing.events[0]["n_data"] == 3
    assert failing.events[1]["n_data"] == 2
    assert [e["resume_from"] for e in failing.events] == [10, 15]


def test_rescale_batch_schedule():
    assert rescale_batch_schedule(256, 16) == 16
    assert rescale_batch_schedule(256, 8) == 32
    with pytest.raises(ValueError):
        rescale_batch_schedule(256, 7)


def test_reshard_tree_moves_to_one_device():
    tree = {"a": np.arange(3, dtype=np.int32), "b": [torch.ones(2)]}
    got = reshard_tree(tree, "cpu")
    assert isinstance(got["a"], torch.Tensor) and got["a"].dtype == \
        torch.int32
    assert got["b"][0].device.type == "cpu"


# -- across packages ---------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_state(arch, dtype="bfloat16", seed=0):
    """A reference model's parameters and AdamW state (moments that are not
    zero, a step that is not 0); shared by the tests, which copy it."""
    cfg = dataclasses.replace(jax_smoke(arch), dtype=dtype)
    params = jax.jit(jax_init, static_argnums=0)(cfg,
                                                jax.random.PRNGKey(seed))
    opt = jax_init_opt_state(params, JaxAdamWConfig())
    rng = np.random.default_rng(seed)
    # moments that are not zero, and a step that is not 0
    opt = {"m": jax.tree.map(lambda a: jnp.asarray(
               rng.standard_normal(a.shape), a.dtype), opt["m"]),
           "v": jax.tree.map(lambda a: jnp.asarray(
               rng.random(a.shape), a.dtype), opt["v"]),
           "step": jnp.int32(5)}
    return cfg, {"params": params, "opt": opt}


def _names(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)["leaves"]


@pytest.mark.parametrize("arch", ["gemma3-1b", "deepseek-v3-671b"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, arch):
    cfg, state = _jax_state(arch)
    d = str(tmp_path / "step_5")
    jax_save(state, d)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    params = init_params(tcfg, 1, device="cpu")
    opt = init_opt_state(params, AdamWConfig())
    m = CheckpointManager(str(tmp_path))
    step, tparams, topt = restore_state(tcfg, m, params, opt,
                                        torch.device("cpu"))
    assert step == 5
    # back to the reference's layout: every leaf's bits equal
    back = checkpoint_tree(tcfg, tparams, topt)
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(state)[0],
            jax.tree.leaves(back)):
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            assert isinstance(got, BF16Bits), path
            got = got.view(np.ndarray).view(want.dtype)
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want)
    assert tparams["stage0"][0]["block0"]["norm1"]["scale"].dtype == \
        torch.float32
    assert topt["step"].dtype == torch.int32 and int(topt["step"]) == 5


@pytest.mark.parametrize("arch", ["gemma3-1b", "deepseek-v3-671b"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, arch):
    cfg, state = _jax_state(arch)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="bfloat16")
    np_state = jax.tree.map(np.asarray, state)
    tparams = params_from_jax(tcfg, np_state["params"], device="cpu")
    from repro_torch.convert import opt_state_from_jax
    topt = opt_state_from_jax(tcfg, np_state["opt"], device="cpu")
    d = str(tmp_path / "ck")
    save_pytree(checkpoint_tree(tcfg, tparams, topt), d)
    jd = str(tmp_path / "jck")
    jax_save(state, jd)
    # the same leaf names, shapes and dtype tags as the reference writes
    mine, ref = _names(d), _names(jd)
    assert mine.keys() == ref.keys()
    for k in ref:
        assert (mine[k]["shape"], mine[k]["dtype"]) == \
            (ref[k]["shape"], ref[k]["dtype"]), k
    got = jax_restore(state, d)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(state)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_port_train_resumes_from_a_reference_checkpoint(tmp_path):
    """The reference's state at step 2 in the training layout; the port's
    ``train`` picks it up and runs the remaining steps only."""
    cfg, state = _jax_state("glm4-9b", dtype="float32")
    state = {"params": state["params"],
             "opt": {**state["opt"], "step": jnp.int32(2)}}
    jax_save(state, str(tmp_path / "step_2"))
    out = train("glm4-9b", steps=4, global_batch=2, seq_len=16,
                ckpt_dir=str(tmp_path), ckpt_every=100, log_every=1,
                device="cpu")
    assert out["start_step"] == 2 and out["steps"] == 2
    assert [s for s, _ in out["losses"]] == [2, 3]
    assert all(np.isfinite(l) for _, l in out["losses"])
