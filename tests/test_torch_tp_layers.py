"""Each layer kind that the model axis splits by heads or channels, alone,
on a mesh of the port against its meshless path (gloo on the CPU).

A model of one block (the smoke config's mixer, no FFN) runs its train,
prefill and decode steps over a mesh whose model axis is 2 (a 2 x 2 world:
data 2, model 2) or 4 (1 x 4), with FSDP forced on every leaf of 64
elements or more, against the same steps without a mesh (the oracle the
other tests hold to the JAX package).  The cases:

* GQA attention with the query heads split and the KV heads whole
  (glm4-9b's smoke, 4 heads on 2 KV heads, at 4: one query head a rank,
  two ranks on each KV head, ``wk``/``wv`` whole leaves cut to it);
* Mamba (jamba's smoke, ``d_inner`` 64, at 2 and 4: ``in_proj``'s x and z
  column blocks lie on different ranks);
* RWKV-6's time mix (rwkv6-1.6b's smoke, 2 heads, at 2: one a rank);
* MLA (deepseek-v3's smoke, 4 heads, at 2 and 4).

Each is held within 1e-5 of the largest meshless value on the loss and
gradient norm of two steps, the first step's gradients, the parameters
after two steps, the prefill logits and its whole cache, and decode at S
against prefill(S + 1).  After the two steps every leaf the model axis
does not split is bit-equal across the axis's ranks (a gradient summed
once too few or too many times over the axis shows there, and in the
global norm).  The mixer must not be computed replicated in training or
prefill (``replication_tally``); Mamba's and RWKV-6's decode is.
"""
import dataclasses
import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_mesh import _grads_rel, _leaves, _padded, _rel

#: (pods, data, model) of each world, and the layer kinds it runs
WORLDS = {"2x2": ((1, 2, 2), ("mamba", "rwkv6", "mla")),
          "1x4": ((1, 1, 4), ("attn", "mamba", "mla"))}
#: the smoke config each layer kind is cut from
ARCH_OF = {"attn": "glm4-9b", "mamba": "jamba-v0.1-52b",
           "rwkv6": "rwkv6-1.6b", "mla": "deepseek-v3-671b"}
#: the kinds whose decode stays replicated over the model axis
DECODE_REPLICATED = ("mamba", "rwkv6")
TOL = 1e-5
B, S = 2, 16
JOIN_TIMEOUT_S = 240


def _cfg(kind: str):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import BlockSpec, Stage
    return dataclasses.replace(
        get_smoke_config(ARCH_OF[kind]), dtype="float32", mtp_depth=0,
        moe=None, stages=(Stage(1, (BlockSpec(kind, "none"),)),))


def _whole_leaves_equal(params, specs, ctx) -> list:
    """The leaves the model axis does not split that differ between its
    ranks (compared bit for bit)."""
    import torch.distributed as dist
    from repro_torch.runtime.sharding import spec_axes
    specs = dict(_leaves(specs))
    bad = []
    for name, t in _leaves(params):
        if any(ctx.tp_axis in spec_axes(e) for e in specs[name]):
            continue
        t = t.detach().contiguous()
        got = [torch.empty_like(t) for _ in range(ctx.tp_size)]
        dist.all_gather(got, t, group=ctx.tp_group)
        if not all(torch.equal(g, got[0]) for g in got):
            bad.append(name)
    return bad


def _layer_checks(mesh, kind: str) -> dict:
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import plan_cell
    from repro_torch.models import init_params
    from repro_torch.models.transformer import replication_tally
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.runtime.sharding import gather_full
    cfg = _cfg(kind)
    opt_cfg = AdamWConfig(total_steps=4, warmup_steps=1)
    shape = ShapeSpec("t", S, B, "train")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B))
    plan = plan_cell(cfg, shape, mesh, opt_cfg=opt_cfg)
    one = plan_cell(cfg, shape, opt_cfg=opt_cfg, device="cpu")
    p1 = init_params(cfg, 0, device="cpu", ctx=plan.ctx)
    o1 = init_opt_state(p1, opt_cfg)
    p0 = init_params(cfg, 0, device="cpu")
    o0 = init_opt_state(p0, opt_cfg)
    out = {"loss": 0.0, "grad_norm": 0.0,
           "grads": _grads_rel(cfg, plan, p1, p0, data.batch(0), mesh)}
    with replication_tally() as tally:
        for s in range(2):
            _, _, m1 = plan.step(p1, o1, data.batch(s))
            _, _, m0 = one.step(p0, o0, data.batch(s))
            for k in ("loss", "grad_norm"):
                out[k] = max(out[k], _rel(m1[k], m0[k]))
    out["train_replicated"] = tally[kind]
    specs = dict(_leaves(plan.ctx.param_specs))
    want = dict(_leaves(p0))
    top = max(float(t.detach().abs().max()) for t in want.values())
    out["params"] = max(
        float((gather_full(t, specs[name], mesh) - want[name].detach())
              .abs().max()) for name, t in _leaves(p1)) / top
    out["whole_leaves_differing"] = _whole_leaves_equal(
        p1, plan.ctx.param_specs, plan.ctx)

    # prefill (logits and the whole cache), and decode at S against
    # prefill(S + 1)
    toks = torch.from_numpy(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S + 1,
        global_batch=B)).batch(7)["tokens"].astype(np.int64))
    pre = plan_cell(cfg, ShapeSpec("p", S, B, "prefill"), mesh)
    dec = plan_cell(cfg, ShapeSpec("d", S + 1, B, "decode"), mesh)
    pre0 = plan_cell(cfg, ShapeSpec("p", S, B, "prefill"), device="cpu")
    params0 = init_params(cfg, 0, device="cpu")
    params1 = init_params(cfg, 0, device="cpu", ctx=pre.ctx)
    with replication_tally() as tally:
        lg1, cache1 = pre.step(params1, {"tokens": toks[:, :S]})
    out["prefill_replicated"] = tally[kind]
    lg0, cache0 = pre0.step(params0, {"tokens": toks[:, :S]})
    out["prefill"] = _rel(lg1, lg0)
    cspecs = dict(_leaves(pre.ctx.cache_specs))
    whole = dict(_leaves(cache0))
    out["cache"] = max(_rel(gather_full(t, cspecs[name], mesh), whole[name])
                       for name, t in _leaves(cache1))
    with replication_tally() as tally:
        lg1d, _ = dec.step(params1, _padded(cache1, 1),
                           {"tokens": toks[:, S:S + 1]},
                           torch.full((B,), S, dtype=torch.int64))
    out["decode_replicated"] = tally[kind]
    lg0n, _ = pre0.step(params0, {"tokens": toks})
    out["decode"] = _rel(lg1d, lg0n)
    return out


def _world_main(rank: int, world: int, layout: tuple, root: str,
                kinds: tuple) -> None:
    import warnings
    import torch.distributed as dist
    import repro_torch.launch.steps as steps
    from repro_torch.launch.mesh import make_host_mesh
    warnings.filterwarnings("ignore", category=FutureWarning)
    torch.set_num_threads(1)
    root = Path(root)
    tag = "x".join(map(str, layout))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(root / f"store_{tag}"), world), rank=rank, world_size=world)
    make = steps._mk_policy

    def small_fsdp(mesh, *, fsdp=True):
        policy = make(mesh, fsdp=fsdp)
        policy.fsdp_min_size = 64
        return policy
    steps._mk_policy = small_fsdp
    pods, data, model = layout
    mesh = make_host_mesh(data, model, pods=pods, device="cpu")
    res = {}
    try:
        res["layers"] = {k: _layer_checks(mesh, k) for k in kinds}
    except BaseException as e:
        res["error"] = f"rank {rank}: {type(e).__name__}: {e}"
        raise
    finally:
        if rank == 0 or "error" in res:
            (root / f"result_{tag}_{rank}.json").write_text(json.dumps(res))
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world spawned at once, each with a join timeout (a hung
    collective fails the tests, it does not hang the suite)."""
    import torch.multiprocessing as mp
    root = tmp_path_factory.mktemp("tp_layers")
    started = {name: mp.start_processes(
        _world_main, args=(math.prod(layout), layout, str(root), kinds),
        nprocs=math.prod(layout), join=False, start_method="spawn")
        for name, (layout, kinds) in WORLDS.items()}
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    out = {}
    for name, ctx in started.items():
        tag = "x".join(map(str, WORLDS[name][0]))
        error = None
        try:
            while not ctx.join(timeout=max(0.1,
                                           deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    error = f"world {tag} did not finish in {JOIN_TIMEOUT_S} s"
                    break
        except Exception as e:       # a process failed
            error = f"world {tag}: {e}"
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        got = {}
        for f in sorted(root.glob(f"result_{tag}_*.json")):
            rec = json.loads(f.read_text())
            error = error or rec.get("error")
            if f.name.endswith("_0.json"):
                got = rec
        if error:
            got["error"] = error
        out[name] = got
    return out


_CASES = [(w, k) for w, (_, kinds) in WORLDS.items() for k in kinds]


def _layer(worlds, world: str, kind: str) -> dict:
    got = worlds[world]
    assert "error" not in got, got["error"]
    return got["layers"][kind]


@pytest.mark.parametrize("world,kind", _CASES)
def test_train_steps_match_meshless(worlds, world, kind):
    got = _layer(worlds, world, kind)
    for k in ("loss", "grad_norm", "grads", "params"):
        assert got[k] <= TOL, (k, got)


@pytest.mark.parametrize("world,kind", _CASES)
def test_whole_leaves_bit_equal_over_the_model_axis(worlds, world, kind):
    got = _layer(worlds, world, kind)
    assert got["whole_leaves_differing"] == [], got


@pytest.mark.parametrize("world,kind", _CASES)
def test_prefill_cache_and_decode_match_meshless(worlds, world, kind):
    got = _layer(worlds, world, kind)
    for k in ("prefill", "cache", "decode"):
        assert got[k] <= TOL, (k, got)


@pytest.mark.parametrize("world,kind", _CASES)
def test_layer_runs_split_over_the_model_axis(worlds, world, kind):
    """Training and prefill compute only the rank's heads or channels;
    decode of the recurrent layers stays replicated."""
    got = _layer(worlds, world, kind)
    assert got["train_replicated"] == 0 and got["prefill_replicated"] == 0
    assert (got["decode_replicated"] > 0) == (kind in DECODE_REPLICATED)
