"""The port's mesh path over ``torch.distributed``, against its own
meshless path, in worlds of 2 and 4 processes on the CPU (gloo).

The reference's sharded steps cannot serve as the oracle here: its
``plan_cell(..., mesh)`` fails at the vocab-sharded embedding gather for
``prefill`` and ``train`` on any mesh (the seed's failing
``test_training_loss_decreases_with_restart``).  So the port's sharded
train, prefill and decode steps are held to its meshless steps, which the
other tests hold to the JAX package.

Each world (1 x 2, 2 x 1, 2 x 2 and 2 x 1 x 2 with a "pod" axis) is
spawned once for the module (2 x 2 first, which writes the checkpoint the
others read, then the other three at once), its processes meeting at a
``FileStore``
under the module's temporary directory, with a join timeout (a hung
collective fails the tests, it does not hang the suite); each process
runs every check and rank 0 writes what it found, which the test cases
read.  The checks run float32 smoke configs: glm4-9b (4 heads on 2 KV
heads: a model axis of 2 splits every projection by heads), gemma3-1b (2
heads on 1 KV head: one query head a rank, both on the one KV head, whose
projections stay whole), deepseek-moe-16b (8 experts, one shared; also with
``moe_a2a`` and ``seq_shard_acts`` on: all-to-all dispatch, and the
residual split over the sequence), deepseek-v3-671b (MLA, 4 heads split
by heads, the latent path whole on every rank; MoE; the MTP head in the
loss), jamba's smoke period (Mamba split by channels, ``in_proj``'s x and
z columns gathered and cut; MoE and attention) and rwkv6-1.6b (the time
mix split by heads at 2, one a rank; the channel mix replicated, as the
rules leave its leaves whole).  Mamba's and RWKV-6's decode runs
replicated, on the whole cache (``test_torch_tp_layers.py`` runs each
split layer kind alone, at model axes of 2 and 4).  FSDP is forced on
every leaf of 64 elements or more, so the smoke leaves are data-sharded
too.  The MoE configs run at a capacity factor of ``n_experts`` (no pair
drops, so the per-shard capacity changes nothing) and with ``router_aux_weight`` 0: on a
mesh the aux loss is the mean of each shard's Switch loss (the reference's
``pmean`` over the shards that route, dp or, under all-to-all, sequence),
which is not the whole batch's, so it is held to the reference's
``moe_apply`` in ``test_torch_moe_mesh.py`` instead.  Tolerance: 1e-5 of
the largest value of the meshless result (loss, grad norm, the first step's
gradients, every parameter after two steps, each against the largest
gradient or parameter, prefill logits, and decode at position S against
prefill(S + 1); glm4-9b's also at batch 1, whose KV caches the rules
split over the sequence where the dp axes do not divide the batch).
A checkpoint saved under 2 x 2 is restored in 1 x 2 with ``shardings=``,
and restored in the JAX package without a mesh; a checkpoint the JAX
package saved is restored in 1 x 2: each bit for bit.
"""
import dataclasses
import json
import math
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

WORLDS = {"1x2": (1, 1, 2), "2x1": (1, 2, 1), "2x2": (1, 2, 2),
          "2x1x2": (2, 1, 2)}      # (pods, data, model)
ARCHS = ("glm4-9b", "gemma3-1b", "deepseek-moe-16b",
         "deepseek-moe-16b+a2a+sp", "deepseek-v3-671b", "jamba-v0.1-52b",
         "rwkv6-1.6b")
#: the perf flags an arch's suffix turns on
FLAGS_OF = {"a2a": "moe_a2a", "sp": "seq_shard_acts"}
TOL = 1e-5
B, S = 2, 16
JOIN_TIMEOUT_S = 240


# -- what every process of a world runs --------------------------------------

def _cfg(arch: str):
    from repro_torch.configs import get_smoke_config
    cfg = dataclasses.replace(get_smoke_config(arch.split("+")[0]),
                              dtype="float32")
    if cfg.moe is not None:     # no pair is ever dropped; no aux in the loss
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts),
            router_aux_weight=0.0))
    return cfg


def _rel(got, want) -> float:
    got, want = (torch.as_tensor(x).detach().double() for x in (got, want))
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _padded(cache, extra: int):
    """The prefill cache with room for ``extra`` more positions."""
    def pad(path, t):
        if path.rsplit("/", 1)[-1] in ("k", "v", "c_kv", "k_pe"):
            return torch.cat([t, t.new_zeros((t.shape[0], extra)
                                              + t.shape[2:])], dim=1)
        return t.clone()

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path) for v in tree]
        return pad(path, tree)
    return walk(cache)


def _grads_rel(cfg, plan, p1, p0, batch, mesh) -> float:
    """The first step's gradients, this rank's blocks reduced as the step
    reduces them and gathered whole, against the meshless ones: the
    largest difference over the largest meshless gradient."""
    from repro_torch.launch.steps import _mesh_grads, batch_to
    from repro_torch.models import loss_fn
    from repro_torch.optim import tree_leaves
    from repro_torch.runtime.sharding import gather_full
    got, want = [], []
    for params, ctx, out in ((p1, plan.ctx, got), (p0, None, want)):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            for t in leaves:
                t.requires_grad_(True)
            loss, _ = loss_fn(cfg, params, batch_to(batch, "cpu"), ctx=ctx)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out.extend(g if g is not None else torch.zeros_like(t)
                   for g, t in zip(grads, leaves))
    specs = tree_leaves(plan.ctx.param_specs)
    _mesh_grads(got, specs, plan.ctx)
    got = [gather_full(g, s, mesh) for g, s in zip(got, specs)]
    top = max(float(g.abs().max()) for g in want)
    return max(float((a - b).abs().max()) for a, b in zip(got, want)) / top


def _model_checks(mesh, arch: str) -> dict:
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.steps import plan_cell
    from repro_torch.models import init_params
    from repro_torch.models.flags import reset_flags, set_flags
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.runtime.sharding import gather_full
    cfg = _cfg(arch)
    set_flags(**{FLAGS_OF[f]: True for f in arch.split("+")[1:]})
    try:
        out = {}
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
        rel = {"loss": 0.0, "grad_norm": 0.0,
               "grads": _grads_rel(cfg, plan, p1, p0, data.batch(0), mesh)}
        for s in range(2):
            _, _, m1 = plan.step(p1, o1, data.batch(s))
            _, _, m0 = one.step(p0, o0, data.batch(s))
            for k in ("loss", "grad_norm"):
                rel[k] = max(rel[k], _rel(m1[k], m0[k]))
        specs = dict(_leaves(plan.ctx.param_specs))
        want = dict(_leaves(p0))
        top = max(float(t.detach().abs().max()) for t in want.values())
        rel["params"] = max(
            float((gather_full(t, specs[name], mesh) - want[name].detach())
                  .abs().max()) for name, t in _leaves(p1)) / top
        out["train"] = rel

        # prefill, and decode at S against prefill(S + 1)
        toks = torch.from_numpy(SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=S + 1,
            global_batch=B)).batch(7)["tokens"].astype(np.int64))
        pre = plan_cell(cfg, ShapeSpec("p", S, B, "prefill"), mesh)
        dec = plan_cell(cfg, ShapeSpec("d", S + 1, B, "decode"), mesh)
        pre0 = plan_cell(cfg, ShapeSpec("p", S, B, "prefill"), device="cpu")
        params0 = init_params(cfg, 0, device="cpu")
        params1 = init_params(cfg, 0, device="cpu", ctx=pre.ctx)
        lg1, cache1 = pre.step(params1, {"tokens": toks[:, :S]})
        lg0, _ = pre0.step(params0, {"tokens": toks[:, :S]})
        out["prefill"] = _rel(lg1, lg0)
        lg1d, _ = dec.step(params1, _padded(cache1, 1),
                           {"tokens": toks[:, S:S + 1]},
                           torch.full((B,), S, dtype=torch.int64))
        lg0n, _ = pre0.step(params0, {"tokens": toks})
        out["decode"] = _rel(lg1d, lg0n)
        if arch == "glm4-9b":
            out["decode_b1"] = _decode_batch_1(cfg, mesh, toks[:1], params0)
        return out
    finally:
        reset_flags()


def _decode_batch_1(cfg, mesh, toks, params0) -> float:
    """Batch 1, which the dp axes do not divide: every dp rank runs the
    whole batch and the KV caches are split over the sequence instead
    (``cache_specs``' rule); decode at S against prefill(S + 1).  The
    prefill's cache (S over dp) is re-cut for the decode's (S + 2 over
    dp) through the whole tensor."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.steps import plan_cell
    from repro_torch.models import init_params
    from repro_torch.runtime.sharding import gather_full, shard_local
    pre = plan_cell(cfg, ShapeSpec("p", S, 1, "prefill"), mesh)
    dec = plan_cell(cfg, ShapeSpec("d", S + 2, 1, "decode"), mesh)
    params = init_params(cfg, 0, device="cpu", ctx=pre.ctx)
    _, cache = pre.step(params, {"tokens": toks[:, :S]})
    pre_specs = dict(_leaves(pre.ctx.cache_specs))
    dec_specs = dict(_leaves(dec.ctx.cache_specs))
    whole = _padded({name: gather_full(t, pre_specs[name], mesh)
                     for name, t in _leaves(cache)}, 2)
    arena = _tree_like(cache, {name: shard_local(t, dec_specs[name],
                                                 mesh).clone()
                               for name, t in whole.items()})
    lg, _ = dec.step(params, arena, {"tokens": toks[:, S:S + 1]},
                     torch.full((1,), S, dtype=torch.int64))
    one = plan_cell(cfg, ShapeSpec("p", S + 1, 1, "prefill"), device="cpu")
    want, _ = one.step(params0, {"tokens": toks})
    return _rel(lg, want)


def _tree_like(tree, flat: dict, prefix=""):
    if isinstance(tree, dict):
        return {k: _tree_like(v, flat, f"{prefix}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_like(v, flat, f"{prefix}/{i}")
                for i, v in enumerate(tree)]
    return flat[prefix]


def _ckpt_save(mesh, root: Path) -> dict:
    """glm4-9b trained 2 steps under the mesh, checkpointed at step 2; the
    checkpoint read back without a mesh equals the live state gathered
    (on rank 0; the others hold none of it)."""
    from repro_torch.checkpoint import restore_pytree
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.convert import _tensor
    from repro_torch.launch.steps import plan_cell
    from repro_torch.launch.train import checkpoint_tree, train
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    from repro_torch.data import DataConfig, SyntheticLM
    train("glm4-9b", steps=2, global_batch=B, seq_len=S, mesh=mesh,
          ckpt_dir=str(root / "ckpt"), ckpt_every=2, log_every=1)
    # the same two steps once more, gathered whole, against the file
    cfg = get_smoke_config("glm4-9b")
    opt_cfg = AdamWConfig(total_steps=2, warmup_steps=1)
    plan = plan_cell(cfg, ShapeSpec("custom", S, B, "train"), mesh,
                     opt_cfg=opt_cfg)
    params = init_params(cfg, 0, device="cpu", ctx=plan.ctx)
    opt = init_opt_state(params, opt_cfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                  global_batch=B))
    for s in range(2):
        plan.step(params, opt, data.batch(s))
    live = checkpoint_tree(cfg, params, opt, plan.ctx)
    import torch.distributed as dist
    dist.barrier()
    if dist.get_rank() != 0:        # only rank 0 holds the whole arrays
        if live is not None:
            raise AssertionError("a rank other than 0 holds the whole tree")
        return {}
    read = restore_pytree(live, str(root / "ckpt" / "step_2"), device="cpu")
    cpu = torch.device("cpu")
    mismatched = [n for (n, a), (_, b) in zip(_leaves(live), _leaves(read))
                  if not torch.equal(_tensor(a, cpu), b)]
    return {"saved_whole_equal": not mismatched, "mismatched": mismatched[:5]}


def _ckpt_restore(mesh, root: Path) -> dict:
    """The 2 x 2 run's checkpoint (through the train loop's resume) and
    the JAX package's, restored here with ``shardings=``: each rank's
    blocks equal the blocks of the whole arrays read without a mesh."""
    from repro_torch.checkpoint import CheckpointManager, restore_pytree
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.convert import params_from_jax
    from repro_torch.launch.specs import abstract_params
    from repro_torch.launch.steps import plan_cell
    from repro_torch.launch.train import restore_state
    from repro_torch.runtime.sharding import named, shard_local, stack_specs
    cfg = get_smoke_config("glm4-9b")
    plan = plan_cell(cfg, ShapeSpec("custom", S, B, "train"), mesh)
    step, params, _ = restore_state(cfg, CheckpointManager(
        str(root / "ckpt")), None, None, torch.device("cpu"), plan.ctx)
    target = {"params": {k: (_stacked_meta(v) if isinstance(v, list)
                             else _map_meta(v))
                         for k, v in abstract_params(cfg).items()}}
    whole = restore_pytree(target, str(root / "ckpt" / "step_2"),
                           device="cpu")
    want = dict(_leaves(params_from_jax(cfg, whole["params"],
                                        device="cpu")))
    specs = dict(_leaves(plan.ctx.param_specs))
    out = {"restored_step": step, "sharded_equal": all(
        torch.equal(t, shard_local(want[n], specs[n], mesh))
        for n, t in _leaves(params))}
    # the JAX package's checkpoint of the same tree's shapes
    jax_dir = str(root / "jax_ckpt")
    sspecs = stack_specs(plan.ctx.param_specs)
    sharded = restore_pytree(target, jax_dir, shardings={
        "params": named(mesh, sspecs)}, device="cpu")
    whole = dict(_leaves(restore_pytree(target, jax_dir,
                                        device="cpu")["params"]))
    flat_specs = dict(_leaves(sspecs))
    out["jax_sharded_equal"] = all(
        torch.equal(t, shard_local(whole[n], flat_specs[n], mesh))
        for n, t in _leaves(sharded["params"]))
    return out


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _map_meta(tree):
    if isinstance(tree, dict):
        return {k: _map_meta(v) for k, v in tree.items()}
    return _meta(tree)


def _stacked_meta(periods: list):
    first = periods[0]
    if isinstance(first, dict):
        return {k: _stacked_meta([p[k] for p in periods]) for k in first}
    return torch.empty((len(periods),) + tuple(first.shape),
                       dtype=first.dtype, device="meta")


def _world_main(rank: int, world: int, layout: tuple, root: str,
                jobs: tuple) -> None:
    import torch.distributed as dist
    import repro_torch.launch.steps as steps
    from repro_torch.launch.mesh import make_host_mesh
    import warnings
    warnings.filterwarnings("ignore", category=FutureWarning)
    torch.set_num_threads(1)
    root = Path(root)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(root / f"store_{'x'.join(map(str, layout))}"), world),
        rank=rank, world_size=world)
    make = steps._mk_policy

    def small_fsdp(mesh, *, fsdp=True):
        policy = make(mesh, fsdp=fsdp)
        policy.fsdp_min_size = 64
        return policy
    steps._mk_policy = small_fsdp
    pods, data, model = layout
    mesh = make_host_mesh(data, model, pods=pods, device="cpu")
    res = {}
    t0 = time.monotonic()
    try:
        for job in jobs:
            if job == "models":
                res["models"] = {a: _model_checks(mesh, a) for a in ARCHS}
            elif job == "ckpt_save":
                res["ckpt_save"] = _ckpt_save(mesh, root)
            elif job == "ckpt_restore":
                res["ckpt_restore"] = _ckpt_restore(mesh, root)
    except BaseException as e:
        res["error"] = f"rank {rank}: {type(e).__name__}: {e}"
        raise
    finally:
        res["seconds"] = time.monotonic() - t0
        if rank == 0 or "error" in res:
            name = f"result_{'x'.join(map(str, layout))}_{rank}.json"
            (root / name).write_text(json.dumps(res))
        dist.destroy_process_group()


# -- the parent: spawn each world once ----------------------------------------

def _spawn(root: Path, worlds: dict) -> dict:
    """Start every world of ``{name: (layout, jobs)}`` at once; -> {name:
    rank 0's findings, or an "error"}."""
    import torch.multiprocessing as mp
    started = {name: mp.start_processes(
        _world_main, args=(math.prod(layout), layout, str(root), jobs),
        nprocs=math.prod(layout), join=False, start_method="spawn")
        for name, (layout, jobs) in worlds.items()}
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    out = {}
    for name, ctx in started.items():
        layout = worlds[name][0]
        error = None
        try:
            while not ctx.join(timeout=max(0.1,
                                           deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    error = (f"world {layout} did not finish in "
                             f"{JOIN_TIMEOUT_S} s")
                    break
        except Exception as e:       # a process failed
            error = f"world {layout}: {e}"
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        tag = "x".join(map(str, layout))
        got = {}
        for f in sorted(root.glob(f"result_{tag}_*.json")):
            rec = json.loads(f.read_text())
            if "error" in rec:
                error = error or rec["error"]
            if f.name.endswith("_0.json"):
                got = rec
        if error:
            got["error"] = error
        out[name] = got
    return out


def _jax_checkpoint(root: Path) -> None:
    """glm4-9b's smoke weights saved by the JAX package (float32 copies)."""
    from repro.checkpoint.manager import save_pytree
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import params_to_jax
    from repro_torch.models import init_params
    cfg = get_smoke_config("glm4-9b")
    tree = params_to_jax(cfg, init_params(cfg, 3, device="cpu"))

    def f32(t):
        if isinstance(t, dict):
            return {k: f32(v) for k, v in t.items()}
        a = np.asarray(t)
        if a.dtype == np.uint16:        # bfloat16 bits
            a = (a.astype(np.uint32) << 16).view(np.float32)
        return a.astype(np.float32)
    save_pytree({"params": f32(tree)}, str(root / "jax_ckpt"))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    out = _spawn(root, {"2x2": (WORLDS["2x2"], ("models", "ckpt_save"))})
    _jax_checkpoint(root)
    out.update(_spawn(root, {
        "1x2": (WORLDS["1x2"], ("models", "ckpt_restore")),
        "2x1": (WORLDS["2x1"], ("models",)),
        "2x1x2": (WORLDS["2x1x2"], ("models",))}))
    out["root"] = root
    return out


def _world(worlds, name: str) -> dict:
    got = worlds[name]
    assert "error" not in got, got["error"]
    return got


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", list(WORLDS))
def test_train_step_matches_meshless(worlds, world, arch):
    rel = _world(worlds, world)["models"][arch]["train"]
    assert rel["loss"] <= TOL and rel["grad_norm"] <= TOL, rel
    assert rel["grads"] <= TOL and rel["params"] <= TOL, rel


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", list(WORLDS))
def test_prefill_and_decode_match_meshless(worlds, world, arch):
    got = _world(worlds, world)["models"][arch]
    assert got["prefill"] <= TOL, got
    assert got["decode"] <= TOL, got
    assert got.get("decode_b1", 0.0) <= TOL, got


def test_checkpoint_saved_whole_under_2x2(worlds):
    got = _world(worlds, "2x2")["ckpt_save"]
    assert got["saved_whole_equal"], got


def test_checkpoint_restored_with_shardings_in_1x2(worlds):
    got = _world(worlds, "1x2")["ckpt_restore"]
    assert got["restored_step"] == 2
    assert got["sharded_equal"] and got["jax_sharded_equal"], got


def test_mesh_checkpoint_restores_in_jax(worlds):
    """The 2 x 2 run's checkpoint, read by the JAX package without a mesh,
    bit-equal to the port's reading of it; and the JAX package's own
    checkpoint read by the port, bit-equal to what JAX saved."""
    from repro.checkpoint.manager import restore_pytree as jax_restore
    from repro_torch.checkpoint import restore_pytree
    from repro_torch.convert import to_host
    root = worlds["root"]
    _world(worlds, "2x2")
    ck = str(root / "ckpt" / "step_2")
    with open(os.path.join(ck, "manifest.json")) as f:
        names = json.load(f)["leaves"]
    port = np.load(os.path.join(ck, "arrays.npz"))
    target = {}
    for name, rec in names.items():
        node = target
        *path, leaf = name.split("::")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.zeros(rec["shape"], np.float32)
    jax_tree = jax_restore(target, ck)
    port_tree = restore_pytree(target, ck, device="cpu")

    def flat(tree, prefix=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from flat(tree[k], prefix + (k,))
        else:
            yield "::".join(prefix), tree
    jax_flat, port_flat = dict(flat(jax_tree)), dict(flat(port_tree))
    assert set(jax_flat) == set(port_flat) == set(names)
    for name in names:
        a = np.asarray(jax_flat[name]).tobytes()
        b = to_host(port_flat[name]).view(np.ndarray).tobytes()
        assert a == b == port[name].tobytes(), name
    # the JAX package's checkpoint, read by the port, is what JAX saved
    jck = str(root / "jax_ckpt")
    with open(os.path.join(jck, "manifest.json")) as f:
        jnames = json.load(f)["leaves"]
    saved = np.load(os.path.join(jck, "arrays.npz"))
    jtarget = {"params": {}}
    for name, rec in jnames.items():
        node = jtarget
        *path, leaf = name.split("::")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.zeros(rec["shape"], np.float32)
    got = dict(flat(restore_pytree(jtarget, jck, device="cpu")))
    assert set(got) == set(jnames)
    for name, t in got.items():
        assert t.numpy().tobytes() == saved[name].tobytes(), name
    # the manifest's spec string is the rules' stacked spec
    assert names["params::stage0::block0::mixer::wq::w"]["spec"] == \
        "PartitionSpec(None, 'data', 'model')"
