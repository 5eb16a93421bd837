"""End-to-end training driver of the port.

    python -m repro_torch.launch.train --arch gemma3-1b --full \\
        --steps 50 --batch 2 --seq 4096 --ckpt-dir build/ckpt
    python -m repro_torch.launch.train --arch glm4-9b --smoke --device cpu \\
        --steps 8 --batch 4 --seq 32

Counterpart of ``repro.launch.train`` on one device: config registry ->
``init_params`` (random weights from seed 0, drawn on the device) ->
synthetic data pipeline (prefetched numpy batches, moved to the device at
the step) -> the train step of ``plan_cell`` (in place) -> checkpoint
manager (async, bounded retention) -> restart from the latest checkpoint.

Two things differ from the reference, both on purpose:

* **The data cursor.**  The reference restarts its data stream at batch 0
  on a resume.  Here step ``s`` always trains on ``SyntheticLM.batch(s)``,
  so a resumed run sees the batches an unbroken run sees (the durable state
  is the checkpoint and the data cursor, as ``runtime/elastic.py`` says).
* **The schedule's horizon.**  ``total_steps`` (default ``steps``) sets the
  cosine schedule's length; a run stopped early on purpose (a kill) passes
  the horizon of the run it belongs to, so that its resumed continuation is
  the unbroken run.

Checkpoints hold ``{"params", "opt"}`` in the reference's stacked layout
and names (``convert.params_to_jax``, ``convert.opt_state_to_jax``), so
either package restores the other's.

Meshes: ``mesh=`` (``launch/mesh.make_host_mesh``) or
``production_mesh=True`` (``multi_pod``) runs the same loop through
``plan_cell(mesh, fsdp=True)`` in every process of the world: each rank
draws the weights leaf by leaf and keeps only its blocks
(``init_params(ctx=...)``), and steps on its blocks.  A checkpoint stays
in the reference's format, whole arrays: every rank joins the gathers,
rank 0 writes, with each leaf's spec string (stacked layout) in the
manifest; a resume keeps each rank's blocks of what it reads
(``restore_pytree(shardings=...)``), so any mesh (or none) restores any
checkpoint.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..configs import ARCH_IDS, get_config, get_smoke_config
from ..configs.shapes import ShapeSpec
from ..convert import (BF16Bits, opt_state_from_jax, opt_state_to_jax,
                       params_from_jax, params_to_jax, to_host)
from ..data import DataConfig, Prefetcher, SyntheticLM
from ..device import DeviceLike, resolve_device
from ..models import ShardCtx, init_params
from ..optim import AdamWConfig, init_opt_state, tree_map
from ..runtime.collectives import mesh_device
from ..runtime.sharding import P, gather_full, named, stack_specs
from .mesh import make_production_mesh
from .steps import plan_cell

__all__ = ["train", "main", "checkpoint_tree", "checkpoint_specs",
           "restore_state"]


def _whole_host(tree: Any, specs: Any, mesh, keep: bool) -> Any:
    """Every leaf gathered whole, one at a time, and copied to the host
    where ``keep`` (else dropped at once: None); stage lists stacked on the
    period axis (the reference's layout)."""
    if isinstance(tree, dict):
        return {k: _whole_host(v, specs[k], mesh, keep)
                for k, v in tree.items()}
    if isinstance(tree, list):
        periods = [_whole_host(t, s, mesh, keep)
                   for t, s in zip(tree, specs)]
        return _stack_host(periods) if keep else None
    whole = gather_full(tree, specs, mesh)
    return to_host(whole) if keep else None


def _stack_host(periods: list) -> Any:
    first = periods[0]
    if isinstance(first, dict):
        return {k: _stack_host([p[k] for p in periods]) for k in first}
    out = np.stack([np.asarray(p) for p in periods])
    return BF16Bits(out) if isinstance(first, BF16Bits) else out


def _opt_specs(ctx: ShardCtx) -> dict:
    return {"m": ctx.param_specs, "v": ctx.param_specs, "step": P()}


def checkpoint_tree(cfg, params: dict, opt_state: dict,
                    ctx: Optional[ShardCtx] = None) -> dict:
    """``{"params", "opt"}`` in the reference's layout, on the host; under
    ``ctx`` whole arrays gathered from every rank's blocks, a leaf at a
    time (a collective: every rank calls it), held only by global rank 0:
    the other ranks get None."""
    if ctx is None:
        return {"params": params_to_jax(cfg, params),
                "opt": opt_state_to_jax(cfg, opt_state)}
    keep = dist.get_rank() == 0
    tree = {"params": _whole_host(params, ctx.param_specs, ctx.mesh, keep),
            "opt": _whole_host(opt_state, _opt_specs(ctx), ctx.mesh, keep)}
    return tree if keep else None


def checkpoint_specs(ctx: ShardCtx) -> dict:
    """The manifest's spec of every leaf of :func:`checkpoint_tree`'s tree
    (the stacked layout's)."""
    return {"params": stack_specs(ctx.param_specs),
            "opt": {"m": stack_specs(ctx.param_specs),
                    "v": stack_specs(ctx.param_specs), "step": P()}}


def restore_state(cfg, manager: CheckpointManager, params: dict,
                  opt_state: dict, device: torch.device,
                  ctx: Optional[ShardCtx] = None):
    """(step, params, opt_state) from the latest checkpoint (of either
    package), or (None, params, opt_state) if there is none; under ``ctx``
    this rank's blocks of it."""
    # the target only names and shapes the leaves: meta tensors, a stage's
    # leaves stacked over its periods as the reference stacks them
    def meta(t, n=None):
        shape = tuple(t.shape) if n is None else (n,) + tuple(t.shape)
        return torch.empty(shape, dtype=t.dtype, device="meta")

    def stacked(tree):
        return {k: (tree_map(lambda t, n=len(v): meta(t, n), v[0])
                    if k.startswith("stage") else tree_map(meta, v))
                for k, v in tree.items()}

    if ctx is not None:      # whole shapes, from the rules' own
        from .specs import abstract_params
        whole = abstract_params(cfg)
        target = {"params": stacked(whole),
                  "opt": {"m": stacked(whole), "v": stacked(whole),
                          "step": meta(torch.zeros((), dtype=torch.int32))}}
        step, tree = manager.restore_latest(
            target, shardings=named(ctx.mesh, checkpoint_specs(ctx)),
            device="cpu")
        if step is None:
            return None, None, None
        return (step, params_from_jax(cfg, tree["params"], device=device),
                opt_state_from_jax(cfg, tree["opt"], device=device))
    target = {"params": stacked(params),
              "opt": {"m": stacked(opt_state["m"]),
                      "v": stacked(opt_state["v"]),
                      "step": meta(opt_state["step"])}}
    step, tree = manager.restore_latest(target, device="cpu")
    if step is None:
        return None, params, opt_state
    return (step, params_from_jax(cfg, tree["params"], device=device),
            opt_state_from_jax(cfg, tree["opt"], device=device))


def train(arch: str, *, smoke: bool = True, steps: int = 50,
          global_batch: int = 8, seq_len: int = 128,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 20,
          production_mesh: bool = False, multi_pod: bool = False,
          peak_lr: float = 3e-4, log_every: int = 10,
          remat: str = "full", resume: bool = True,
          device: DeviceLike = None,
          total_steps: Optional[int] = None, mesh: Any = None) -> dict:
    """Train ``arch`` (its smoke config, or the full one with
    ``smoke=False``) for steps ``[start, steps)``, where ``start`` is the
    latest checkpoint's step (0 without one).  Returns the reference's dict
    (``arch``, ``steps`` run, ``first_loss``, ``final_loss``, ``wall_s``,
    ``tok_per_s``, ``losses`` as (step, loss) at the logged steps) plus
    ``start_step``, ``step_s`` (host seconds of each logged step, from the
    previous logged step's end; every step with ``log_every=1``),
    ``restore_s`` (the resume's restore, or None), ``save_s`` (the last
    checkpoint's host copy and write until it is on disk, which may overlap
    later steps; or None).  With ``mesh`` (or ``production_mesh``) every
    rank of the world calls it (module docstring); the losses are the
    whole batch's."""
    if production_mesh or multi_pod:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    device = mesh_device(mesh) if mesh is not None else \
        resolve_device(device)
    lead = mesh is None or dist.get_rank() == 0
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = ShapeSpec("custom", seq_len, global_batch, "train")
    horizon = steps if total_steps is None else total_steps
    opt_cfg = AdamWConfig(peak_lr=peak_lr, total_steps=horizon,
                          warmup_steps=max(1, horizon // 20))
    plan = plan_cell(cfg, shape, mesh, opt_cfg=opt_cfg, remat=remat,
                     device=device)
    ctx = plan.ctx

    params = init_params(cfg, 0, device=device, ctx=ctx)
    opt_state = init_opt_state(params, opt_cfg)

    start_step = 0
    manager = None
    restore_s = save_s = None
    if ckpt_dir:
        manager = CheckpointManager(ckpt_dir, keep=2)
        if resume:
            t_restore = time.monotonic()
            got, p, o = restore_state(cfg, manager, params, opt_state,
                                      device, ctx)
            if got is not None:
                start_step, params, opt_state = got, p, o
                restore_s = time.monotonic() - t_restore
                if lead:
                    print(f"resumed from step {start_step}")

    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch,
        embed_dim=cfg.d_model if cfg.frontend else None))
    # batch s at step s, whatever step the run starts at
    it = Prefetcher((data.batch(s) for s in range(start_step, steps)),
                    prefetch=2)

    losses, step_s = [], []
    t_save = None
    t0 = time.monotonic()
    t_last = t0
    tokens_per_step = global_batch * seq_len
    for step in range(start_step, steps):
        batch = next(it)
        params, opt_state, metrics = plan.step(params, opt_state, batch)
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])       # waits for the step
            now = time.monotonic()
            step_s.append((step, now - t_last))
            t_last = now
            losses.append((step, loss))
            done = step - start_step + 1
            if lead:
                    print(f"step {step:5d} loss {loss:8.4f} "
                      f"nll {float(metrics['nll']):8.4f} "
                      f"gnorm {float(metrics['grad_norm']):7.3f} "
                      f"tok/s {tokens_per_step * done / (now - t0):10.0f}",
                      flush=True)
        if manager and (step + 1) % ckpt_every == 0:
            t_save = time.monotonic()
            tree = checkpoint_tree(cfg, params, opt_state, ctx)
            if lead:
                manager.save(step + 1, tree, specs=ctx and
                             checkpoint_specs(ctx))
            del tree
    if manager:
        manager.wait()
        if t_save is not None:
            save_s = time.monotonic() - t_save
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.monotonic() - t0
    out = {
        "arch": cfg.name,
        "steps": steps - start_step,
        "start_step": start_step,
        "final_loss": losses[-1][1] if losses else None,
        "first_loss": losses[0][1] if losses else None,
        "wall_s": wall,
        "tok_per_s": tokens_per_step * (steps - start_step) / wall
        if steps > start_step else 0.0,
        "losses": losses,
        "step_s": step_s,
        "restore_s": restore_s,
        "save_s": save_s,
    }
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "dots"])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' to run here")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16 x 16 mesh (a world of 256 processes)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production-mesh: 2 x 16 x 16 (512)")
    args = ap.parse_args(argv)
    out = train(args.arch, smoke=args.smoke, steps=args.steps,
                global_batch=args.batch, seq_len=args.seq,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                peak_lr=args.lr, remat=args.remat, device=args.device,
                production_mesh=args.production_mesh,
                multi_pod=args.multi_pod)
    print({k: v for k, v in out.items() if k not in ("losses", "step_s")})
    return out


if __name__ == "__main__":
    main()
