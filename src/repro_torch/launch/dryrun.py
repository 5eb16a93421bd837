"""Dry run of the port: one step of every (arch x shape x mesh) cell,
counted for one device of the production mesh, with no device at all.

Counterpart of ``repro.launch.dryrun``, which forces 512 host devices and
lowers and compiles each cell.  Here each cell runs in a process of its
own, which

1. starts a fake process group (``torch.distributed``'s "fake" backend)
   of 256 or 512 ranks, as rank 0;
2. builds the production mesh on it (``make_production_mesh``) and plans
   the cell with ``plan_cell(cfg, shape, mesh, fsdp=, remat=)``;
3. builds this rank's parameter, optimizer, batch and cache blocks as meta
   tensors (shapes without storage);
4. runs one step of them under ``benchlib.op_analysis.analyze_step``:
   every op is counted with the reference's rules, every collective with
   its group, every hand-written kernel op by its ``work`` formula (on
   meta operands a kernel's CUDA body allocates its outputs, is counted
   and launches nothing; ``kernels.dispatch.trace_only``);
5. writes the reference's record and the per-op count list.

Meta tensors take the card's branches everywhere (``kernels.dispatch``
resolves them to the hand kernels).  A fake CUDA tensor would too, but a
CPU-only build of torch cannot run autograd on one (its engine asks for
the CUDA device guard, which that build lacks), and the dry run must run
on a host with no card.  The process's fake group is destroyed with the
cell and the process ends: no other work shares it.

For each cell, under ``--out``:
    <arch>/<shape>/<mesh>.json          memory (this rank's arguments and
                                        outputs, and its peak less the
                                        arguments as temp), the roofline
                                        analysis, degraded shardings, the
                                        layers computed replicated over the
                                        model axis, timings
    <arch>/<shape>/<mesh>.ops.jsonl.gz  the per-op count list (input to
                                        ``benchlib.roofline.reanalyze``)

Usage:
    python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--both-meshes]
        [--jobs N]
    python -m repro_torch.benchlib.roofline table pod256 results/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import multiprocessing.connection
import os
import time
import traceback
from typing import Callable, Optional, Sequence, Tuple

__all__ = ["run_cell", "run_cells", "start_cells", "trace_cell", "main"]

RESULTS = os.path.join("results", "dryrun_torch")


def _skip_reason(arch: str) -> str:
    return ("long_500k requires sub-quadratic attention; "
            f"{arch} is pure full-attention (DESIGN.md §4)")


def _mesh_name(multi_pod: bool, mesh_shape) -> str:
    if mesh_shape is not None:
        return "x".join(map(str, mesh_shape))
    return "pod512" if multi_pod else "pod256"


def _tree_bytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if hasattr(t, "element_size"))


def _arguments(cfg, shape, plan) -> Tuple[tuple, int]:
    """This rank's step arguments as meta tensors (the whole batch, which
    the step cuts; the rank's own blocks of everything else), and the
    bytes the rank holds of them (the batch's block only)."""
    import torch
    from torch.utils._pytree import tree_leaves, tree_map
    from ..models import init_cache, init_params
    from ..optim import init_opt_state
    from ..runtime.sharding import batch_specs, shard_local
    from .specs import input_specs
    meta = torch.device("meta")
    mesh, policy = plan.mesh, plan.policy
    ins = input_specs(cfg, shape)
    params = init_params(cfg, 0, device=meta, ctx=plan.ctx)

    def block_bytes(tree) -> int:
        specs = batch_specs(tree, policy)
        return sum(_tree_bytes(shard_local(t, s, mesh))
                   for t, s in zip(tree_leaves(tree), tree_leaves(specs)))

    held = _tree_bytes(params) + block_bytes(ins["batch"])
    if shape.kind == "train":
        opt = init_opt_state(params, plan.opt_cfg)
        return (params, opt, ins["batch"]), held + _tree_bytes(opt)
    if shape.kind == "prefill":
        return (params, ins["batch"]), held
    whole = init_cache(cfg, shape.global_batch, shape.seq_len, device=meta)
    cache = tree_map(lambda t, s: shard_local(t, s, mesh).clone(), whole,
                     plan.ctx.cache_specs)
    held += _tree_bytes(cache) + block_bytes({"pos": ins["pos"]})
    return (params, cache, ins["batch"], ins["pos"]), held


def trace_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
               save_ops: bool, fsdp: bool, remat: str, flags: str,
               shape=None, mesh_shape=None, cfg=None) -> dict:
    """One cell in this process, which must run nothing else while it
    holds the fake process group (:func:`run_cell` gives the cell a
    process of its own) -> its record, also written under ``out_dir``."""
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from ..benchlib.op_analysis import analyze_step
    from ..benchlib.roofline import analysis_block
    from ..benchlib.roofline import save_ops as write_ops
    from ..configs import SHAPES, cell_applicable, get_config
    from ..models.flags import reset_flags, set_flags
    from ..models.transformer import replication_tally
    from .mesh import make_host_mesh, make_production_mesh
    from .steps import plan_cell
    reset_flags()
    if flags:
        set_flags(**dict(kv.split("=") for kv in flags.split(",")))
    named_cfg = cfg is None
    cfg = get_config(arch) if named_cfg else cfg
    shape = shape or SHAPES[shape_name]
    mesh_name = _mesh_name(multi_pod, mesh_shape)
    dims = tuple(mesh_shape) if mesh_shape is not None else \
        ((2, 16, 16) if multi_pod else (16, 16))
    cell_dir = os.path.join(out_dir, arch, shape_name)
    os.makedirs(cell_dir, exist_ok=True)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "devices": math.prod(dims),
                 "applicable": cell_applicable(cfg, shape)}
    if not named_cfg:
        rec["config"] = cfg.name
    if shape is not SHAPES.get(shape_name):
        rec["shape_spec"] = {"seq_len": shape.seq_len,
                             "global_batch": shape.global_batch,
                             "kind": shape.kind}
    if not rec["applicable"]:
        rec["status"] = "skipped"
        rec["reason"] = _skip_reason(arch)
        _write(cell_dir, mesh_name, rec)
        return rec

    t0 = time.monotonic()
    meta = torch.device("meta")
    try:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=rec["devices"])
        try:
            if mesh_shape is None:
                mesh = make_production_mesh(multi_pod=multi_pod, device=meta)
            elif len(dims) == 2:
                mesh = make_host_mesh(*dims, device=meta)
            else:
                mesh = make_host_mesh(dims[1], dims[2], pods=dims[0],
                                      device=meta)
            plan = plan_cell(cfg, shape, mesh, fsdp=fsdp, remat=remat)
            args, held = _arguments(cfg, shape, plan)
            t1 = time.monotonic()
            with replication_tally() as tally:
                cost = analyze_step(plan.step, *args)
            rec["lower_s"] = round(time.monotonic() - t1, 2)
            rec["memory_analysis"] = {
                "argument_size_in_bytes": held,
                "output_size_in_bytes": cost.output_bytes,
                "temp_size_in_bytes": cost.peak_bytes - cost.argument_bytes}
            rec["analysis"] = analysis_block(cost)
            rec["degraded_shardings"] = sorted(set(plan.policy.degraded))[:40]
            rec["replicated_layers"] = dict(sorted(tally.items()))
            rec["op_records"] = len(cost.ops)
            if save_ops:
                write_ops(os.path.join(cell_dir, f"{mesh_name}.ops.jsonl.gz"),
                          cost.ops)
            rec["status"] = "ok"
            a = rec["analysis"]
            print(f"[{arch}/{shape_name}/{mesh_name}] memory_analysis: "
                  f"{rec['memory_analysis']}; roofline terms: compute "
                  f"{a['compute_s']:.4f}s memory {a['memory_s']:.4f}s "
                  f"collective {a['collective_s']:.4f}s -> "
                  f"{a['dominant']}-bound", flush=True)
        finally:
            dist.destroy_process_group()
    except Exception as e:  # noqa: BLE001 - record the failure verbatim
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.monotonic() - t0, 2)
    _write(cell_dir, mesh_name, rec)
    print(f"[{arch}/{shape_name}/{mesh_name}] {rec['status']} "
          f"({rec['total_s']}s)", flush=True)
    if rec["status"] == "error":
        print(rec["traceback"], flush=True)
    return rec


def _write(cell_dir: str, mesh_name: str, rec: dict) -> None:
    slim = {k: v for k, v in rec.items() if k != "traceback"}
    with open(os.path.join(cell_dir, f"{mesh_name}.json"), "w") as f:
        json.dump(slim, f, indent=1)


def _cell_kwargs(arch: str, shape_name: str, *, multi_pod: bool = False,
                 out_dir: str = RESULTS, save_ops: bool = True,
                 fsdp: bool = True, remat: str = "full", flags: str = "",
                 shape=None, mesh_shape: Optional[Sequence[int]] = None,
                 cfg=None) -> dict:
    return dict(arch=arch, shape_name=shape_name, multi_pod=multi_pod,
                out_dir=out_dir, save_ops=save_ops, fsdp=fsdp, remat=remat,
                flags=flags, shape=shape, mesh_shape=mesh_shape, cfg=cfg)


def _child(kwargs: dict, send) -> None:
    rec = trace_cell(**kwargs)
    rec["ended_at"] = time.time()
    send.send(rec)
    send.close()


def start_cells(cells: Sequence[dict], jobs: int = 1) -> Callable[[], list]:
    """Start each cell (keyword arguments of :func:`run_cell`) in a fresh
    process of its own, ``jobs`` at a time; returns a function that waits
    for them all and returns their records in order, each with the
    seconds its process ran (``process_s``).  The caller goes on with
    other work in between."""
    ctx = multiprocessing.get_context("spawn")
    todo = list(enumerate(_cell_kwargs(**c) for c in cells))
    out: list = [None] * len(todo)
    running: dict = {}

    def launch() -> None:
        while todo and len(running) < max(1, jobs):
            i, kwargs = todo.pop(0)
            recv, send = ctx.Pipe(duplex=False)
            proc = ctx.Process(target=_child, args=(kwargs, send))
            proc.start()
            send.close()
            running[recv] = (i, kwargs, proc, time.time())

    def finish() -> list:
        while todo or running:
            launch()
            for recv in multiprocessing.connection.wait(list(running)):
                i, kwargs, proc, started = running.pop(recv)
                try:
                    rec = recv.recv()
                    rec["process_s"] = round(rec.pop("ended_at") - started,
                                             2)
                except EOFError:     # the child died without a record
                    rec = {"arch": kwargs["arch"],
                           "shape": kwargs["shape_name"], "status": "error",
                           "error": "the cell's process ended without a "
                                    "record"}
                proc.join()
                if proc.exitcode and rec["status"] != "error":
                    rec = {**rec, "status": "error",
                           "error": f"the cell's process exited "
                                    f"{proc.exitcode}"}
                out[i] = rec
        return out

    launch()
    return finish


def run_cells(cells: Sequence[dict], jobs: int = 1) -> list:
    """Each cell in a fresh process of its own, ``jobs`` at a time -> their
    records, in order (:func:`start_cells`, waited for)."""
    return start_cells(cells, jobs)()


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             out_dir: str = RESULTS, save_ops: bool = True,
             fsdp: bool = True, remat: str = "full", flags: str = "",
             shape=None, mesh_shape: Optional[Sequence[int]] = None,
             cfg=None) -> dict:
    """Dry-run one cell in a child process -> its record (also written
    under ``out_dir``).  ``shape`` (a ``ShapeSpec``) overrides the named
    shape's sizes, ``mesh_shape`` the production mesh ((data, model) or
    (pod, data, model)), ``cfg`` (a ``ModelConfig``) the arch's config."""
    return run_cells([dict(arch=arch, shape_name=shape_name,
                           multi_pod=multi_pod, out_dir=out_dir,
                           save_ops=save_ops, fsdp=fsdp, remat=remat,
                           flags=flags, shape=shape, mesh_shape=mesh_shape,
                           cfg=cfg)])[0]


def main(argv=None) -> None:
    from ..configs import ARCH_IDS, SHAPES
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="2x16x16 (512 devices); default one pod of 16x16")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=RESULTS)
    ap.add_argument("--no-ops", action="store_true",
                    help="do not save the per-op count lists")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--flags", default="",
                    help="perf flags, e.g. seq_shard_acts=1,moe_a2a=1")
    ap.add_argument("--skip-done", action="store_true",
                    help="skip cells whose JSON already says ok/skipped")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in its own process")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    n_ok = n_err = n_skip = 0
    todo = []
    for a in archs:
        for s in shapes:
            for m in meshes:
                mesh_name = "pod512" if m else "pod256"
                jpath = os.path.join(args.out, a, s, f"{mesh_name}.json")
                if args.skip_done and os.path.exists(jpath):
                    with open(jpath) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[{a}/{s}/{mesh_name}] cached "
                              f"{prev['status']}", flush=True)
                        n_ok += prev["status"] == "ok"
                        n_skip += prev["status"] == "skipped"
                        continue
                todo.append(dict(arch=a, shape_name=s, multi_pod=m,
                                 out_dir=args.out, save_ops=not args.no_ops,
                                 fsdp=not args.no_fsdp, flags=args.flags))
    t0 = time.monotonic()
    for rec in run_cells(todo, jobs=args.jobs):
        n_ok += rec["status"] == "ok"
        n_err += rec["status"] == "error"
        n_skip += rec["status"] == "skipped"
    print(f"dry-run complete: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors in {time.monotonic() - t0:.1f} s", flush=True)
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
