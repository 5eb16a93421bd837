"""Where a mesh train step's time goes at a world of 1, against the
meshless step, on the card.

    python tools/mesh_step_profile.py

gemma3-1b at full width and depth, 2 x 4,096 tokens, ``remat="full"``,
phase 13's schedule: the meshless ``plan_cell`` step and the mesh one
(``plan_cell(make_host_mesh(1, 1), fsdp=True)``, NCCL), each warmed up
3 steps, then timed in turns (meshless, mesh, mesh, meshless; host clock
around a step ending in a sync, median of 3 a turn, with the seconds the
host's garbage collector spent in each step), once as they come and once
more with the heap built so far frozen out of the collector's passes
(``gc.freeze()``: the collections then walk only what the steps make),
then 2 steps of
each under ``torch.profiler``: device busy time, the largest kernels and
the device time of NCCL's kernels; then 2 more of each under the profiler
for the kernels the mesh step adds (each kernel's device time and launches
on both paths, the largest differences) and the host ops it calls more
often (the ``c10d::`` collectives, ``aten::clone``, ``aten::copy_``,
``aten::contiguous``), each a step.  Then one collective alone at a world
of 1: an all-gather, all-reduce and reduce-scatter of 512 MiB of bf16
through NCCL against a device copy of the same bytes (CUDA events, median
of 10).  Writes ``chiprun_out/mesh_step_profile.json``.
"""
import gc
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> dict:
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import plan_cell
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, init_opt_state
    if not torch.cuda.is_available():
        sys.exit("mesh_step_profile needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.phase_environment()
    cs.phase_build()
    dev = torch.device("cuda", 0)
    cfg = get_config(cs.ARCH)
    opt_cfg = AdamWConfig(peak_lr=cs.TRAIN_LR, total_steps=cs.TRAIN_STEPS,
                          warmup_steps=max(1, cs.TRAIN_STEPS // 20))
    shape = ShapeSpec("custom", cs.TRAIN_S, cs.TRAIN_B, "train")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=cs.TRAIN_S,
                                  global_batch=cs.TRAIN_B))
    batch = data.batch(0)
    mesh = make_host_mesh(1, 1)
    runs = {}
    for name, m in (("meshless", None), ("mesh", mesh)):
        plan = plan_cell(cfg, shape, m, opt_cfg=opt_cfg, device=dev)
        params = init_params(cfg, 0, device=dev, ctx=plan.ctx)
        runs[name] = (plan, params, init_opt_state(params, opt_cfg))

    gc_s = {"total": 0.0}

    def on_gc(phase, info):
        if phase == "start":
            gc_s["t0"] = time.perf_counter()
        elif "t0" in gc_s:
            gc_s["total"] += time.perf_counter() - gc_s.pop("t0")
    gc.callbacks.append(on_gc)

    def timed_step(name):
        plan, params, opt = runs[name]
        torch.cuda.synchronize()
        g0, t0 = gc_s["total"], time.monotonic()
        plan.step(params, opt, batch)
        torch.cuda.synchronize()
        return time.monotonic() - t0, gc_s["total"] - g0

    def step(name):
        return timed_step(name)[0]

    for name in runs:
        for _ in range(3):
            step(name)
    rec = {"card": card}
    for heap in ("live", "frozen"):
        if heap == "frozen":
            gc.collect()
            gc.freeze()
        turns = {"meshless": [], "mesh": []}
        for name in ("meshless", "mesh", "mesh", "meshless"):
            turns[name].extend(timed_step(name) for _ in range(3))
        rec[heap] = {
            "step_s": {k: statistics.median(t for t, _ in v)
                       for k, v in turns.items()},
            "gc_s_per_step": {k: statistics.median(g for _, g in v)
                              for k, v in turns.items()},
            "steps_and_gc_s": turns}
        cs.log(f"[mesh-profile] heap {heap}: step (median of 6, in turns): "
               f"meshless {rec[heap]['step_s']['meshless']:.4f} s (garbage "
               f"collector {rec[heap]['gc_s_per_step']['meshless']:.4f} s),"
               f" mesh {rec[heap]['step_s']['mesh']:.4f} s (garbage "
               f"collector {rec[heap]['gc_s_per_step']['mesh']:.4f} s)")
    rec["step_s"] = rec["frozen"]["step_s"]
    groups = {"nccl": ("nccl", "ncclDevKernel", "ncclKernel"),
              "flash_attention_fwd": ("flash_fwd_kernel",),
              "flash_attention_bwd": ("flash_bwd_",)}
    rec["profile"] = {name: cs.device_busy(
        lambda n=name: [step(n) for _ in range(2)], f"{name} 2 steps",
        groups) for name in runs}
    tables = {name: _op_table(lambda n=name: [step(n) for _ in range(2)])
              for name in runs}
    rec["mesh_adds"] = _differences(tables, steps=2)
    cs.log("[mesh-profile] a mesh step against a meshless one: " + "; ".join(
        f"{d['name'][:48]} {d['ms_per_step'][0]:.3f} -> "
        f"{d['ms_per_step'][1]:.3f} ms in {d['calls_per_step'][0]} -> "
        f"{d['calls_per_step'][1]} launches" for d in
        rec["mesh_adds"]["kernels"][:6]) + "; host ops a step: " + ", ".join(
        f"{d['name']} {d['calls_per_step'][0]} -> {d['calls_per_step'][1]}"
        for d in rec["mesh_adds"]["host_ops"]))
    del runs
    torch.cuda.empty_cache()

    # one collective alone at a world of 1 against a copy of its bytes
    group = mesh.get_group("data")
    x = torch.randn(256 << 20, device=dev).to(torch.bfloat16)  # 512 MiB
    out = torch.empty_like(x)

    def timed(fn, reps=10):
        ms = []
        for _ in range(reps):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        return statistics.median(ms)

    gb = x.numel() * x.element_size() / 1e9
    coll = {"copy": timed(lambda: out.copy_(x)),
            "all_gather": timed(lambda: dist.all_gather_into_tensor(
                out, x, group=group)),
            "all_reduce": timed(lambda: dist.all_reduce(out, group=group)),
            "reduce_scatter": timed(lambda: dist.reduce_scatter_tensor(
                out, x, group=group))}
    rec["one_rank_collectives_ms"] = coll
    rec["one_rank_collectives_gb_per_s"] = {
        k: 2 * gb / (v / 1e3) for k, v in coll.items()}
    cs.log("[mesh-profile] 512 MiB at a world of 1: " + ", ".join(
        f"{k} {v:.3f} ms ({rec['one_rank_collectives_gb_per_s'][k]:.0f} "
        f"GB/s read + write)" for k, v in coll.items()))
    gc.callbacks.remove(on_gc)
    gc.unfreeze()
    dist.destroy_process_group()
    cs.OUT_DIR.mkdir(parents=True, exist_ok=True)
    (cs.OUT_DIR / "mesh_step_profile.json").write_text(
        json.dumps(rec, indent=1, default=str))
    return rec


#: the host ops counted on both paths (prefixes of the profiler's names)
HOST_OPS = ("c10d::", "nccl:", "aten::clone", "aten::copy_",
            "aten::contiguous")


def _op_table(fn) -> dict:
    """``fn`` under ``torch.profiler``: {"kernels": {name: (device ms,
    launches)}, "host_ops": {name: calls}} for the device's kernels and
    the host ops named in ``HOST_OPS``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, host = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            kernels[e.key] = (e.self_device_time_total / 1e3, e.count)
        elif e.key.startswith(HOST_OPS):
            host[e.key] = e.count
    return {"kernels": kernels, "host_ops": host}


def _differences(tables: dict, steps: int) -> dict:
    """Per step, each kernel's device time and launches and each host
    op's calls, meshless then mesh; kernels by the largest change of
    device time first, and the totals of every kernel whose name holds
    "nccl"."""
    a, b = tables["meshless"], tables["mesh"]
    kern = []
    for name in set(a["kernels"]) | set(b["kernels"]):
        (ma, ca), (mb, cb) = (t["kernels"].get(name, (0.0, 0))
                              for t in (a, b))
        if (ma, ca) != (mb, cb):
            kern.append({"name": name, "ms_per_step": (ma / steps,
                                                       mb / steps),
                         "calls_per_step": (ca / steps, cb / steps)})
    kern.sort(key=lambda d: -abs(d["ms_per_step"][1] - d["ms_per_step"][0]))
    host = [{"name": n, "calls_per_step": (a["host_ops"].get(n, 0) / steps,
                                           b["host_ops"].get(n, 0) / steps)}
            for n in sorted(set(a["host_ops"]) | set(b["host_ops"]))]
    nccl = [v for k, v in b["kernels"].items() if "nccl" in k.lower()]
    return {"kernels": kern[:20], "host_ops": host,
            "nccl_per_step": {"ms": sum(m for m, _ in nccl) / steps,
                              "launches": sum(c for _, c in nccl) / steps},
            "busy_ms_per_step": tuple(
                sum(m for m, _ in t["kernels"].values()) / steps
                for t in (a, b))}


if __name__ == "__main__":
    main()
