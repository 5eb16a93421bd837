"""The recurrent scan kernels alone on the card: build, check, time.

    python tools/scan_kernels.py [--checkout DIR] [--tag TAG] [--bwd]

builds ``selective_scan``, ``wkv6`` and their backward kernels
``selective_scan_bwd`` and ``wkv6_bwd`` (``src/repro_torch/kernels/csrc``
of the repository, or of the checkout ``DIR``, e.g. an older commit
unpacked with ``git archive``), prints what ``nvcc -Xptxas=-v`` reported
for each instance of each kernel (registers, spills, shared memory), holds
each forward kernel against its plain version on random float32 operands
from a seed, outputs and final states bit for bit, at small ragged shapes,
at a decode step and at 2,048 steps of the main path's width, then times
each kernel at the main path's shapes:

* the 32k prefill layer, by CUDA events (median of 5): a jamba
  Mamba layer (B 1, S 32,768, Di 8,192, N 16) and an rwkv6-1.6b layer
  (B 1, S 32,768, 32 heads of 64), beside ``chip_smoke.scan_bound``;
* a decode step (S = 1) at B 1 and B 4, by the device time of each of 50
  launches under ``torch.profiler`` (median; a host-timed loop would time
  the wrapper's Python).

The backward kernels are held against autograd over the plain forwards
(``chip_smoke.check_scan_bwd``: each gradient within 1e-4 of its largest
value, two launches bit-equal, the forward's bits unchanged with its
checkpoints on) at the smoke's small ragged and unaligned shapes and at
the training shapes, where they are timed (CUDA events, median of 5, the
plain backward beside them, and each of the two launches' device time by
the profiler): an rwkv6-1.6b layer at B 4 x 4,096 and B 1 x 4,096 and a
jamba Mamba layer at B 1 x 4,096.  Where the checkout's wrappers report
it (``*_bwd_plan``), each backward launch's plan is printed beside: values
a lane (and rows a thread), steps a sub-chunk, threads a block, the
cluster size, shared bytes, registers, spills, and the blocks and
clusters resident (the CUDA occupancy calculator).  ``--bwd`` skips the forward kernels' checks and
times.

The profiler's trace also gives each launch's grid and block, which are
printed.  The results go to ``chiprun_out/scan_kernels[-TAG].json``.
Needs a CUDA card and ``nvcc``; some 90 s with the build (a backward
checkout without the backward kernels times only the forwards).

A/B of two commits on one card, in one chip call: unpack the parent with
``git archive`` into a gitignored directory (``build/<dir>``) and run
parent, change, change, parent, each with ``--bwd`` and its own ``--tag``.
"""
import argparse
import json
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ap = argparse.ArgumentParser()
ap.add_argument("--checkout", type=Path, default=ROOT,
                help="the checkout whose kernels to build, check and time")
ap.add_argument("--tag", default="", help="suffix of the JSON report")
ap.add_argument("--bwd", action="store_true",
                help="the backward kernels only (the forwards build for "
                     "their checkpoints)")
args = ap.parse_args()
CHECKOUT = args.checkout.resolve()
REPS = 5  # CUDA-event timings of a 32k layer
sys.path[:0] = [str(CHECKOUT), str(CHECKOUT / "src")]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.selective_scan.ops import selective_scan  # noqa: E402
from repro_torch.kernels.wkv6.ops import wkv6  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("tools/scan_kernels.py needs a CUDA card")
card = cs.phase_environment()
print(f"[checkout] {CHECKOUT}")
SCANS = [n for n in ("selective_scan", "wkv6", "selective_scan_bwd",
                     "wkv6_bwd") if n in _build.KERNELS]
_build.build(SCANS)
report: dict = {"checkout": str(CHECKOUT), "card": card, "build": {}}


def ptxas(name: str) -> list:
    """Each kernel instance of ``name``'s library as ptxas reported it."""
    out, cur = [], None
    for line in _build.compiler_report(name).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"function": m.group(1), "template": [
                int(x) for x in re.findall(r"Li(\d+)E", m.group(1))]}
            out.append(cur)
            continue
        if cur is None:
            continue
        for key, pat in (("registers", r"Used (\d+) registers"),
                         ("smem_bytes", r"(\d+) bytes smem"),
                         ("stack_bytes", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads")):
            m = re.search(pat, line)
            if m:
                cur[key] = int(m.group(1))
    return out


for name in SCANS:
    report["build"][name] = ptxas(name)
    for inst in report["build"][name]:
        args_ = ", ".join(map(str, inst["template"]))
        print(f"[build] {name}<{args_}>: "
              f"{inst.get('registers')} registers, "
              f"{inst.get('smem_bytes', 0)} bytes shared, "
              f"spill stores {inst.get('spill_stores')} loads "
              f"{inst.get('spill_loads')} bytes, stack "
              f"{inst.get('stack_bytes')} bytes")
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)


def rand(*shape):
    return torch.randn(*shape, device=dev, generator=gen)


def scan_operands(b, s, di, n):
    a = -torch.arange(1, n + 1, device=dev, dtype=torch.float32)
    return (rand(b, s, di), torch.nn.functional.softplus(rand(b, s, di) - 2),
            rand(b, s, n), rand(b, s, n), a.repeat(di, 1), rand(b, di, n))


def wkv_operands(b, s, h, hd):
    return (rand(b, s, h, hd) * 0.5, rand(b, s, h, hd) * 0.5,
            rand(b, s, h, hd) * 0.5,
            torch.exp(-torch.exp(rand(b, s, h, hd) - 2)),
            rand(h, hd) * 0.1, rand(b, h, hd, hd))


def profiled(fn, kernel: str, n: int = 50) -> dict:
    """``n`` launches of ``fn`` under the profiler: the median device time
    of the kernel whose name holds ``kernel``, and its grid and block."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    path = CHECKOUT / "build" / "scan_kernels_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "kernel" and kernel in e.get("name", "")]
    path.unlink()
    if not events:
        raise AssertionError(f"the profiler saw no {kernel} launch")
    a = events[0].get("args", {})
    return {"device_ms": statistics.median(e["dur"] for e in events) / 1e3,
            "profiled_launches": len(events),
            "grid": a.get("grid"), "block": a.get("block"),
            "registers_per_thread": a.get("registers per thread"),
            "shared_memory": a.get("shared memory")}


cases = (("selective_scan", selective_scan, scan_operands,
          ((2, 37, 200, 8), (3, 19, 200, 4), (4, 1, 8200, 16),
           (1, 2048, 8192, 16)), (1, 32768, 8192, 16), (8192, 16)),
         ("wkv6", wkv6, wkv_operands,
          ((2, 37, 3, 16), (3, 21, 5, 64), (4, 1, 32, 64),
           (1, 2048, 32, 64)), (1, 32768, 32, 64), (32, 64)))
failed = []
for name, fn, operands, checks, layer, width in (() if args.bwd else cases):
    rec = report[name] = {"checks": {}}
    for shape in checks + (("unaligned",) + checks[0],):
        *ops, state = operands(*shape[-4:])
        if shape[0] == "unaligned":
            ops = [cs._unaligned(t) for t in ops]
        s_k, s_r = state.clone(), state.clone()
        out_k, _ = fn(*ops, s_k)
        out_r, _ = fn(*ops, s_r, backend="ref")
        torch.cuda.synchronize()
        same = torch.equal(out_k, out_r) and torch.equal(s_k, s_r)
        rec["checks"][str(shape)] = same
        print(f"[check] {name} {shape}: bit-equal to the plain version "
              f"{same}")
        if not same:
            failed.append(f"{name} {shape}")
    for b, s in ((1, layer[1]), (1, 1), (4, 1)):
        shape = (b, s) + width
        ops_state = operands(*shape)
        *ops, state = ops_state
        b_ms, b_by = cs.scan_bound(name, ops_state)
        prof = profiled(lambda: fn(*ops, state), f"{name}_kernel",
                        n=5 if s > 1 else 50)
        row = {"bound_ms": b_ms, "bound_by": b_by, **prof}
        if s > 1:
            row["ms"] = cs.cuda_time_ms(lambda: fn(*ops, state),
                                        reps=REPS)
        rec[str(shape)] = row
        timed = (f"{row['ms']:.4f} ms (CUDA events, median of {REPS}),"
                 f" " if "ms" in row else "")
        print(f"[time] {name} {shape}: {timed}device "
              f"{row['device_ms']:.4f} ms (profiler, median), bound "
              f"{b_ms:.4f} ms ({b_by}), "
              f"{row.get('ms', row['device_ms']) / b_ms:.1f}x; grid "
              f"{row['grid']}, block {row['block']}, registers "
              f"{row['registers_per_thread']}, shared "
              f"{row['shared_memory']}")
        del ops, state, ops_state
        torch.cuda.empty_cache()
# the backward kernels: small shapes, then the training shapes, timed
BWD_SHAPES = (("wkv6_bwd", (4, 4096, 32, 64)), ("wkv6_bwd", (1, 4096, 32, 64)),
              ("selective_scan_bwd", (1, 4096, 8192, 16)))


def bwd_plan(name: str, shape) -> dict:
    """The checkout's own report of the backward launch, where it has one."""
    import importlib
    mod = importlib.import_module(
        "repro_torch.kernels.wkv6.ops" if name == "wkv6_bwd"
        else "repro_torch.kernels.selective_scan.ops")
    fn = getattr(mod, f"{name}_plan", None)
    return fn(*shape) if fn is not None else {}


if "wkv6_bwd" in SCANS:
    for key, rec in cs.scan_bwd_small(dev).items():
        report.setdefault("bwd_checks", {})[key] = rec["max_abs_err"]
    for name, shape in BWD_SHAPES:
        fwd, bwd, _ = cs._scan_fns(name)
        *ops, state = (wkv_operands if name == "wkv6_bwd"
                       else scan_operands)(*shape)
        dout = rand(*ops[0].shape)
        _, _, ckpt = fwd(*ops, state.clone(), checkpoints=True)
        bwd_args = (*ops, ckpt, dout, torch.randn_like(state))
        try:
            row = cs.check_scan_bwd(name, bwd_args, f"{shape}")
        except AssertionError as e:
            failed.append(f"{name} {shape}: {e}")
            continue
        row["device_ms"] = {}
        for part in ("kernel", "finish"):
            prof = profiled(lambda: bwd(*bwd_args), f"{name}_{part}", n=5)
            row["device_ms"][part] = prof["device_ms"]
            row[f"{part}_launch"] = {k: prof[k] for k in (
                "grid", "block", "registers_per_thread", "shared_memory")}
        row["plan"] = bwd_plan(name, shape)
        report.setdefault(name, {})[str(shape)] = row
        print(f"[time] {name} {shape}: {row['ms']:.4f} ms (CUDA events, "
              f"median of {REPS}), device: scan "
              f"{row['device_ms']['kernel']:.4f} ms, sums "
              f"{row['device_ms']['finish']:.4f} ms (profiler); bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}), "
              f"{row['ms'] / row['bound_ms']:.1f}x; plain "
              f"{row['plain_ms']:.1f} ms; scan launch "
              f"{row['kernel_launch']}; plan {row['plan']}")
        del ops, state, dout, ckpt, bwd_args
        torch.cuda.empty_cache()
tag = f"-{args.tag}" if args.tag else ""
out = ROOT / "chiprun_out" / f"scan_kernels{tag}.json"
out.parent.mkdir(parents=True, exist_ok=True)
out.write_text(json.dumps(report, indent=1))
print(f"[done] report in {out}")
if failed:
    sys.exit(f"kernels differ from their plain versions: {failed}")
