"""The flash-attention backward kernel alone on the card: build, check, time.

    python tools/flash_bwd_ab.py [--checkout DIR] [--tag TAG]

builds ``flash_attention`` and ``flash_attention_bwd`` (``src/repro_torch/
kernels/csrc`` of the repository, or of the checkout ``DIR``, e.g. the
parent commit unpacked with ``git archive``), prints what ``nvcc
-Xptxas=-v`` reported for each instance of the backward's kernels
(registers, spills) and each build's shared-memory plan (as the library's
``flash_attention_bwd_plan`` reports it), then at the three shapes of
PERF.md's kernel table makes operands from a seed, as the training path
hands them over (q pre-scaled, float32 q and k, bf16 v, float32 dO; o and
the rows' log-sum-exp from the checkout's forward kernel):

* gemma3-1b's global layer: B 1, S 4,096, 4 query heads on 1 KV head,
  D 256, causal;
* its local layer: the same with a window of 512;
* deepseek-moe-16b's layer: 16 heads (G 1), D 128, causal.

At each it holds the kernel against its plain version (within 2**-5 of the
largest value of each of dQ, dK, dV, as ``chip_smoke.FLASH_BWD_TOL``) and
two launches bit-equal, then times it by CUDA events (median of 5) and
prints the time beside two floors from this repository's ``chip_smoke.py``:
``flash_bwd_bound`` (the five products at the bf16 rate, the table's bound
column) and ``flash_bwd_floor`` (each product in the type it must keep:
q.k^T, dQ and dK as three TF32 passes, dP and dV in bf16; and with the dQ
pass's recomputation of q.k^T and dP).  The report goes to
``chiprun_out/flash_bwd_ab[-TAG].json``.  To compare two commits, unpack
both into gitignored directories and run, in one chip call, parent,
change, change, parent.  Needs a CUDA card and ``nvcc``; some 40 s with
the build.
"""
import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ap = argparse.ArgumentParser()
ap.add_argument("--checkout", type=Path, default=ROOT,
                help="the checkout whose kernels to build, check and time")
ap.add_argument("--tag", default="", help="suffix of the JSON report")
args = ap.parse_args()
CHECKOUT = args.checkout.resolve()
REPS = 5
# this repository's smoke (bounds, timing), then the checkout's kernels
# (chip_smoke puts this repository's src first on the path)
sys.path.insert(0, str(ROOT))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

sys.path.insert(0, str(CHECKOUT / "src"))
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention_bwd_cuda, flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_bwd_ref  # noqa: E402

if not torch.cuda.is_available():
    sys.exit("tools/flash_bwd_ab.py needs a CUDA card")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
card = cs.phase_environment()
print(f"[checkout] {CHECKOUT} (kernels from {Path(_build.__file__).parent})")
_build.build(["flash_attention", "flash_attention_bwd"])
report: dict = {"checkout": str(CHECKOUT), "card": card, "shapes": {}}

# (label, query heads, KV heads, D, window): B 1, S 4,096, causal
SHAPES = (("gemma3-1b global layer", 4, 1, 256, None),
          ("gemma3-1b local layer", 4, 1, 256, 512),
          ("deepseek-moe-16b layer", 16, 16, 128, None))
S = 4096


def ptxas() -> list:
    """Each kernel instance of the backward's library as ptxas reported
    it."""
    out, cur = [], None
    for line in _build.compiler_report("flash_attention_bwd").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"function": m.group(1)}
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


def label(function: str) -> str:
    """A kernel instance's short name from its mangled one."""
    m = re.search(r"flash_bwd_kernelI(.*?)Li(\d+)ELb([01])E", function)
    if not m:
        return re.sub(r"^_ZN\w*?_cu_\w{8}\d+", "", function)[:40]
    types = ("float32/bf16" if "F32" in m[1] and "BF16" in m[1] else
             "bf16" if "BF16" in m[1] else "float32")
    return f"{types} D {m[2]} {'dK/dV' if m[3] == '1' else 'dQ'}"


def plans() -> dict:
    """Each build's plan, as the library reports it (a checkout whose
    library has no ``flash_attention_bwd_plan`` gives none)."""
    lib = _build.load("flash_attention_bwd")
    if not hasattr(lib, "flash_attention_bwd_plan"):
        return {}
    fn = lib.flash_attention_bwd_plan
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = {}
    for types, qk, v in (("float32/bf16", 0, 1), ("float32", 0, 0),
                         ("bf16", 1, 1)):
        for d in (16, 32, 64, 128, 256):
            for kv, name in ((1, "dK/dV"), (0, "dQ")):
                buf = (ctypes.c_int * 5)()
                if fn(d, qk, v, kv, buf) == 0:
                    out[f"{types} D {d} {name}"] = dict(zip(
                        ("tile_rows", "stages", "warpgroups",
                         "blocks_per_sm", "smem_bytes"), list(buf)))
    return out


report["ptxas"] = ptxas()
report["plans"] = plans()
print("[ptxas] " + "; ".join(
    f"{label(r['function'])}: {r.get('registers')} registers, spills "
    f"{r.get('spill_stores', 0)}/{r.get('spill_loads', 0)}"
    for r in report["ptxas"]))
print("[plan] " + "; ".join(
    f"{k}: {v['tile_rows']}-row tiles, {v['stages']} stages, "
    f"{v['warpgroups']} warpgroups, {v['blocks_per_sm']} blocks an SM, "
    f"{v['smem_bytes']} B"
    for k, v in report["plans"].items()))


def operands(hq: int, hkv: int, d: int, window, seed: int):
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((hq, S, d), np.float32) * d ** -0.5
    k, v = (rng.standard_normal((hkv, S, d), np.float32) for _ in range(2))
    dout = rng.standard_normal((hq, S, d), np.float32)
    q, k, dout = (torch.from_numpy(a).to(dev) for a in (q, k, dout))
    v = torch.from_numpy(v).to(dev, torch.bfloat16)
    kw = dict(causal=True, window=window, softcap=None)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    return (q, k, v, o, dout, lse), kw


for i, (label, hq, hkv, d, window) in enumerate(SHAPES):
    args_, kw = operands(hq, hkv, d, window, seed=i)
    q, k, v = args_[:3]
    got = flash_attention_bwd_cuda(*args_, **kw)
    again = flash_attention_bwd_cuda(*args_, **kw)
    want = flash_attention_bwd_ref(*args_, **kw)
    torch.cuda.synchronize()
    err = [float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))
           for a, b in zip(got, want)]
    equal = all(torch.equal(a, b) for a, b in zip(got, again))
    del got, again, want
    ms = cs.cuda_time_ms(lambda: flash_attention_bwd_cuda(*args_, **kw),
                         reps=REPS)
    # the device time of each of its kernels, over REPS ops
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            flash_attention_bwd_cuda(*args_, **kw)
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = ev.cuda_time_total
        name = ev.key
        tag = ("dK/dV pass" if "true>" in name or "dkdv" in name else
               "dQ pass" if "false>" in name or "dq_kernel" in name else
               "Delta pass" if "delta" in name else
               "head sums" if "sum_heads" in name else None)
        if tag and t:
            kernels[tag] = kernels.get(tag, 0.0) + t / 1e3 / REPS
    bound, bound_by, _ = cs.flash_bwd_bound(q, k, v, kw["causal"], window)
    floor, floor_two_pass = cs.flash_bwd_floor(q, k, v, kw["causal"],
                                               window)
    rec = {"ms": ms, "bound_ms": bound, "bound_by": bound_by,
           "floor_ms": floor, "floor_two_pass_ms": floor_two_pass,
           "kernels_ms": kernels, "rel_err_dq_dk_dv": err, "bit_equal": equal,
           "ok": equal and max(err) <= cs.FLASH_BWD_TOL}
    report["shapes"][label] = rec
    print(f"[time] {label}: {ms:.4f} ms; bf16 bound {bound:.4f} ms "
          f"({bound_by}), floor {floor:.4f} ms, with the dQ pass's "
          f"recomputation {floor_two_pass:.4f} ms; error "
          f"{', '.join(f'{e:.2e}' for e in err)} (allowed "
          f"{cs.FLASH_BWD_TOL:.3e}); two launches bit-equal: {equal}; "
          f"by kernel (profiler, ms an op): "
          f"{', '.join(f'{k} {v:.4f}' for k, v in kernels.items())}")
    del args_, q, k, v
    torch.cuda.empty_cache()

cs.OUT_DIR.mkdir(parents=True, exist_ok=True)
name = f"flash_bwd_ab{'-' + args.tag if args.tag else ''}.json"
(cs.OUT_DIR / name).write_text(json.dumps(report, indent=1, default=str))
print(f"[done] {cs.OUT_DIR / name}")
if not all(r["ok"] for r in report["shapes"].values()):
    sys.exit("flash_bwd_ab: a check failed")
