#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. environment: the card's name and power limit (``nvidia-smi``);
2. build: compiles every CUDA kernel of the port from ``src/repro_torch/
   kernels/csrc`` with ``nvcc`` (one process per source, all at once), and
   fails unless the flash library's machine code holds tensor-core
   instructions (``cuobjdump -sass``: HGMMA and FFMA counted); counts the
   SHA-1 body's instructions in the UTS library's machine code by the
   pipe that runs them, and reads the card's top SM clock, for the
   integer bound of both UTS kernels;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, bit-equal, with CUDA-event times (median of 10 runs) and the least
   time the card could take for the same work; ``mandelbrot`` also through
   its full-iteration build (the cycle exit off), timed in turns with the
   kernel, and through a plain run of the kernel's cycle-exit schedule,
   which counts the iterations its bound holds these inputs to;
   ``uts_expand`` (a whole task's traversal in one cooperative launch) on
   full trees of depths 8, 9 and 10, on a 50,000-node task from a depth-14
   frontier, and on the same task at a capacity that forces relaunches;
   then the depth-14 tree alone through the kernel (generations, time per
   generation), and a bag of 4,194,304 leaves, whose generations hash
   nothing (the scan and the grid barrier alone);
4. UTS main path: ``uts_sequential`` for depths 4..10 against the published
   tree sizes, then the paper's Table 1 first row (seed 19, b0 4, depth 14)
   through ``uts_sequential`` and through ``run_irregular`` on the elastic
   pool with and without batching; the three counts must agree; each path
   must launch ``uts_expand`` (at most 5 times on the sequential one, at
   most once per task on the elastic ones, relaunches aside) and
   ``uts_hash`` (the root digest); then one more elastic run (batching
   off) under ``torch.profiler``: the device's idle share and every
   ``uts_expand`` launch's duration;
5. Mariani-Silver main path: the paper's sd-64 geometry (64-pixel seed
   rectangles, depth 5, split 2, max dwell 5,000,000) on a 512x512 image
   (the paper's is 4096x4096: some 500,000 tasks, which the host-bound
   elastic pool, at a few hundred tasks a second, cannot finish inside
   the smoke's time limit), through
   ``run_irregular`` on the elastic pool with and without batching, then
   once more under ``torch.profiler`` (the device's idle share, every
   ``mandelbrot`` launch's duration, and the share of the wall time in
   which a launch over 1 ms ran); all three images must equal
   Mariani-Silver applied to ``naive_render``'s dwell map on the card,
   pixel for pixel; then, at the paper's full size, the dwell map, the
   number of tasks Mariani-Silver over it dispatches, and the plane
   through the kernel and its full-iteration build alone, bit-equal;
6. flash attention at fixed shapes (run right after phase 3): the kernel
   against its plain version at gemma3-1b's attention shapes (G = 4 query
   heads on one KV head, D = 256, bf16, batch 2, S = 4096 causal, S = 4096
   window 512, S = 4000 ragged, and S = 4096 causal with float32 q and k
   as a bf16 model feeds it) and one float32 soft-capped case, with
   kernel, plain and ``scaled_dot_product_attention`` times and the bound;
   every case is checked twice: as given, per element, within the bound
   that rounding p and the output to bf16 allows (``flash_allowed``), and
   cast to float32 through the kernel's float32 build within the
   reference's 3e-5 + 1e-4 |value|, which holds the kernel's logic (the
   masks, the tile loop, the online softmax: one template for every
   dtype) tightly;
7. betweenness centrality at the paper's scale 17 (``BC_PAPER``: 131,072
   vertices, 1,001,740 edges; run before the model): ``bc_batch`` of 8
   sampled sources of the paper graph against a queue-based float64
   Brandes on the host (in worker processes, over their own R-MAT
   sampling, whose edge set must equal the port's), and each source's
   dependency sum against the sum of (d - 1) over the vertices it reaches
   (scipy's BFS distances); once those workers have ended, the two level
   kernels (``bc_level.cu``) against their plain versions, the whole
   state (bit-packed masks, level-ordered sigma and coeff, delta) bit for
   bit after every level of ``bc_batch``'s own loop (its ``steps`` hook),
   on a scale-12 graph with 256 sources and on the paper graph with 64
   and with 1,024 sources (a main-path task's block), with CUDA-event
   times per level (median of 10), the bytes bound (one bit a pair to
   know which pairs are on duty; beside it the bound of a design that
   reads dist, 4 bytes a pair, to find them), and
   ``torch.sparse.mm`` of the CSR adjacency with the level's operand (the
   product alone, timed, never called by the port); the build fails if
   ``bc_level`` spills; then ``bc_spec(BC_PAPER, n_tasks=128,
   regenerate_graph=True)`` through ``run_irregular`` three times: on the
   elastic pool (the timed run, sources per second), on a local pool of 4
   threads with batching, which fuses queued blocks into
   ``execute_batch`` calls (the elastic pool would run each block on its
   own), and on the elastic pool under ``torch.profiler`` (the device's
   idle share, every level launch's duration, the profiler's cost in
   wall time); the elastic maps must be bit-equal and the fused one
   agree within the reference's tolerances; 3 sampled tasks of the first
   run replayed through the plain versions bit for bit;
8. the model path, gemma3-1b at full width with random weights from a
   seed: ``prefill`` of prefill_32k's S = 32,768 (batch cut from 32 to 1),
   whose 26 attention layers must each launch the flash kernel, then one
   global and one local layer's own operands again through kernel and
   plain version (both checks); 32 ``decode_step`` tokens on from that
   cache padded to an arena of 32,768 + 32; ``prefill`` at S = 4096 with the kernel and with the
   plain version forced, and prefill(4096) + one decode step against
   prefill(4097), on the same weights; a warm prefill and four decode
   steps under ``torch.profiler`` (device busy time, largest kernels, the
   device's idle share); then ``serve`` (16 requests, 4 slots, max_seq
   256) through the ElasticBatcher, which must answer all;
9. one JSON line with every kernel's launches on each main path, error,
   times and bound, then the last line ``{"ok": true, "device": ...}``.

Each of the eleven main-path runs (three UTS, two Mariani-Silver, three BC,
prefill, decode, serve) is driven with the launch counts set to 0 just before it
and read just after it, and fails unless its kernel launched.  Decode and
serve run no hand kernel (the decode product is plain PyTorch, as the
reference leaves it to XLA, and the batcher's prefill only counts
tokens); their flash launches are read and reported, 0.  The depth 4..10
checks and every comparison launch fall outside those counts.  During the
runs a seeded sample of the operands each kernel is given (a few per
distinct padded shape and static arguments; for ``uts_expand``, per
power-of-two bag size and budget) is kept, and afterwards each
sample goes through the kernel and its plain version again: bit for bit
for the integer kernels (a ``uts_expand`` sample with a budget over
``UTS_REPLAY_ITERS`` nodes, the sequential path's whole tree, is replayed
with that budget; and a ``mandelbrot`` sample that reaches the
plain version's cap, through the full-iteration build at the main path's
own 5,000,000, bit for bit); for flash attention within a per-element
bound as the model feeds it (bf16 v), and cast to float32 through the
kernel's float32 build at the reference's 3e-5 / 1e-4.  The
``mandelbrot`` timings of main-path border strips are taken on strips
chosen by rectangle (``time_border_strips``), not on that sample, so
every run times the same strips.  Phases 3, 6 and 7 check fixed shapes;
this checks the main path's own.  The script imports nothing of the JAX
reference package.  It needs CUDA: without a card it exits with code 2.
"""
from __future__ import annotations

import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: published UTS tree sizes, seed 19, b0 4, depths 4..10 (the reference
#: package's Table 1 sweep)
UTS_SIZES = {4: 101, 5: 416, 6: 1787, 7: 7134, 8: 28844, 9: 115780,
             10: 461459}

#: the paper's Table 1 first row
UTS_DEPTH = 14
#: Mariani-Silver: the paper's dwell, on a 512x512 image (phase 5)
MS_SIDE = 512
MS_DWELL = 5_000_000
#: the plain dwell runs a sampled main-path launch at its own max_dwell
#: only if every point escapes within this many iterations; else at this
MS_SAMPLE_CAP = 4096
#: main-path launches kept per distinct launch signature (shape, max_iter)
MS_SAMPLES_PER_SHAPE = 16
#: main-path border strips timed alone, chosen by rectangle: whose border
#: reaches the set, and others
MS_TIMED_IN_SET, MS_TIMED_OTHER = 16, 80
#: a mandelbrot launch longer than this counts as long (phase 5's profile)
MS_LONG_MS = 1.0
#: the full report goes here; the output directory of a chip call
OUT_DIR = ROOT / "chiprun_out"

#: H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM3 bytes/s and the
#: float32 rate outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
#: dispatch rates per SM and clock (lanes): one warp instruction a clock on
#: each of the 4 sub-partitions, the INT32 pipe's 64 lanes, the FMA pipe
#: (which also runs IMAD) 128; the UTS kernels' integer bound
#: (``int_bound_ms``) divides their SHA-1 body's instructions by these
DISPATCH_LANES = 128
INT_LANES = 64
FMA_LANES = 128

#: 32-bit operations per SHA-1 lane: 64 schedule words (3 xor + 1 rotate),
#: 80 rounds (2 rotates, 4 adds, a 2-operation boolean function on average
#: counting lop3 as one), 5 final adds.  Held against PEAK_OPS_S, a float32
#: rate that counts an FMA as two, this is the loose bound of the UTS
#: kernels (``bound_loose_ms``): the card has half as many INT32 lanes.
UTS_OPS_PER_LANE = 64 * 4 + 80 * 8 + 5
UTS_BYTES_PER_LANE = 44           # 20 B parent + 4 B index in, 20 B out
UTS_BYTES_PER_NODE = 24           # a digest and a depth
#: the published tree sizes above and the depth-14 tree
UTS_DEPTH14_NODES = 117_669_204
#: a sampled main-path ``uts_expand`` call is replayed through both
#: versions with at most this budget (the plain version takes some 8 ms a
#: generation of 8,192 nodes on the card)
UTS_REPLAY_ITERS = 400_000
#: uts_expand calls kept per (bag size bucket, budget bucket)
UTS_SAMPLES_PER_KEY = 2
#: float32 operations per dwell iteration: 3 mul, 3 add/sub, 1 fma (2)
MS_OPS_PER_ITER = 8
#: one dwell iteration's dependent chain, zr -> fmul -> fsub -> fadd -> the
#: next zr: three float32 operations, each issuing no sooner than 4 cycles
#: after the one it waits on (the dependent-issue latency of the FP32 pipe
#: on Volta and later, from public microbenchmarks: an assumption, not
#: measured here).  A strip's points run side by side, so its slowest
#: orbit's iterations times this chain bound its launch (the latency bound)
MS_CHAIN_CYCLES = 3 * 4
MS_BYTES_PER_POINT = 12           # two float32 in, one int32 out

KERNEL_SOURCES = {
    "uts_hash": ("src/repro_torch/kernels/csrc/uts_hash.cu",
                 "src/repro/kernels/uts_hash/kernel.py:96"),
    "uts_expand": ("src/repro_torch/kernels/csrc/uts_hash.cu",
                   "src/repro/kernels/uts_hash/kernel.py:96"),
    "mandelbrot": ("src/repro_torch/kernels/csrc/mandelbrot.cu",
                   "src/repro/kernels/mandelbrot/kernel.py:74"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:115"),
    "bc_forward_level": ("src/repro_torch/kernels/csrc/bc_level.cu",
                         "none (XLA dots, src/repro/algorithms/"
                         "betweenness.py:107, :124)"),
    "bc_backward_level": ("src/repro_torch/kernels/csrc/bc_level.cu",
                          "none (XLA dots, src/repro/algorithms/"
                          "betweenness.py:107, :124)"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, in ms."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_OPS_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def int_bound_ms(n_bytes: float, lanes: float, sha1: dict) -> tuple:
    """Least time for ``lanes`` SHA-1 compressions against ``n_bytes``:
    the instructions of the compiled body (``sass_pipes``) at the dispatch
    rate of the pipes that run them, which work side by side (so the
    busiest bounds), on every SM at the top SM clock."""
    per_lane = max(sha1["int"] / INT_LANES, sha1["fma"] / FMA_LANES,
                   sha1["all"] / DISPATCH_LANES)
    t_ops = lanes * per_lane / (sha1["sms"] * sha1["sm_clock_hz"]) * 1e3
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


#: SASS opcodes that go to no arithmetic pipe (memory, control, the
#: uniform datapath's U* instructions are matched by prefix)
_NOT_ALU = {"LDG", "STG", "LDS", "STS", "LD", "ST", "LDC", "ATOM", "ATOMG",
            "ATOMS", "RED", "BRA", "BRX", "JMP", "EXIT", "RET", "CALL", "BAR",
            "BSSY", "BSYNC", "WARPSYNC", "NOP", "YIELD", "S2R", "S2UR", "CS2R",
            "MEMBAR", "ERRBAR", "CCTL", "DEPBAR", "BPT", "SHFL", "VOTE"}


def sass_pipes(sass: str, kernel: str) -> dict:
    """Instructions of one kernel in a ``cuobjdump -sass`` listing, per
    lane (it is straight-line code): all of them, those on the FMA pipe
    (IMAD in every form, FFMA, FADD, FMUL), and the other arithmetic and
    logic ones, on the INT32 pipe."""
    fns = re.split(r"\n\s*Function : ", sass)
    body = [f for f in fns[1:] if kernel in f.split("\n", 1)[0]]
    if len(body) != 1:
        raise AssertionError(f"{kernel}: {len(body)} functions in the SASS")
    ops = [m.split(".")[0] for m in re.findall(
        r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body[0])]
    fma = sum(o == "IMAD" or o in ("FFMA", "FADD", "FMUL") for o in ops)
    other = sum(o in _NOT_ALU or o.startswith("U") for o in ops)
    return {"all": len(ops), "fma": fma, "int": len(ops) - fma - other}


def phase_environment() -> str:
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[env] nvidia-smi: {card}")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


def phase_build() -> dict:
    """Builds every kernel, then reads the machine code: the UTS library's
    SHA-1 body by pipe (``sass_pipes``) and the card's top SM clock, for
    the UTS kernels' integer bound; the flash library's products must be
    tensor-core instructions (HGMMA, Hopper's wgmma), and the FFMA count
    (the CUDA cores' fused multiply-adds, which the softmax and the
    float32 splits still use) stands beside it."""
    import shutil

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.ops import kernel_tiles
    t0 = time.monotonic()
    built = _build.build()
    log(f"[build] {sorted(built) or 'all cached'} in "
        f"{time.monotonic() - t0:.3f} s")
    for name in _build.KERNELS:
        for line in _build.compiler_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    # the BC level kernels keep their accumulators in registers
    spills = [int(b) for b in re.findall(
        r"(\d+) bytes spill (?:stores|loads)",
        _build.compiler_report("bc_level"))]
    if not spills or any(spills):
        raise AssertionError(f"bc_level: spill bytes {spills} in the "
                             f"compiler's report (or no report)")
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"

    def disassemble(name: str) -> str:
        return subprocess.run([cuobjdump, "-sass", str(_build._target(name))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout

    uts_sass = disassemble("uts_hash")
    sha1 = sass_pipes(uts_sass, "uts_hash_kernel")
    if "uts_expand_kernel" not in uts_sass:
        raise AssertionError("uts_expand_kernel missing from the UTS library")
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    sha1["sm_clock_hz"] = float(clock.stdout.split()[0]) * 1e6
    sha1["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"[build] uts_hash_kernel SASS (the SHA-1 body, per lane): "
        f"{sha1['all']} instructions, {sha1['int']} on the INT32 pipe, "
        f"{sha1['fma']} on the FMA pipe; {sha1['sms']} SMs at up to "
        f"{sha1['sm_clock_hz'] / 1e6:.0f} MHz")
    sass = disassemble("flash_attention")
    counts = {op: len(re.findall(rf"\b{op}[.\s]", sass))
              for op in ("HGMMA", "FFMA")}
    tiles = kernel_tiles()
    log(f"[build] flash_attention SASS: {counts['HGMMA']} HGMMA, "
        f"{counts['FFMA']} FFMA instructions; tiles (query rows, keys) "
        f"{tiles}")
    if counts["HGMMA"] == 0:
        raise AssertionError("flash_attention: no HGMMA in its machine code; "
                             "its products are not on the tensor cores")
    return {"flash_sass": counts, "flash_tiles": list(tiles),
            "sha1_sass": sha1, "bc_level_spill_bytes": sum(spills)}


def _hashlib_digest(parent: list, ix: int) -> list:
    msg = b"".join(w.to_bytes(4, "big") for w in parent) + ix.to_bytes(4, "big")
    dig = hashlib.sha1(msg).digest()
    return [int.from_bytes(dig[4 * i:4 * i + 4], "big") for i in range(5)]


def phase_kernel_uts(dev, sha1: dict) -> dict:
    import numpy as np
    import torch
    from repro_torch.kernels.uts_hash.ops import uts_hash_cuda
    from repro_torch.kernels.uts_hash.ref import uts_child_digests_ref

    n = 1 << 20
    rng = np.random.default_rng(11)
    par_u = rng.integers(0, 2**32, size=(5, n), dtype=np.uint32)
    ix_u = rng.integers(0, 64, size=(n,), dtype=np.uint32)
    par = torch.from_numpy(par_u.view(np.int32)).to(dev)
    ix = torch.from_numpy(ix_u.view(np.int32)).to(dev)

    got = uts_hash_cuda(par, ix)
    want = uts_child_digests_ref(par, ix)
    torch.cuda.synchronize()
    got_u = got.cpu().numpy().view(np.uint32)
    want_u = want.cpu().numpy().view(np.uint32)
    err = int(np.abs(got_u.astype(np.int64) - want_u.astype(np.int64)).max())
    if not np.array_equal(got_u, want_u):
        raise AssertionError(
            f"uts_hash: kernel differs from plain version on "
            f"{int((got_u != want_u).any(axis=0).sum())} of {n} lanes")
    for j in rng.choice(n, size=1000, replace=False):
        if _hashlib_digest([int(v) for v in par_u[:, j]], int(ix_u[j])) \
                != [int(v) for v in got_u[:, j]]:
            raise AssertionError(f"uts_hash: lane {j} differs from hashlib")
    ms = cuda_time_ms(lambda: uts_hash_cuda(par, ix))
    plain_ms = cuda_time_ms(lambda: uts_child_digests_ref(par, ix))
    b_ms, b_by = int_bound_ms(n * UTS_BYTES_PER_LANE, n, sha1)
    loose_ms, _ = bound_ms(n * UTS_BYTES_PER_LANE, n * UTS_OPS_PER_LANE)
    log(f"[kernel] uts_hash N={n}: bit-equal to plain version and hashlib "
        f"(1000 lanes); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}; the loose float32-rate bound "
        f"{loose_ms:.4f} ms)")
    return {"name": "uts_hash", "max_abs_err": err, "matched": True,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_loose_ms": loose_ms, "library_ms": None,
            "shape": f"parent [5, {n}] int32, child_ix [{n}] int32"}


def expand_bounds(s0: int, count: int, s_final: int, sha1: dict) -> dict:
    """The least time of one ``uts_expand`` call that expands ``count``
    nodes of a bag of ``s0`` and leaves ``s_final``: it hashes
    ``s_final - s0 + count`` children, reads the bag once and writes the
    leftover once (24 B a node); the integer bound (``int_bound_ms``) and
    the loose float32-rate one.  Beside them, the time the design's own
    stack traffic takes at the memory rate: every expanded node read as a
    parent and every child written, 24 B each."""
    children = s_final - s0 + count
    n_bytes = (s0 + s_final) * UTS_BYTES_PER_NODE
    b_ms, b_by = int_bound_ms(n_bytes, children, sha1)
    loose_ms, _ = bound_ms(n_bytes, children * UTS_OPS_PER_LANE)
    stack_ms = (count + children) * UTS_BYTES_PER_NODE / PEAK_BYTES_S * 1e3
    return {"children": children, "bound_ms": b_ms, "bound_by": b_by,
            "bound_loose_ms": loose_ms, "stack_traffic_ms": stack_ms}


def expand_both(dig, dep, iters: int, capacity=None, **kw) -> dict:
    """One ``uts_expand`` call through the kernel (at ``capacity``) and
    through the plain version (uncapped): bit for bit on the count, the
    leftover digests and depths.  Returns the kernel's result, launches
    and generations."""
    import torch
    from repro_torch.kernels import launches
    from repro_torch.kernels.uts_hash.ops import (expand_generations,
                                                  reset_expand_generations,
                                                  uts_expand)
    before = launches("uts_expand")
    reset_expand_generations()
    got = uts_expand(dig, dep, iters, capacity=capacity, backend="cuda", **kw)
    n_launch = launches("uts_expand") - before
    gens = expand_generations()
    want = uts_expand(dig, dep, iters, backend="ref", **kw)
    torch.cuda.synchronize()
    if got[0] != want[0] or not (torch.equal(got[1], want[1]) and
                                 torch.equal(got[2], want[2])):
        raise AssertionError(
            f"uts_expand ({dep.shape[0]} nodes, budget {iters}, {kw}, "
            f"capacity {capacity}): kernel ({got[0]} nodes, "
            f"{got[2].shape[0]} left) differs from the plain version "
            f"({want[0]}, {want[2].shape[0]})")
    return {"count": got[0], "left": int(got[2].shape[0]),
            "launches": n_launch, "generations": gens, "result": got}


def phase_kernel_uts_expand(dev, sha1: dict) -> dict:
    """``uts_expand`` against its plain version on the card, bit for bit:
    the whole trees of depths 8, 9 and 10 from the root; a 50,000-node
    task (the elastic path's budget) from a depth-14 frontier that the
    plain version has made (10,000 nodes in), at chunk 8192; the same task
    at the least capacity, which must relaunch at least 3 times.  Kernel
    and plain times of the task and of depth 10; then the depth-14 tree
    through the kernel alone (time, generations, time per generation),
    and a bag of leaves, whose generations hash nothing."""
    import torch
    from repro_torch.kernels import launches
    from repro_torch.kernels.uts_hash.ops import (expand_generations,
                                                  reset_expand_generations,
                                                  root_digest, uts_expand)
    root = (root_digest(19, dev), torch.zeros(1, dtype=torch.int32,
                                              device=dev))
    cases = {}
    for depth in (8, 9, 10):
        r = expand_both(*root, 2**62, b0=4.0, max_depth=depth, chunk=8192)
        if r["count"] != UTS_SIZES[depth] or r["left"]:
            raise AssertionError(f"uts_expand depth {depth}: {r['count']} "
                                 f"nodes, {r['left']} left")
        cases[f"depth {depth}"] = r
    task = dict(b0=4.0, max_depth=UTS_DEPTH, chunk=8192)
    _, fdig, fdep = uts_expand(*root, 10_000, backend="ref", **task)
    cases["task"] = expand_both(fdig, fdep, 50_000, **task)
    cases["task, least capacity"] = r = expand_both(fdig, fdep, 50_000,
                                                    capacity=1, **task)
    if r["launches"] < 4:
        raise AssertionError(f"uts_expand at the least capacity: "
                             f"{r['launches']} launches, want >= 4")
    for name, (dig, dep, iters, kw) in {
            "depth 10": (*root, 2**62, dict(b0=4.0, max_depth=10,
                                            chunk=8192)),
            "task": (fdig, fdep, 50_000, task)}.items():
        c = cases[name]
        c["ms"] = cuda_time_ms(lambda: uts_expand(dig, dep, iters,
                                                  backend="cuda", **kw))
        c["plain_ms"] = cuda_time_ms(lambda: uts_expand(
            dig, dep, iters, backend="ref", **kw), reps=3, warmup=1)
        c["us_per_generation"] = c["ms"] * 1e3 / c["generations"]
    for name, c in cases.items():
        c.update(expand_bounds(fdep.shape[0] if name.startswith("task")
                               else 1, c["count"], c["left"], sha1))
        del c["result"]
        log(f"[kernel] uts_expand {name}: bit-equal to the plain version; "
            f"{c['count']} nodes, {c['left']} left, {c['launches']} "
            f"launches, {c['generations']} generations"
            + (f"; kernel {c['ms']:.4f} ms ({c['us_per_generation']:.3f} "
               f"us a generation), plain {c['plain_ms']:.4f} ms"
               if "ms" in c else "")
            + f"; bound {c['bound_ms']:.4f} ms ({c['bound_by']}; loose "
            f"{c['bound_loose_ms']:.4f} ms; stack traffic "
            f"{c['stack_traffic_ms']:.4f} ms)")

    # the depth-14 tree through the kernel alone
    d14 = dict(b0=4.0, max_depth=UTS_DEPTH, chunk=8192)
    before = launches("uts_expand")
    reset_expand_generations()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    count, _, left = uts_expand(*root, 2**62, backend="cuda", **d14)
    end.record()
    end.synchronize()
    if count != UTS_DEPTH14_NODES or left.shape[0]:
        raise AssertionError(f"uts_expand depth {UTS_DEPTH}: {count} nodes")
    tree = {"ms": start.elapsed_time(end),
            "launches": launches("uts_expand") - before,
            "generations": expand_generations(), "nodes": count,
            **expand_bounds(1, count, 0, sha1)}
    tree["us_per_generation"] = tree["ms"] * 1e3 / tree["generations"]
    log(f"[kernel] uts_expand depth {UTS_DEPTH} tree alone: {count} nodes in "
        f"{tree['ms']:.3f} ms, {tree['launches']} launches, "
        f"{tree['generations']} generations, "
        f"{tree['us_per_generation']:.3f} us a generation; bound "
        f"{tree['bound_ms']:.3f} ms ({tree['bound_by']}; loose "
        f"{tree['bound_loose_ms']:.3f} ms; stack traffic "
        f"{tree['stack_traffic_ms']:.3f} ms)")
    # generations with no child: a bag of leaves (depth = max_depth), so
    # each generation is the scan and the grid barrier alone
    n_leaf = 8192 * 512
    leaves = (torch.zeros((5, n_leaf), dtype=torch.int32, device=dev),
              torch.full((n_leaf,), UTS_DEPTH, dtype=torch.int32, device=dev))
    reset_expand_generations()
    count, _, left = uts_expand(*leaves, 2**62, backend="cuda", **d14)
    if count != n_leaf or left.shape[0]:
        raise AssertionError(f"uts_expand on {n_leaf} leaves: {count} nodes, "
                             f"{left.shape[0]} left")
    leaf = {"nodes": n_leaf, "generations": expand_generations(),
            "ms": cuda_time_ms(lambda: uts_expand(*leaves, 2**62,
                                                  backend="cuda", **d14),
                               reps=5, warmup=1)}
    leaf["us_per_generation"] = leaf["ms"] * 1e3 / leaf["generations"]
    log(f"[kernel] uts_expand on {n_leaf} leaves: {leaf['generations']} "
        f"generations without a child in {leaf['ms']:.3f} ms, "
        f"{leaf['us_per_generation']:.3f} us a generation (scan and grid "
        f"barrier; the bag's copy in and one launch included)")
    head = cases["task"]
    return {"name": "uts_expand", "max_abs_err": 0, "matched": True,
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "bound_loose_ms": head["bound_loose_ms"], "library_ms": None,
            "shape": f"a {fdep.shape[0]}-node depth-{UTS_DEPTH} frontier, "
                     f"budget 50,000, chunk 8192",
            "cases": cases, "depth14_tree": tree, "leaf_generations": leaf}


def cycle_exit_run(c_re, c_im, max_iter: int, every: int) -> tuple:
    """A plain PyTorch run of the kernel's schedule: the full iteration,
    plus a comparison of the state with a saved one every ``every``
    iterations, re-saved at iterations ``every * 2**k``, bit for bit.
    Returns ``(dwell, iterations)``: the dwell map this schedule gives
    (the cycle exit's claim is that it is the plain version's), and per
    point the iterations the kernel runs: its dwell if it escapes, the
    iteration at which the schedule proves its orbit periodic, else
    ``max_iter``."""
    import torch
    from repro_torch.kernels.mandelbrot.ref import _fma_f32
    zr = torch.zeros_like(c_re)
    zi = torch.zeros_like(c_im)
    sr, si = zr.clone(), zi.clone()
    dwell = torch.full(c_re.shape, max_iter, dtype=torch.int32,
                       device=c_re.device)
    iters = torch.full(c_re.shape, max_iter, dtype=torch.int64,
                       device=c_re.device)
    live = torch.ones(c_re.shape, dtype=torch.bool, device=c_re.device)
    next_save = every
    for it in range(max_iter):
        zr2, zi2 = zr * zr, zi * zi
        esc = live & ~(zr2 + zi2 <= 4.0)
        dwell[esc] = it
        iters[esc] = it
        live &= ~esc
        if not bool(live.any()):
            break
        new_re = (zr2 - zi2) + c_re
        new_im = _fma_f32(2.0 * zr, zi, c_im)
        zr = torch.where(live, new_re, zr)
        zi = torch.where(live, new_im, zi)
        i = it + 1
        if i % every == 0:
            same = live & (zr.view(torch.int32) == sr.view(torch.int32)) & \
                (zi.view(torch.int32) == si.view(torch.int32))
            iters[same] = i
            live &= ~same
            if i == next_save:
                sr, si = zr.clone(), zi.clone()
                next_save *= 2
    return dwell, iters


def time_in_turns(fns: dict, reps: int = 10) -> dict:
    """CUDA-event medians of each of ``fns``, taken forward and then in
    reverse order (a, b, .., b, a) and averaged, so that a drift of the
    card's clock between the two passes falls on every entry alike."""
    times = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            times[k].append(cuda_time_ms(fns[k], reps=reps))
    return {k: sum(v) / len(v) for k, v in times.items()}


def mandelbrot_builds(c_re, c_im, max_iter: int) -> dict:
    """The kernel as the main path launches it, and its full-iteration
    build (the cycle exit off), for measurement."""
    from repro_torch.kernels.mandelbrot.ops import (
        mandelbrot_cuda, mandelbrot_cuda_full_iteration)
    return {"kernel": lambda: mandelbrot_cuda(c_re, c_im, max_iter=max_iter),
            "full_iteration": lambda: mandelbrot_cuda_full_iteration(
                c_re, c_im, max_iter=max_iter)}


def phase_kernel_mandelbrot(dev) -> dict:
    """At 1024^2 and max_iter 256 over the paper's view: every build
    bit-equal to the plain version, and to the plain run of the kernel's
    schedule, timed in turns.  The bound counts the iterations these
    inputs need under the cycle exit (``cycle_exit_run``); the dwell sum,
    the full iteration's count, stands beside it."""
    import torch
    from repro_torch.kernels.mandelbrot.ops import cycle_check_every
    from repro_torch.kernels.mandelbrot.ref import coords, mandelbrot_ref

    side, max_iter = 1024, 256
    c_re, c_im = coords(-2.0, -1.5, 1.0, 1.5, side, side, device=dev)
    want = mandelbrot_ref(c_re, c_im, max_iter)
    sched, iters = cycle_exit_run(c_re, c_im, max_iter, cycle_check_every())
    builds = mandelbrot_builds(c_re, c_im, max_iter)
    err = 0
    for name, fn in [("schedule", lambda: sched), *builds.items()]:
        got = fn()
        torch.cuda.synchronize()
        diff = int((got != want).sum())
        err = max(err, int((got - want).abs().max()))
        if diff:
            raise AssertionError(
                f"mandelbrot {name}: differs from plain version on {diff} "
                f"of {side * side} points (max |d dwell| {err})")
    times = time_in_turns(builds)
    plain_ms = cuda_time_ms(lambda: mandelbrot_ref(c_re, c_im, max_iter))
    n_bytes = side * side * MS_BYTES_PER_POINT
    needed = int(iters.sum())
    dwell_sum = int(want.sum())
    b_ms, b_by = bound_ms(n_bytes, needed * MS_OPS_PER_ITER)
    full_b_ms, full_b_by = bound_ms(n_bytes, dwell_sum * MS_OPS_PER_ITER)
    log(f"[kernel] mandelbrot {side}x{side} max_iter {max_iter}: every build "
        f"and the plain run of the schedule bit-equal to the plain version; "
        f"iterations needed {needed} (cycle exit), {dwell_sum} (dwell sum); "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
        + f"; plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}), with "
        f"the dwell sum {full_b_ms:.4f} ms ({full_b_by})")
    return {"name": "mandelbrot", "max_abs_err": err, "matched": True,
            "ms": times["kernel"], "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "full_iteration_ms": times["full_iteration"],
            "bound_dwell_sum_ms": full_b_ms,
            "iterations_needed": needed, "dwell_sum": dwell_sum,
            "shape": f"c_re, c_im [{side}, {side}] float32, "
                     f"max_iter {max_iter}"}


def elastic_pool():
    from repro_torch.core import make_pool
    return make_pool("elastic", max_concurrency=16, invoke_overhead=1e-3,
                     invoke_rate_limit=None)


class OperandTap:
    """Keeps a sample of the operands a kernel's CUDA body is given.

    While the tap is open, the registered op's CUDA body is wrapped: every
    launch goes through the real body (which counts it) and then offers
    its padded operands (and static arguments) to a sample of ``k`` per
    ``key``, by default the launch signature (shapes and static
    arguments), so the sample spans the whole run.  The reservoir fills
    in order of arrival, so runs with concurrent workers keep different
    samples.  It holds references, not copies:
    dispatch hands a body freshly padded tensors or the caller's own,
    which nothing writes afterwards.
    """

    def __init__(self, name: str, k: int, seed: int = 0, key=None) -> None:
        import random
        import threading
        self.name, self.k = name, k
        self.key = key or (lambda args, static: (
            tuple(tuple(a.shape) for a in args),
            tuple(sorted(static.items()))))
        self.rng = random.Random(seed)
        self.lock = threading.Lock()
        self.seen: dict = {}
        self.samples: dict = {}

    def __enter__(self) -> "OperandTap":
        import dataclasses
        from repro_torch.kernels.dispatch import get_kernel, register_kernel
        self.op = get_kernel(self.name)
        register_kernel(dataclasses.replace(self.op, cuda_body=self._body))
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch.kernels.dispatch import register_kernel
        register_kernel(self.op)

    def _body(self, *args, **static):
        out = self.op.cuda_body(*args, **static)
        key = self.key(args, static)
        with self.lock:
            seen = self.seen[key] = self.seen.get(key, 0) + 1
            kept = self.samples.setdefault(key, [])
            if len(kept) < self.k:
                kept.append((args, static))
            else:
                j = self.rng.randrange(seen)
                if j < self.k:
                    kept[j] = (args, static)
        return out


def run_path(name: str, kernel: str, fn, required: bool = True) -> tuple:
    """Drive one main path with the launch counts set to 0 just before it
    and read just after; returns ``(result, seconds, launches of kernel)``.
    Fails if ``kernel`` did not launch, unless the path is not ``required``
    to run it (decoding and serving run no hand kernel yet)."""
    import torch
    from repro_torch.kernels import launches, reset_launches
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n = launches(kernel)
    if required and n <= 0:
        raise AssertionError(f"{name}: {kernel} not launched on this path")
    return out, wall, n


def uts_tap_key(args, static) -> tuple:
    """A ``uts_expand`` call's sample key: its bag size and its budget,
    each to the next power of two, and its other static arguments."""
    from repro_torch.kernels.dispatch import bucket
    return (bucket(args[1].shape[0], 1), bucket(static["iters"], 1),
            tuple(sorted((k, v) for k, v in static.items() if k != "iters")))


def check_uts_samples(tap: OperandTap) -> dict:
    """Every sampled ``uts_expand`` call of the main path, again through
    the kernel and through its plain version on the card: bit-equal
    (``expand_both``), with its budget cut to ``UTS_REPLAY_ITERS``."""
    nodes, replayed = 0, 0
    for key, kept in sorted(tap.samples.items()):
        for (dig, dep), static in kept:
            kw = {k: v for k, v in static.items()
                  if k not in ("iters", "capacity")}
            iters = min(static["iters"], UTS_REPLAY_ITERS)
            replayed += iters < static["iters"]
            nodes += expand_both(dig, dep, iters, capacity=static["capacity"],
                                 **kw)["count"]
    n = sum(len(v) for v in tap.samples.values())
    calls = sum(tap.seen.values())
    log(f"[uts] {n} sampled main-path uts_expand calls of {calls} "
        f"({len(tap.samples)} keys of bag size and budget; {replayed} "
        f"replayed with the budget cut to {UTS_REPLAY_ITERS}; {nodes} nodes) "
        f"bit-equal to the plain version")
    return {"samples": n, "nodes": nodes, "cut_to_replay_budget": replayed,
            "calls_by_key": {str(k[:2]): c for k, c in
                             sorted(tap.seen.items())}}


def duration_stats(ms: list) -> dict:
    """Count, count over MS_LONG_MS, p50, p99 and max of launch times."""
    import numpy as np
    a = np.asarray(ms, dtype=np.float64)
    if a.size == 0:
        return {"count": 0}
    return {"count": int(a.size), "over_1ms": int((a > MS_LONG_MS).sum()),
            "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)), "max_ms": float(a.max()),
            "sum_ms": float(a.sum())}


def check_mandelbrot_samples(tap: OperandTap, cap: int) -> dict:
    """Every sampled ``mandelbrot`` launch of the main path, again through
    the kernel and through its plain version on the card: bit-equal.

    The plain dwell syncs with the host once per iteration and stops when
    every point has escaped, so it cannot run an in-set point's 5,000,000
    iterations.  A sample whose points all escape within ``cap``
    iterations is compared at the main path's own ``max_iter``; any other
    (it reaches the set, or escapes late) is compared at ``max_iter`` =
    ``cap``, and at its own ``max_iter`` with the full-iteration build,
    bit for bit, which checks the cycle exit where the plain version
    cannot go.  The kernel runs each sample at its own shape; the plain
    version, elementwise, runs one row of every sample of a class.
    """
    import torch
    from repro_torch.kernels.mandelbrot.ops import (
        mandelbrot, mandelbrot_cuda_full_iteration)
    classes: dict = {}
    n_full, n_in_set = 0, 0
    for (shapes, static), kept in sorted(tap.samples.items()):
        max_iter = dict(static)["max_iter"]
        for (c_re, c_im), _ in kept:
            got = mandelbrot(c_re, c_im, max_iter, backend="cuda")
            top = int(got.max())
            n_in_set += top == max_iter
            it = max_iter if max_iter <= cap or top < cap else cap
            if it != max_iter:
                full = mandelbrot_cuda_full_iteration(c_re, c_im,
                                                      max_iter=max_iter)
                if not torch.equal(got, full):
                    raise AssertionError(
                        f"mandelbrot at main-path shape {shapes}, max_iter "
                        f"{max_iter}: kernel differs from its full-iteration "
                        f"build on {int((got != full).sum())} points")
                got = mandelbrot(c_re, c_im, it, backend="cuda")
                n_full += 1
            cls = classes.setdefault(it, ([], [], [], []))
            for lst, t in zip(cls, (c_re, c_im, got)):
                lst.append(t.reshape(-1))
            cls[3].append(shapes[0])
    out = {}
    for it, (res, ims, gots, shapes) in sorted(classes.items()):
        got = torch.cat(gots)
        want = mandelbrot(torch.cat(res)[None], torch.cat(ims)[None], it,
                          backend="ref")[0]
        diff = int((got != want).sum())
        if diff:
            raise AssertionError(
                f"mandelbrot at main-path shapes, max_iter {it}: kernel "
                f"differs from plain version on {diff} of {got.numel()} "
                f"points (max |d dwell| {int((got - want).abs().max())})")
        out[str(it)] = {"samples": len(shapes), "points": got.numel(),
                        "max_dwell_seen": int(got.max()),
                        "shapes": sorted({str(s) for s in shapes})}
        log(f"[ms] {len(shapes)} sampled main-path launches at max_iter "
            f"{it} ({got.numel()} points, shapes {out[str(it)]['shapes']}) "
            f"bit-equal to the plain version")
    if not n_in_set:
        raise AssertionError("no sampled main-path launch reaches the set")
    log(f"[ms] {n_full} sampled launches that reach max_iter {cap} also "
        f"bit-equal to the full-iteration build at their own max_iter")
    return out


def border_strip(rect: tuple, p, dev) -> tuple:
    """The operands the main path hands the kernel for ``rect``'s border:
    its border coordinates as ``evaluate_rect`` takes them, one [1, n]
    row, padded as dispatch pads it."""
    import torch
    from repro_torch.algorithms.mariani_silver import Rect, _border_coords
    from repro_torch.kernels.dispatch import bucket, get_kernel
    op = get_kernel("mandelbrot")
    planes = []
    for a, pad in zip(_border_coords(Rect(*rect), p), op.pad_values):
        plane = torch.full((bucket(1, op.bucket_floor),
                            bucket(a.size, op.bucket_floor)), pad,
                           dtype=torch.float32, device=dev)
        plane[0, :a.size] = torch.from_numpy(a)
        planes.append(plane)
    return tuple(planes)


def time_border_strips(dwells, p, rects: list, dev, cap: int,
                       clock_hz: float) -> dict:
    """Main-path border strips timed alone through the kernel and its
    full-iteration build, sampled by rectangle: of the rectangles the run
    evaluates (``mariani_silver_over``), a seeded choice of
    ``MS_TIMED_IN_SET`` whose border reaches the set and
    ``MS_TIMED_OTHER`` others, so that every run times the same strips.
    Each strip's dwells must equal the naive render's on its border, and
    the two builds' must agree; the in-set strips carry their bounds
    (``in_set_bounds``)."""
    import statistics as st

    import numpy as np
    import torch

    def border(x0, y0, x1, y1, _):
        sub = dwells[y0:y1, x0:x1]
        return np.concatenate([sub[0], sub[-1], sub[1:-1, 0],
                               sub[1:-1, -1]])

    reach = [border(*r).max() == p.max_dwell for r in rects]
    rng = np.random.default_rng(14)
    picked = {}
    for want, k in ((True, MS_TIMED_IN_SET), (False, MS_TIMED_OTHER)):
        pool = [r for r, hit in zip(rects, reach) if hit == want]
        picked[want] = [pool[i] for i in sorted(rng.choice(
            len(pool), min(k, len(pool)), replace=False))]
    timed = {"kernel": [], "full_iteration": []}
    in_set = {"kernel": [], "full_iteration": []}
    in_set_planes = []
    for hit, chosen in picked.items():
        for rect in chosen:
            c_re, c_im = border_strip(rect, p, dev)
            builds = mandelbrot_builds(c_re, c_im, p.max_dwell)
            got = {k: fn() for k, fn in builds.items()}
            want = torch.from_numpy(border(*rect)).to(dev)
            n = want.shape[0]
            if not (torch.equal(got["kernel"][0, :n], want) and
                    torch.equal(got["full_iteration"], got["kernel"])):
                raise AssertionError(f"mandelbrot, the border of {rect}: "
                                     f"dwells differ from the naive render "
                                     f"or between the builds")
            for name, fn in builds.items():
                t = cuda_time_ms(fn, reps=3, warmup=1)
                timed[name].append(t)
                if hit:
                    in_set[name].append(t)
            if hit:
                in_set_planes.append((c_re, c_im, got["kernel"]))
    if not in_set["kernel"]:
        raise AssertionError("no main-path border strip reaches the set")
    med = {k: st.median(v) for k, v in in_set.items()}
    bounds = in_set_bounds(in_set_planes, cap, clock_hz)
    med_bound = {k: st.median(v) for k, v in bounds.items()}
    out = {"launch_ms": {k: duration_stats(v) for k, v in timed.items()},
           "in_set": {"samples": len(in_set["kernel"]),
                      "rects": [list(map(int, r)) for r in picked[True]],
                      "median_ms": med, "speedup": med["full_iteration"] /
                      med["kernel"], "median_bound_ms": med_bound,
                      "kernel_ms": in_set["kernel"],
                      "full_iteration_ms": in_set["full_iteration"],
                      "bound_ms": bounds}}
    for k, v in out["launch_ms"].items():
        log(f"[ms] {len(timed[k])} main-path border strips sampled by "
            f"rectangle, each alone, {k}: {v}")
    log(f"[ms] {len(in_set['kernel'])} in-set border strips: median "
        f"kernel {med['kernel']:.4f} ms, full iteration "
        f"{med['full_iteration']:.4f} ms ({out['in_set']['speedup']:.1f}x); "
        f"median bound {med_bound['kernel']:.5f} ms (cycle exit, to "
        f"{cap}), {med_bound['full_iteration']:.5f} ms (dwell sum); median "
        f"latency bound {med_bound['kernel_latency']:.5f} ms (the slowest "
        f"orbit's iterations under the cycle exit, to {cap}), "
        f"{med_bound['full_iteration_latency']:.5f} ms (its dwell)")
    return out


def in_set_bounds(planes: list, cap: int, clock_hz: float) -> dict:
    """The bounds of each in-set sample (its padded plane and its dwells
    at the main path's max_iter) for both builds.  The throughput bound:
    12 bytes a point against 8 operations an iteration, counting for the
    full iteration every dwell, and for the kernel what a plain run of its
    schedule to ``cap`` needs (points still running at ``cap`` counted at
    ``cap``, so this bound is lower still than the kernel's work).  The
    latency bound (``*_latency``): the iterations of the sample's slowest
    point, counted the same way, times ``MS_CHAIN_CYCLES`` at the card's
    top SM clock."""
    import torch
    from repro_torch.kernels.mandelbrot.ops import cycle_check_every
    res = torch.cat([p[0].reshape(-1) for p in planes])[None]
    ims = torch.cat([p[1].reshape(-1) for p in planes])[None]
    _, iters = cycle_exit_run(res, ims, cap, cycle_check_every())
    out = {"kernel": [], "full_iteration": [], "kernel_latency": [],
           "full_iteration_latency": []}
    off = 0
    for _, _, dwell in planes:
        n = dwell.numel()
        mine = iters[0, off:off + n]
        out["kernel"].append(bound_ms(n * MS_BYTES_PER_POINT, int(
            mine.sum()) * MS_OPS_PER_ITER)[0])
        out["full_iteration"].append(bound_ms(n * MS_BYTES_PER_POINT, int(
            dwell.to(torch.int64).sum()) * MS_OPS_PER_ITER)[0])
        for k, it in (("kernel_latency", mine), ("full_iteration_latency",
                                                 dwell)):
            out[k].append(int(it.max()) * MS_CHAIN_CYCLES / clock_hz * 1e3)
        off += n
    return out


def device_timeline(fn, kernel: str = "dwell_") -> tuple:
    """Run ``fn`` once under ``torch.profiler`` (device activity only, so
    the host's own pace is disturbed least) and read the device's
    timeline: its idle share of the wall time (the union of every kernel,
    copy and fill, so that work on concurrent streams counts once), the
    durations of every launch of the kernel whose name holds ``kernel``
    (``mandelbrot``'s by default), and the share of the wall time during
    which at least one launch longer than ``MS_LONG_MS`` ran; and the
    durations by kernel name.  Returns ``(fn's result, the record)``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def union_us(spans) -> float:
        total, end = 0.0, float("-inf")
        for a, b in sorted(spans):
            if b > end:
                total += b - max(a, end)
                end = b
        return total

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        out = fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    # the profiler's raw device records: building its per-event objects
    # and their tree would take about a minute for one run's ~10^5 records
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    spans = [(e.start_ns() / 1e3, e.end_ns() / 1e3) for e in events]
    dwell = [s for s, e in zip(spans, events) if kernel in e.name()]
    long = [(a, b) for a, b in dwell if b - a > MS_LONG_MS * 1e3]
    by_name: dict = {}
    for (a, b), e in zip(spans, events):
        m = re.search(rf"\w*{re.escape(kernel)}\w*", e.name())
        if m:
            by_name.setdefault(m.group(0), []).append((b - a) / 1e3)
    wall_us = wall * 1e6
    rec = {"wall_s": wall, "device_ops": len(spans),
           "busy_s": union_us(spans) / 1e6,
           "idle_share": 1 - union_us(spans) / wall_us,
           "launches": duration_stats([(b - a) / 1e3 for a, b in dwell]),
           "by_name": {k: duration_stats(v) for k, v in by_name.items()},
           "long_launch_union_s": union_us(long) / 1e6,
           "long_launch_share": union_us(long) / wall_us}
    if not dwell:
        raise AssertionError(f"the profiler saw no {kernel} launch")
    return out, rec


def phase_uts(dev, depth: int) -> dict:
    from repro_torch.algorithms import UTSParams, uts_sequential, uts_spec
    from repro_torch.core import run_irregular
    from repro_torch.kernels import launches
    from repro_torch.kernels.uts_hash.ops import (expand_generations,
                                                  reset_expand_generations)

    for d, want in UTS_SIZES.items():
        got = uts_sequential(UTSParams(seed=19, b0=4.0, max_depth=d),
                             device=dev)
        if got != want:
            raise AssertionError(f"UTS depth {d}: {got} nodes, want {want}")
    log(f"[uts] depths 4..10 equal the published sizes "
        f"{list(UTS_SIZES.values())}")

    params = UTSParams(seed=19, b0=4.0, max_depth=depth)

    def elastic(batching: bool):
        def go():
            with elastic_pool() as pool:
                r = run_irregular(pool, uts_spec(params, device=dev),
                                  batching=batching)
            return r.output, r.tasks
        return go

    paths = {"sequential": lambda: (uts_sequential(params, device=dev), 1),
             "elastic batching=False": elastic(False),
             "elastic batching=True": elastic(True)}
    runs = {}
    with OperandTap("uts_expand", k=UTS_SAMPLES_PER_KEY,
                    key=uts_tap_key) as tap:
        for name, fn in paths.items():
            calls0 = sum(tap.seen.values())
            reset_expand_generations()
            (count, tasks), wall, n = run_path(f"UTS {name}", "uts_expand",
                                               fn)
            n_hash = launches("uts_hash")
            calls = sum(tap.seen.values()) - calls0
            gens = expand_generations()
            runs[name] = {"nodes": count, "seconds": wall, "tasks": tasks,
                          "nodes_per_s": count / wall, "launches": n,
                          "calls": calls, "relaunches": n - calls,
                          "generations": gens,
                          "uts_hash_launches": n_hash}
            log(f"[uts] depth {depth} {name}: {count} nodes, {tasks} tasks, "
                f"{wall:.3f} s, {count / wall:.1f} nodes/s; {calls} "
                f"uts_expand calls, {n} launches ({n - calls} relaunches), "
                f"{gens} generations ({wall * 1e6 / gens:.3f} us of wall "
                f"time a generation); {n_hash} uts_hash launches")
            if n_hash < 1:
                raise AssertionError(f"UTS {name}: uts_hash not launched")
            if calls > tasks:
                raise AssertionError(f"UTS {name}: {calls} uts_expand calls "
                                     f"for {tasks} tasks")
    if runs["sequential"]["launches"] > 5:
        raise AssertionError(f"UTS sequential: "
                             f"{runs['sequential']['launches']} uts_expand "
                             f"launches, want at most 5")
    counts = {r["nodes"] for r in runs.values()}
    if len(counts) != 1:
        raise AssertionError(f"UTS depth {depth}: counts disagree {runs}")
    samples = check_uts_samples(tap)
    # where the time of an elastic run goes: once more (batching off),
    # under the profiler, outside the counted runs above
    (count, tasks), prof = device_timeline(elastic(False), "uts_expand")
    if count != UTS_DEPTH14_NODES:
        raise AssertionError(f"UTS profiled run: {count} nodes")
    log(f"[uts] profiled elastic run (batching off): {prof['wall_s']:.3f} s "
        f"wall, {tasks} tasks, {prof['device_ops']} device operations, busy "
        f"{prof['busy_s']:.3f} s, idle share {prof['idle_share']:.4f}; "
        f"uts_expand launches {prof['launches']}")
    return {"launches": {k: r["launches"] for k, r in runs.items()},
            "uts_hash_launches": {k: r["uts_hash_launches"]
                                  for k, r in runs.items()},
            "nodes": counts.pop(), "runs": runs, "samples": samples,
            "profile": prof}


def mariani_silver_over(dwells, p):
    """Mariani-Silver applied to a finished dwell map, on the host.

    An independent statement of the algorithm's semantics: the same seed
    grid, border test (top row, bottom row, left and right columns), fill,
    split and leaf rule as ``ms_spec``, with every dwell read from
    ``dwells`` (the naive render) instead of computed.  ``ms_spec`` driven
    by ``run_irregular`` must reproduce it pixel for pixel.  Where a dwell
    band is thinner than a pixel, a rectangle's border can miss it and the
    fill paints over it, so this image may differ from ``dwells``; those
    pixels are the algorithm's, not an error of the port.  Returns the
    image and the rectangles evaluated, ``(x0, y0, x1, y1, depth)`` (one
    a task).
    """
    import numpy as np

    out = np.zeros_like(dwells)
    sd = p.initial_subdivision
    xs = np.linspace(0, p.width, sd + 1).astype(int)
    ys = np.linspace(0, p.height, sd + 1).astype(int)
    todo = [(xs[j], ys[i], xs[j + 1], ys[i + 1], 0)
            for i in range(sd) for j in range(sd)]
    rects = []
    while todo:
        rects.extend(todo)
        nxt = []
        for x0, y0, x1, y1, depth in todo:
            sub = dwells[y0:y1, x0:x1]
            border = np.concatenate([sub[0], sub[-1], sub[1:-1, 0],
                                     sub[1:-1, -1]])
            if border.size and np.all(border == border[0]):
                out[y0:y1, x0:x1] = border[0]
            elif depth >= p.max_depth or x1 - x0 <= 2 or y1 - y0 <= 2:
                out[y0:y1, x0:x1] = sub
            else:
                cx = np.linspace(x0, x1, p.split + 1).astype(int)
                cy = np.linspace(y0, y1, p.split + 1).astype(int)
                nxt.extend((cx[j], cy[i], cx[j + 1], cy[i + 1], depth + 1)
                           for i in range(p.split) for j in range(p.split)
                           if cx[j + 1] > cx[j] and cy[i + 1] > cy[i])
        todo = nxt
    return out, rects


def ms_params(side: int, max_dwell: int):
    """The paper's ``MS_PAPER_SD64`` cut to ``side`` x ``side`` pixels with
    the same 64-pixel seed rectangles (sd = side / 64), depth 5, split 2."""
    import dataclasses

    from repro_torch.configs.paper_workloads import MS_PAPER_SD64

    if side % 64:
        raise ValueError(f"--ms-side must be a multiple of 64, got {side}")
    return dataclasses.replace(MS_PAPER_SD64, width=side, height=side,
                               initial_subdivision=side // 64,
                               max_dwell=max_dwell)


def phase_ms(dev, side: int, max_dwell: int, clock_hz: float) -> dict:
    import numpy as np
    import torch
    from repro_torch.algorithms import ms_spec, naive_render
    from repro_torch.core import run_irregular

    p = ms_params(side, max_dwell)

    def elastic(batching: bool):
        def go():
            with elastic_pool() as pool:
                return run_irregular(pool, ms_spec(p, device=dev),
                                     batching=batching)
        return go

    runs, images = {}, {}
    with OperandTap("mandelbrot", k=MS_SAMPLES_PER_SHAPE) as tap:
        for batching in (False, True):
            name = f"elastic batching={batching}"
            r, wall, n = run_path(f"MS {name}", "mandelbrot",
                                  elastic(batching))
            images[name] = r.output["image"]
            runs[name] = {"seconds": wall, "tasks": r.tasks,
                          "mp_per_s": p.width * p.height / wall / 1e6,
                          "filled": int(r.output["filled"]),
                          "evaluated": int(r.output["evaluated"]),
                          "launches": n}
            log(f"[ms] {p.width}x{p.height} sd {p.initial_subdivision} "
                f"depth {p.max_depth} max_dwell {max_dwell} {name}: "
                f"{r.tasks} tasks, {wall:.3f} s, "
                f"{runs[name]['mp_per_s']:.4f} MP/s, filled "
                f"{r.output['filled']}, evaluated {r.output['evaluated']}, "
                f"{n} mandelbrot launches")
    samples = check_mandelbrot_samples(tap, MS_SAMPLE_CAP)
    # where the time of one run goes: the same run once more (batching
    # off), under the profiler, outside the counted runs above
    r, prof = device_timeline(elastic(False))
    images["profiled"] = r.output["image"]
    log(f"[ms] profiled run (batching off): {prof['wall_s']:.3f} s wall, "
        f"{prof['device_ops']} device operations, busy {prof['busy_s']:.3f} "
        f"s, idle share {prof['idle_share']:.4f}; mandelbrot launches "
        f"{prof['launches']}; launches over {MS_LONG_MS} ms run during "
        f"{prof['long_launch_union_s']:.3f} s ({prof['long_launch_share']:.4f}"
        f" of the wall time)")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    oracle = naive_render(p, device=dev)
    naive_s = time.monotonic() - t0
    expected, rects = mariani_silver_over(oracle, p)
    tasks = len(rects)
    sampled = int((expected != oracle).sum())
    log(f"[ms] naive_render: {naive_s:.3f} s, "
        f"{int(oracle.astype(np.int64).sum())} iterations; Mariani-Silver "
        f"over it: {tasks} tasks, {sampled} pixels filled with another "
        f"dwell than theirs")
    for name, img in images.items():
        if img.shape != expected.shape or not np.array_equal(img, expected):
            raise AssertionError(
                f"MS {name}: image differs from Mariani-Silver over "
                f"naive_render on {int((img != expected).sum())} pixels")
    log(f"[ms] both images equal Mariani-Silver over naive_render (and "
        f"naive_render itself on all but those {sampled} pixels)")
    samples.update(time_border_strips(oracle, p, rects, dev, MS_SAMPLE_CAP,
                                      clock_hz))
    return {"launches": {k: r["launches"] for k, r in runs.items()},
            "side": side, "max_dwell": max_dwell,
            "naive_render_s": naive_s, "pixels_off_naive": sampled,
            "reference_tasks": tasks, "runs": runs, "samples": samples,
            "profile": prof}


def phase_ms_paper_size(dev) -> dict:
    """What the paper's full ``MS_PAPER_SD64`` run would be: its dwell map
    by ``naive_render`` on the card, and the tasks Mariani-Silver over it
    dispatches, which is why phase 5 runs a smaller image.  Then the same
    plane's coordinates through every build of the kernel once (CUDA
    events; the full iteration takes seconds), each dwell map bit-equal
    to the render's."""
    import numpy as np
    import torch
    from repro_torch.algorithms import naive_render
    from repro_torch.algorithms.mariani_silver import Rect, _pixel_coords
    from repro_torch.configs.paper_workloads import MS_PAPER_SD64

    p = MS_PAPER_SD64
    torch.cuda.synchronize()
    t0 = time.monotonic()
    dwells = naive_render(p, device=dev)
    naive_s = time.monotonic() - t0
    image, rects = mariani_silver_over(dwells, p)
    tasks = len(rects)
    sampled = int((image != dwells).sum())
    log(f"[ms] paper size {p.width}x{p.height} sd {p.initial_subdivision} "
        f"max_dwell {p.max_dwell}: naive_render {naive_s:.3f} s, "
        f"{int(dwells.astype(np.int64).sum())} iterations; Mariani-Silver "
        f"over it: {tasks} tasks, {sampled} pixels filled with another "
        f"dwell than theirs")
    c_re, c_im = (torch.from_numpy(a).to(dev) for a in _pixel_coords(
        Rect(0, 0, p.width, p.height, 0), p))
    want = torch.from_numpy(dwells).to(dev)
    builds_ms = {}
    for name, fn in mandelbrot_builds(c_re, c_im, p.max_dwell).items():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        got = fn()
        end.record()
        end.synchronize()
        builds_ms[name] = start.elapsed_time(end)
        if not torch.equal(got, want):
            raise AssertionError(
                f"mandelbrot {name} at paper size differs from naive_render "
                f"on {int((got != want).sum())} points")
    log(f"[ms] paper size, kernel alone: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in builds_ms.items()))
    return {"naive_render_s": naive_s, "tasks": tasks,
            "pixels_off_naive": sampled, "builds_ms": builds_ms}


# -- betweenness centrality at the paper's scale 17 ------------------------------

#: fixed shapes of the level kernels: (R-MAT scale, sources); the first is
#: a task of BC_SCALED (its graph, 8 sources: S' = 32, one word a vertex),
#: the last a main-path task's (the paper graph, one 1,024-source block)
BC_FIXED = ((8, 8), (12, 256), (17, 64), (17, 1024))
#: sources of the paper graph held against the host's Brandes, in workers
BC_ORACLE_SOURCES = 8
BC_ORACLE_WORKERS = 4
#: main-path tasks replayed through the plain version
BC_REPLAY_TASKS = 3
#: threads of the local pool of the fused run: it fuses up to this many
#: queued blocks into one ``execute_batch`` call (``run_irregular``)
BC_LOCAL_WIDTH = 4
#: the reference package's tolerances (tests/test_betweenness.py)
BC_RTOL, BC_ATOL = 1e-4, 1e-3
#: spin (GPU clock cycles, about 0.5 ms) queued before each timed level,
#: so that its start event waits on the card and not on the host's
#: launch path
BC_SPIN_CYCLES = 1_000_000


def rmat_edges(scale: int, edge_factor: int, a: float, b: float, c: float,
               seed: int) -> tuple:
    """The R-MAT digraph's edge set, sampled on the host with the
    reference's draws in the reference's order, independently of the
    port: ``(n, keys)``, keys the sorted distinct ``src * n + dst``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    n = 1 << scale
    m = edge_factor * n
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for _ in range(scale):
        r = rng.rand(m)
        q_b = (r >= a) & (r < a + b)
        q_c = (r >= a + b) & (r < a + b + c)
        q_d = r >= a + b + c
        src = 2 * src + (q_c | q_d)
        dst = 2 * dst + (q_b | q_d)
    keep = src != dst
    perm = rng.permutation(n)
    return n, np.unique(perm[src[keep]] * n + perm[dst[keep]])


def brandes_host(n: int, indptr: list, indices: list, s: int) -> list:
    """Brandes' dependencies of source ``s`` on every vertex, queue-based,
    in float64 (0 at ``s`` itself), over Python lists of a CSR."""
    from collections import deque
    sigma = [0.0] * n
    dist = [-1] * n
    sigma[s], dist[s] = 1.0, 0
    order, queue = [], deque([s])
    while queue:
        v = queue.popleft()
        order.append(v)
        dv, sv = dist[v] + 1, sigma[v]
        for w in indices[indptr[v]:indptr[v + 1]]:
            if dist[w] < 0:
                dist[w] = dv
                queue.append(w)
            if dist[w] == dv:
                sigma[w] += sv
    delta = [0.0] * n
    for v in reversed(order):
        dv, acc = dist[v] + 1, 0.0
        for w in indices[indptr[v]:indptr[v + 1]]:
            if dist[w] == dv:
                acc += (1.0 + delta[w]) / sigma[w]
        delta[v] = sigma[v] * acc
    delta[s] = 0.0
    return delta


def bc_oracle(rmat: tuple, sources: list) -> dict:
    """Runs in a worker process, with nothing of the port: the graph from
    ``rmat_edges``, Brandes from each source (``brandes_host``), and
    scipy's BFS distances.  Returns the summed dependencies, and per
    source the dependency sum beside the distance identity's side,
    sum over reached t != s of (d(s, t) - 1); and a digest of the edge
    set."""
    import numpy as np
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path
    n, keys = rmat_edges(*rmat)
    src, dst = keys // n, keys % n
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(src, minlength=n), out=indptr[1:])
    ip, ix = indptr.tolist(), dst.tolist()
    adj = csr_matrix((np.ones(keys.size), (src, dst)), shape=(n, n))
    dists = shortest_path(adj, directed=True, unweighted=True,
                          indices=sources)
    total = np.zeros(n)
    per = []
    for s, d in zip(sources, dists):
        delta = np.asarray(brandes_host(n, ip, ix, s))
        total += delta
        reached = np.isfinite(d)
        reached[s] = False
        per.append({"source": s, "oracle_delta_sum": float(delta.sum()),
                    "distance_identity": float((d[reached] - 1).sum()),
                    "reached": int(reached.sum()),
                    "depth": int(d[np.isfinite(d)].max())})
    return {"delta": total, "per_source": per,
            "edges_sha1": hashlib.sha1(keys.tobytes()).hexdigest()}


class BCTwinLevels:
    """Level steps for ``bc_batch(steps=...)``: each level runs through
    the kernel and, on a twin state, through the plain version, the whole
    state held bit for bit: ``sigma``, ``visited`` and the next level's
    ``on``, ``base`` and live words forward; ``delta`` and ``coeff``
    backward (``delta`` of the level below poisoned before both launches:
    it is written, not read).  Per level it records what the bound needs: the
    pairs the level must read and write (frontier and joined forward; on
    the level and a level below backward), the additions its sums make
    (every edge of a frontier pair forward, of a level pair backward: an
    upper count), and ``torch.sparse.mm`` of the CSR adjacency with the
    level's masked operand (the library yardstick of the product alone:
    the port never calls it)."""

    def __init__(self, g):
        import torch

        def adjacency(indptr, indices):
            return torch.sparse_csr_tensor(
                indptr.long(), indices.long(),
                torch.ones(g.n_edges, device=indptr.device), size=(g.n, g.n),
                check_invariants=False)
        self.a_in = adjacency(g.in_indptr, g.in_indices)
        self.a_out = adjacency(g.out_indptr, g.out_indices)
        self.out_deg = (g.out_indptr[1:] - g.out_indptr[:-1]).double()
        self.in_deg = (g.in_indptr[1:] - g.in_indptr[:-1]).double()
        self.fwd, self.bwd = [], []

    @staticmethod
    def _hold(what: str, level: int, names: tuple, got: tuple,
              want: tuple) -> None:
        import torch
        torch.cuda.synchronize()
        diff = {k: int((a != b).sum()) for k, a, b in zip(names, got, want)}
        if any(diff.values()):
            raise AssertionError(
                f"{what} {level} ({got[0].shape[0]} vertices): kernel "
                f"differs from the plain version on " + ", ".join(
                    f"{v} {k}" for k, v in diff.items() if v))

    def forward(self, indptr, indices, sigma, visited, on, base, live, level,
                *, backend=None):
        import torch
        from repro_torch.kernels.bc.ops import (bc_forward_level,
                                                level_values, unpack_bits)
        if level == 0:
            self.twin = [t.clone() for t in (sigma, visited)]
            self.on, self.base, self.back = [on.clone()], [base.clone()], None
        front = unpack_bits(on, sigma.shape[1])
        x = level_values(sigma, front, base)
        rec = {"level": level, "frontier": int(front.sum()),
               "ops": float(front.sum(dim=1).double() @ self.out_deg),
               "library_ms": cuda_time_ms(lambda: torch.sparse.mm(self.a_in,
                                                                   x))}
        del front, x
        got = bc_forward_level(indptr, indices, sigma, visited, on, base,
                               live, level, backend="cuda")
        want = bc_forward_level(indptr, indices, *self.twin, self.on[level],
                                self.base[level], live, level, backend="ref")
        self._hold("bc_forward_level", level,
                   ("on", "base", "live", "sigma", "visited"),
                   (*got, sigma, visited), (*want, *self.twin))
        self.on.append(want[0])
        self.base.append(want[1])
        rec.update(joined=int(unpack_bits(got[0], sigma.shape[1]).sum()),
                   live_sources=int(unpack_bits(got[2], sigma.shape[1])
                                    .sum()))
        self.fwd.append(rec)
        return got

    def backward(self, indptr, indices, sigma, delta, coeff, on, on_below,
                 base, base_below, level, *, backend=None):
        import torch
        from repro_torch.kernels.bc.ops import (bc_backward_level,
                                                level_values, unpack_bits)
        if self.back is None:
            self.back = [delta.clone(), coeff.clone()]
        here = unpack_bits(on, sigma.shape[1])
        sig = level_values(sigma, here, base)
        c = torch.where(here, (1.0 + delta) /
                        torch.where(sig > 0, sig, 1.0), 0.0)
        n_on = here.sum(dim=1).double()
        rec = {"level": level, "on_level": int(n_on.sum()),
               "updated": int(unpack_bits(on_below, sigma.shape[1]).sum()),
               "ops": float(n_on @ self.in_deg + 2 * n_on.sum()),
               "library_ms": cuda_time_ms(lambda: torch.sparse.mm(self.a_out,
                                                                   c))}
        del here, sig, c
        below = unpack_bits(on_below, sigma.shape[1])
        delta[below] = 7.0
        self.back[0][below] = 7.0
        del below
        bc_backward_level(indptr, indices, sigma, delta, coeff, on, on_below,
                          base, base_below, level, backend="cuda")
        bc_backward_level(indptr, indices, sigma, *self.back, self.on[level],
                          self.on[level - 1], self.base[level],
                          self.base[level - 1], level, backend="ref")
        self._hold("bc_backward_level", level, ("delta", "coeff"),
                   (delta, coeff), tuple(self.back))
        self.bwd.append(rec)
        return delta


class BCTimedLevels:
    """Level steps for ``bc_batch(steps=...)`` that run each level as
    asked, behind a spin and between two CUDA events, so that its start
    waits on the card and not on the host's launch path."""

    def __init__(self):
        self.fwd, self.bwd = [], []

    @staticmethod
    def _timed(spans: list, step, *args, **kw):
        import torch
        torch.cuda._sleep(BC_SPIN_CYCLES)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = step(*args, **kw)
        b.record()
        spans.append((a, b))
        return out

    def forward(self, *args, **kw):
        from repro_torch.kernels.bc.ops import bc_forward_level
        return self._timed(self.fwd, bc_forward_level, *args, **kw)

    def backward(self, *args, **kw):
        from repro_torch.kernels.bc.ops import bc_backward_level
        return self._timed(self.bwd, bc_backward_level, *args, **kw)

    def ms(self) -> tuple:
        import torch
        torch.cuda.synchronize()
        return tuple([a.elapsed_time(b) for a, b in spans]
                     for spans in (self.fwd, self.bwd))


def bc_sweep_times(g, src, backend: str, reps: int) -> tuple:
    """Per-level CUDA-event medians of ``reps`` sweeps of ``bc_batch``
    through ``backend`` (forward levels, then backward levels in the
    order they run)."""
    from repro_torch.algorithms import bc_batch
    fwd, bwd = [], []
    for _ in range(reps):
        t = BCTimedLevels()
        bc_batch(g, src, backend=backend, steps=(t.forward, t.backward))
        f, b = t.ms()
        fwd.append(f)
        bwd.append(b)
    return ([statistics.median(c) for c in zip(*fwd)],
            [statistics.median(c) for c in zip(*bwd)])


def bc_level_bounds(n: int, s_pad: int, csr_bytes: int,
                    twin: BCTwinLevels) -> None:
    """Adds each level's bound to ``twin``'s records: its bytes at the
    memory rate against its operations at the float32 rate.  What any
    implementation must read to know which pairs are on duty is one bit a
    pair: forward, the bits of visited, of the level's frontier and of
    the next one (3 N S' / 8 bytes), sigma of each frontier pair, sigma
    written for each pair that joins; backward, the bits of the level and
    the level below (2 N S' / 8), coeff of each pair on the level, sigma
    read and delta and coeff written for each pair a level below (its
    delta is 0 before, so no implementation need read it); 4 bytes a
    value, and the CSR.  ``bound_dist_ms``
    beside it is the bound of the design before the masks, which read
    dist (4 bytes a pair) to find the pairs on duty (forward: dist of
    every pair, sigma of the frontier, dist and sigma of the joined;
    backward: dist of every pair, sigma and delta of the level, sigma
    and delta read and delta written a level below)."""
    bits = n * s_pad / 8
    for rec in twin.fwd:
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            3 * bits + 4 * (rec["frontier"] + rec["joined"]) + csr_bytes,
            rec["ops"])
        rec["bound_dist_ms"] = bound_ms(
            4 * (n * s_pad + rec["frontier"] + 2 * rec["joined"]) +
            csr_bytes, rec["ops"])[0]
    for rec in twin.bwd:
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            2 * bits + 4 * (rec["on_level"] + 3 * rec["updated"]) +
            csr_bytes, rec["ops"])
        rec["bound_dist_ms"] = bound_ms(
            4 * (n * s_pad + 2 * rec["on_level"] + 3 * rec["updated"]) +
            csr_bytes, rec["ops"])[0]


def bc_fixed_case(g, src, label: str) -> dict:
    """The two level kernels on one sweep of ``bc_batch``: bit-equal to
    the plain versions at every level; per level and per sweep (a
    task's), kernel and plain times, bound and library time."""
    from repro_torch.algorithms import bc_batch
    from repro_torch.kernels.dispatch import bucket
    twin = BCTwinLevels(g)
    bc_batch(g, src, steps=(twin.forward, twin.backward))
    bc_level_bounds(g.n, bucket(src.shape[0], 32),
                    (g.n + 1 + g.n_edges) * 4, twin)
    kf, kb = bc_sweep_times(g, src, "cuda", reps=10)
    pf, pb = bc_sweep_times(g, src, "ref", reps=3)
    for recs, k, p in ((twin.fwd, kf, pf), (twin.bwd, kb, pb)):
        for rec, km, pm in zip(recs, k, p):
            rec.update(ms=km, plain_ms=pm)
    out = {"label": label, "vertices": g.n, "edges": g.n_edges,
           "sources": int(src.shape[0]), "levels": len(twin.fwd),
           "forward": twin.fwd, "backward": twin.bwd}
    for name, recs in (("bc_forward_level", twin.fwd),
                       ("bc_backward_level", twin.bwd)):
        tot = {k: sum(r[k] for r in recs)
               for k in ("ms", "plain_ms", "bound_ms", "bound_dist_ms",
                         "library_ms")}
        tot["bound_by"] = "bytes" if all(r["bound_by"] == "bytes"
                                         for r in recs) else "operations"
        tot["levels"] = len(recs)
        tot["ms_per_level"] = tot["ms"] / len(recs)
        tot["levels_under_library"] = sum(r["ms"] < r["library_ms"]
                                          for r in recs)
        out[name] = tot
        log(f"[bc] {label}, {name}: {len(recs)} levels bit-equal to the "
            f"plain version; a sweep (a task's) kernel {tot['ms']:.4f} ms "
            f"({tot['ms_per_level']:.4f} ms a level), plain "
            f"{tot['plain_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
            f"({tot['bound_by']}; {tot['bound_dist_ms']:.4f} ms reading "
            f"dist), sparse.mm {tot['library_ms']:.4f} ms, kernel under "
            f"sparse.mm at {tot['levels_under_library']} of {len(recs)} "
            f"levels; per level kernel ms "
            + " ".join(f"{r['ms']:.4f}" for r in recs)
            + "; per level sparse.mm ms "
            + " ".join(f"{r['library_ms']:.4f}" for r in recs)
            + "; per level bound ms "
            + " ".join(f"{r['bound_ms']:.4f}" for r in recs))
    out["task_ms"] = out["bc_forward_level"]["ms"] + \
        out["bc_backward_level"]["ms"]
    return out


def bc_task_tap(spec, block_ids: set, kept: dict):
    """``spec`` with its task body wrapped: the (block, partial) of every
    task whose first source id is in ``block_ids`` is kept."""
    import dataclasses
    execute = spec.execute

    def tapped(block, shape):
        key, partial = execute(block, shape)
        if key in block_ids:
            kept[key] = (block.copy(), partial)
        return key, partial
    return dataclasses.replace(spec, execute=tapped)


def bc_fuse_tap(spec, sizes: list):
    """``spec`` with its fused task body wrapped: the number of blocks of
    every ``execute_batch`` call is appended to ``sizes``."""
    import dataclasses
    execute_batch = spec.execute_batch

    def tapped(blocks, shape):
        sizes.append(len(blocks))
        return execute_batch(blocks, shape)
    return dataclasses.replace(spec, execute_batch=tapped)


def phase_bc(dev) -> dict:
    """Betweenness centrality at the paper's scale 17: the port's
    ``bc_batch`` held against an independent host Brandes and the
    distance identity on sampled sources of the paper graph; the level
    kernels at fixed shapes, timed once the oracle's workers have ended;
    ``bc_spec(BC_PAPER, n_tasks=128, regenerate_graph=True)`` through
    ``run_irregular`` on the elastic pool (the timed run), on a local
    pool that fuses queued blocks into ``execute_batch`` calls, and on the
    elastic pool under the profiler; sampled tasks of the first run
    replayed through the plain versions."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch
    from repro_torch.algorithms import (RMATParams, bc_batch, bc_spec,
                                        rmat_graph)
    from repro_torch.configs.paper_workloads import (BC_PAPER, BC_PAPER_TASKS,
                                                     BC_SCALED)
    from repro_torch.core import make_pool, run_irregular
    from repro_torch.kernels import launches

    p = BC_PAPER
    t0 = time.monotonic()
    host = rmat_graph(p)
    regen_s = time.monotonic() - t0
    n = host.n
    out_deg = np.diff(host.out_indptr)
    log(f"[bc] paper graph (scale {p.scale}, edge factor {p.edge_factor}, "
        f"seed {p.seed}): {n} vertices, {host.n_edges} edges, largest "
        f"out/in degree {out_deg.max()}/{np.diff(host.in_indptr).max()}; "
        f"rmat_graph {regen_s:.3f} s on the host")
    rng = np.random.default_rng(16)
    oracle_src = sorted(int(v) for v in rng.choice(
        np.flatnonzero(out_deg > 0), BC_ORACLE_SOURCES, replace=False))
    rmat = (p.scale, p.edge_factor, p.a, p.b, p.c, p.seed)
    jobs = [oracle_src[i::BC_ORACLE_WORKERS]
            for i in range(BC_ORACLE_WORKERS)]
    pool = ProcessPoolExecutor(BC_ORACLE_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        futures = [pool.submit(bc_oracle, rmat, job) for job in jobs]
        # the port's side of the gates, untimed, while the oracle runs
        g17 = host.to(dev)
        got = bc_batch(g17, torch.tensor(oracle_src, device=dev)).cpu().numpy()
        port_sums = {s: float(bc_batch(g17, torch.tensor([s], device=dev))
                              .cpu().numpy().astype(np.float64).sum())
                     for s in oracle_src}
        oracle = [f.result() for f in futures]
    finally:
        pool.shutdown(cancel_futures=True)
    oracle_s = time.monotonic() - t0

    # -- the gates that do not trust the port --------------------------------
    keys = (np.repeat(np.arange(n, dtype=np.int64), out_deg) * n +
            host.out_indices)
    if any(o["edges_sha1"] != hashlib.sha1(keys.tobytes()).hexdigest()
           for o in oracle):
        raise AssertionError("rmat_graph's edge set differs from the host's "
                             "own R-MAT sampling")
    want = sum(o["delta"] for o in oracle)
    err = np.abs(got.astype(np.float64) - want)
    if not np.allclose(got, want, rtol=BC_RTOL, atol=BC_ATOL):
        raise AssertionError(
            f"BC of {BC_ORACLE_SOURCES} sources differs from the host's "
            f"Brandes on {int((err > BC_ATOL + BC_RTOL * np.abs(want)).sum())}"
            f" vertices (max |d| {err.max():.3e})")
    per = sorted((r for o in oracle for r in o["per_source"]),
                 key=lambda r: r["source"])
    for r in per:
        r["port_delta_sum"] = port_sums[r["source"]]
        for side in ("port_delta_sum", "oracle_delta_sum"):
            if not np.isclose(r[side], r["distance_identity"], rtol=BC_RTOL,
                              atol=BC_ATOL):
                raise AssertionError(f"source {r['source']}: {side} "
                                     f"{r[side]} != sum of (d - 1) "
                                     f"{r['distance_identity']}")
    log(f"[bc] {BC_ORACLE_SOURCES} sampled sources of the paper graph: "
        f"bc_batch on the card within rtol {BC_RTOL}, atol {BC_ATOL} of the "
        f"host's float64 Brandes (max |d| {err.max():.3e}, largest value "
        f"{want.max():.6e}); the sum of each source's dependencies equals "
        f"the sum of (d - 1) over the vertices it reaches ("
        + ", ".join(f"{r['source']}: {r['reached']} reached, depth "
                    f"{r['depth']}, {r['port_delta_sum']:.6e} / "
                    f"{r['distance_identity']:.6e}" for r in per)
        + f"); the edge set equals the host's own sampling; oracle "
        f"{oracle_s:.3f} s")

    # -- the kernels at fixed shapes, with no other process on the host ------
    fixed = []
    for scale, s in BC_FIXED:
        scaled = scale == BC_SCALED.scale
        g = g17 if scale == p.scale else rmat_graph(
            BC_SCALED if scaled else RMATParams(scale=scale, seed=p.seed)
        ).to(dev)
        # a task's block: its first, at the paper's and BC_SCALED's shapes
        src = torch.arange(s, device=dev) if s == 1024 or scaled else \
            torch.from_numpy(np.random.default_rng(scale).choice(
                g.n, s, replace=False)).to(dev)
        label = (f"scale {scale}, {s} sources"
                 + (" (main-path block 0)" if s == 1024 else
                    " (BC_SCALED block 0)" if scaled else ""))
        fixed.append(bc_fixed_case(g, src, label))
        torch.cuda.empty_cache()

    # -- the main path -------------------------------------------------------
    blocks = np.array_split(np.arange(n, dtype=np.int32), BC_PAPER_TASKS)
    picked = {int(blocks[i][0]) for i in np.random.default_rng(17).choice(
        BC_PAPER_TASKS, BC_REPLAY_TASKS, replace=False)}
    kept: dict = {}
    fused: list = []

    def path(name: str):
        """``run_irregular`` of the paper's BC spec, as run ``name``: the
        elastic pool's tasks are tapped for the replay, the local pool's
        fused calls counted."""
        def go():
            spec = bc_spec(p, n_tasks=BC_PAPER_TASKS, regenerate_graph=True,
                           device=dev)
            if name == "local fused":
                with make_pool("local", max_concurrency=BC_LOCAL_WIDTH) as lp:
                    return run_irregular(lp, bc_fuse_tap(spec, fused),
                                         batching=True)
            with elastic_pool() as ep:
                return run_irregular(
                    ep, bc_task_tap(spec, picked, kept)
                    if name == "elastic" else spec)
        if name == "elastic profiled":
            return lambda: device_timeline(go, "_level_kernel")
        return go

    runs, maps = {}, {}
    for name in ("elastic", "local fused", "elastic profiled"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r, wall, n_fwd = run_path(f"BC {name}", "bc_forward_level",
                                  path(name))
        n_bwd = launches("bc_backward_level")
        if n_bwd <= 0:
            raise AssertionError(f"BC {name}: bc_backward_level not launched")
        if name == "elastic profiled":
            r, prof = r
        out = r.output
        if out.shape != (n,) or not np.isfinite(out).all() or \
                (out < 0).any():
            raise AssertionError(f"BC {name}: map of shape {out.shape} not "
                                 f"finite and non-negative")
        maps[name] = out
        runs[name] = {"seconds": wall, "tasks": r.tasks,
                      "sources_per_s": n / wall,
                      "launches": {"bc_forward_level": n_fwd,
                                   "bc_backward_level": n_bwd},
                      "peak_memory_gb": torch.cuda.max_memory_allocated()
                      / 1e9}
        log(f"[bc] BC_PAPER, {BC_PAPER_TASKS} tasks, regenerate_graph, "
            f"{name}: {r.tasks} tasks, {wall:.3f} s, {n / wall:.1f} "
            f"sources/s, {n_fwd} forward and {n_bwd} backward level "
            f"launches, peak device memory "
            f"{runs[name]['peak_memory_gb']:.2f} GB; map sum {out.sum():.6e}, "
            f"max {out.max():.6e}")
    if max(fused, default=0) < 2:
        raise AssertionError(f"BC local fused: no execute_batch call fused "
                             f"two blocks ({fused})")
    runs["local fused"]["fused_calls"] = len(fused)
    runs["local fused"]["blocks_per_call"] = {
        k: fused.count(k) for k in sorted(set(fused))}
    prof["device_ms_per_task"] = sum(
        v["sum_ms"] for v in prof["by_name"].values()) / BC_PAPER_TASKS
    prof["overhead"] = (runs["elastic profiled"]["seconds"] /
                        runs["elastic"]["seconds"] - 1)
    log(f"[bc] local fused: {len(fused)} execute_batch calls, blocks per "
        f"call {runs['local fused']['blocks_per_call']}; the "
        f"{BC_PAPER_TASKS}-task run under the profiler: "
        f"{prof['device_ops']} device operations, busy {prof['busy_s']:.3f} "
        f"s, idle share {prof['idle_share']:.4f}, wall {prof['overhead']:+.4f}"
        f" against the unprofiled run; level kernels "
        f"{prof['device_ms_per_task']:.3f} ms a task; "
        + "; ".join(f"{k}: {v}" for k, v in prof["by_name"].items()))
    # keyed partials, each a deterministic function of its block, summed in
    # key order: the elastic runs agree bit for bit; fusing sums a call's
    # blocks in another order
    if not np.array_equal(maps["elastic"], maps["elastic profiled"]):
        raise AssertionError("BC: the two elastic maps differ")
    a, b = maps["elastic"], maps["local fused"]
    if not np.allclose(a, b, rtol=BC_RTOL, atol=BC_ATOL):
        raise AssertionError("BC: the elastic and the fused maps disagree")
    log(f"[bc] the two elastic maps are bit-equal; the fused map agrees "
        f"within rtol {BC_RTOL}, atol {BC_ATOL} (max |d| "
        f"{float(np.abs(a - b).max()):.3e})")

    # sampled main-path tasks, again through the plain versions
    if len(kept) != BC_REPLAY_TASKS:
        raise AssertionError(f"BC: kept {len(kept)} sampled tasks")
    for key, (block, partial) in sorted(kept.items()):
        ref = bc_batch(g17, torch.from_numpy(block).to(dev),
                       backend="ref").cpu().numpy()
        if not np.array_equal(ref.view(np.uint32), partial.view(np.uint32)):
            raise AssertionError(
                f"BC task {key}: the main path's partial differs from the "
                f"plain version's on {int((ref != partial).sum())} vertices")
    log(f"[bc] {len(kept)} sampled main-path tasks (blocks "
        f"{sorted(kept)}) bit-equal to the plain version")
    torch.cuda.empty_cache()
    return {"graph": {"vertices": n, "edges": host.n_edges,
                      "rmat_graph_s": regen_s},
            "fixed": fixed, "runs": runs,
            "replayed_blocks": sorted(kept), "oracle_sources": per,
            "oracle_max_abs_err": float(err.max()), "profile": prof,
            "launches": {k: r["launches"] for k, r in runs.items()}}


# -- the model slice: gemma3-1b prefill, decode and serving ----------------------

#: H100 SXM dense tensor-core peaks (NVIDIA data sheet, 700 W): bf16, and
#: TF32, which a float32 product needs three passes of (``flash_bound``)
PEAK_BF16_S = 989e12
PEAK_TF32_S = 495e12
#: the model path: gemma3-1b at full width; prefill_32k's sequence with the
#: batch cut from 32 to 1, then DECODE_STEPS tokens on from its cache
ARCH = "gemma3-1b"
PREFILL_S = 32_768
DECODE_STEPS = 32
#: whole-model comparison (kernel against plain version) and fixed shapes
MODEL_CMP_S = 4096
FIXED_S, FIXED_B = 4096, 2
#: serving: requests through the ElasticBatcher at full width
SERVE = dict(n_requests=16, n_slots=4, max_seq=256)
#: the whole-model check: 26 layers, each rounding its attention output to
#: bf16 (2**-8 relative) at another place in the two versions; in quadrature
#: about 2**-8 * sqrt(26) = 0.02 of the logits' scale, allowed three times
MODEL_REL_TOL = 2**-4
MODEL_MIN_COS = 0.999
#: float32 kernel check: the tolerance of the reference package's tests
F32_ATOL, F32_RTOL = 3e-5, 1e-4
#: bf16's unit roundoff: rounding to bf16 moves a value by at most this
#: share of its magnitude
BF16_U = 2**-8


def live_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(query, key) pairs one head attends to under the masks."""
    import numpy as np
    i = np.arange(sq, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    hi = np.minimum(i, skv - 1) if causal else np.full_like(i, skv - 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def _product_s(flops: float, dtype) -> float:
    """Least seconds for a product of ``flops`` whose operands are of
    ``dtype``, kept to that type's accuracy.  bf16 runs at the bf16
    tensor-core rate.  A float32 product takes three TF32 passes (hi.hi +
    hi.lo + lo.hi of each operand split into two TF32 values): one pass keeps
    10 of float32's 23 mantissa bits and misses the float32 tolerance
    (``tests/test_torch_flash_attention.py`` holds both), and three passes at
    495 TFLOP/s still beat the CUDA cores' 67."""
    import torch
    if dtype == torch.bfloat16:
        return flops / PEAK_BF16_S
    return 3 * flops / PEAK_TF32_S


def flash_bound(q2, k2, v2, causal: bool, window) -> tuple:
    """Least card time for one flash call: the live pairs' products (2 * D
    flops each for q.k^T in q's and k's type, 2 * D for p.v in v's type,
    each at ``_product_s``'s rate, the two added), against q, k, v read and
    o written once."""
    bhg, sq, d = q2.shape
    skv = k2.shape[1]
    pair_flops = bhg * live_pairs(sq, skv, causal, window) * 2 * d
    t_ops = (_product_s(pair_flops, q2.dtype) +
             _product_s(pair_flops, v2.dtype)) * 1e3
    n_bytes = (2 * q2.numel() + k2.numel()) * q2.element_size() + \
        v2.numel() * v2.element_size()
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", 2 * pair_flops)


def sdpa(q2, k2, v2, causal: bool, window):
    """``F.scaled_dot_product_attention`` on the kernel's operands: the
    yardstick ``library_ms``, timed only, never called by the port.  It
    takes one dtype, so operands of two are passed in the wider."""
    import torch
    import torch.nn.functional as F
    bhg, sq, d = q2.shape
    bhkv, skv, _ = k2.shape
    q4 = q2.view(bhkv, bhg // bhkv, sq, d)
    k4, v4 = k2.view(bhkv, 1, skv, d), v2.view(bhkv, 1, skv, d)
    if window is None:
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                              scale=1.0, enable_gqa=True)
    qp = torch.arange(sq, device=q2.device)[:, None]
    kp = torch.arange(skv, device=q2.device)[None, :]
    band = (qp - kp) < window
    if causal:
        band &= qp >= kp
    return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=band,
                                          scale=1.0, enable_gqa=True)


def trap_rows(sq: int, window, tiles: tuple) -> "list":
    """Rows whose first live key tile in the kernel is wholly masked: the
    Pallas kernel's -1e30 arithmetic gives them p = 1 for that tile until a
    later tile's alpha = 0 wipes it out."""
    bq, bk = tiles
    if window is None:
        return []
    rows = []
    for r in range(sq):
        q_lo = r // bq * bq
        first_tile = max(0, q_lo - window + 1) // bk * bk
        if r - window + 1 > first_tile + bk - 1:
            rows.append(r)
    return rows


def flash_allowed(want, weight=None):
    """Per-element tolerance of the kernel against its plain version.

    float32 throughout (``weight`` None): the reference's 3e-5 + 1e-4
    |want|.  Where p is rounded to bf16 (v in bf16), each version rounds
    every p_j once, at another scale (the kernel before normalising, the
    plain version after), by at most BF16_U of it, and rounds its output
    once: so |got - want| <= BF16_U * (2 * A + |want| + |got|), with
    A = sum_j p_j |v_j| (``weight``, the plain version on |v| in float32).
    Solved for the error, plus the float32 term for the scores' sums."""
    w = want.float().abs()
    if weight is None:
        return F32_ATOL + F32_RTOL * w
    return 2 * BF16_U * (weight + w) / (1 - BF16_U) + F32_ATOL


def _agreement(q2, k2, v2, kw: dict) -> dict:
    """Kernel and plain version on these operands, held to
    ``flash_allowed``; the error, the share of the tolerance used and the
    typical sizes beside it."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (flash_attention_cuda,
                                                         kernel_tiles)
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    got = flash_attention_cuda(q2, k2, v2, **kw)
    want = flash_attention_ref(q2, k2, v2, **kw)
    weight = None if v2.dtype == torch.float32 else flash_attention_ref(
        q2.float(), k2.float(), v2.float().abs(), **kw)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    allowed = flash_allowed(want, weight)
    trap = trap_rows(q2.shape[1], kw["window"], kernel_tiles())
    # medians over a strided sample of at most 2**24 values
    step = max(1, want.numel() // (1 << 24))
    rec = {"dtypes": f"{str(q2.dtype)[6:]} q/k, {str(v2.dtype)[6:]} v",
           "max_abs_err": float(diff.max()),
           "tolerance_used": float((diff / allowed).max()),
           "bad": int((diff > allowed).sum()),
           "median_abs_out": float(want.float().abs().flatten()[::step]
                                   .median()),
           "median_allowed": float(allowed.flatten()[::step].median()),
           "trap_rows": len(trap),
           "trap_rows_max_abs_err": float(diff[:, trap].max()) if trap
           else None}
    del got, want, weight, diff, allowed
    torch.cuda.empty_cache()
    return rec


def check_flash(q2, k2, v2, *, causal: bool, window, softcap=None,
                label: str, time_it: bool = True, reps: int = 10) -> dict:
    """The kernel against its plain version on these operands, with the
    tolerance of their dtypes (``flash_allowed``), and again with the
    operands cast to float32 through the kernel's float32 build at the
    reference's 3e-5 / 1e-4, which holds its logic tightly; times kernel,
    plain version and SDPA on the operands as given."""
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    kw = dict(causal=causal, window=window, softcap=softcap)
    as_given = _agreement(q2, k2, v2, kw)
    f32 = (as_given if torch.float32 == q2.dtype == v2.dtype else
           _agreement(q2.float(), k2.float(), v2.float(), kw))
    rec = {"label": label, "shape": f"q {list(q2.shape)}, k/v "
           f"{list(k2.shape)}, {as_given['dtypes']}",
           "causal": causal, "window": window, "softcap": softcap,
           "max_abs_err": as_given["max_abs_err"], "as_given": as_given,
           "float32": f32}
    for what, r in (("as given", as_given), ("in float32", f32)):
        log(f"[flash] {label}, {what} ({r['dtypes']}): max |err| "
            f"{r['max_abs_err']:.3e}, {r['tolerance_used']:.3f} of the "
            f"tolerance at worst; median |out| {r['median_abs_out']:.3e}, "
            f"median allowed {r['median_allowed']:.3e}; {r['trap_rows']} "
            f"rows with a wholly masked first tile (max |err| "
            f"{r['trap_rows_max_abs_err']})")
        if r["bad"]:
            raise AssertionError(f"flash_attention {label} {what}: kernel "
                                 f"differs from plain version beyond "
                                 f"tolerance on {r['bad']} values: {rec}")
    b_ms, b_by, flops = flash_bound(q2, k2, v2, causal, window)
    rec.update(bound_ms=b_ms, bound_by=b_by, flops=flops)
    if time_it:
        rec["ms"] = cuda_time_ms(lambda: flash_attention_cuda(q2, k2, v2, **kw),
                                 reps=reps)
        rec["plain_ms"] = cuda_time_ms(
            lambda: flash_attention_ref(q2, k2, v2, **kw), reps=reps)
        if softcap is None:
            wide = q2.dtype if q2.dtype == v2.dtype else torch.float32
            lq, lk, lv = (t.to(wide) for t in (q2, k2, v2))
            rec["library_ms"] = cuda_time_ms(
                lambda: sdpa(lq, lk, lv, causal, window), reps=reps)
            rec["library_dtype"] = str(wide)[6:]
            del lq, lk, lv
        else:
            rec["library_ms"] = None
    log(f"[flash] {label}: {rec['shape']} causal={causal} window={window} "
        f"softcap={softcap}: kernel {rec.get('ms', float('nan')):.4f} ms, "
        f"plain {rec.get('plain_ms', float('nan')):.4f} ms, SDPA "
        f"{rec.get('library_ms')} ms ({rec.get('library_dtype')}), bound "
        f"{b_ms:.4f} ms ({b_by})")
    torch.cuda.empty_cache()
    return rec


def phase_flash_fixed(dev) -> list:
    """The kernel at gemma3-1b's attention shapes (G = 4 on one KV head,
    D = 256, bf16, S = 4096, batch 2): causal, window 512, a ragged S, and
    causal with the dtypes a bf16 model feeds it (float32 q and k, bf16 v);
    and one small float32 case with a soft-cap."""
    import numpy as np
    import torch
    rng = np.random.default_rng(5)

    def operands(bhkv, g, s, d, dtype):
        q = rng.standard_normal((bhkv * g, s, d), np.float32) * d ** -0.5
        k = rng.standard_normal((bhkv, s, d), np.float32)
        v = rng.standard_normal((bhkv, s, d), np.float32)
        return [torch.from_numpy(a).to(dev, dtype) for a in (q, k, v)]

    out = []
    for s, window, label in ((FIXED_S, None, "fixed causal"),
                             (FIXED_S, 512, "fixed window 512"),
                             (4000, None, "fixed ragged S"),
                             (FIXED_S, None, "fixed causal, float32 q/k")):
        q2, k2, v2 = operands(FIXED_B, 4, s, 256, torch.bfloat16)
        if "float32" in label:
            q2, k2 = q2.float(), k2.float()
        out.append(check_flash(q2, k2, v2, causal=True, window=window,
                               label=label))
    q2, k2, v2 = operands(2, 4, 1000, 64, torch.float32)
    out.append(check_flash(q2 * 8, k2, v2, causal=True, window=300,
                           softcap=5.0, label="float32 softcap",
                           time_it=False))
    return out


def device_busy(fn, label: str) -> dict:
    """Run ``fn`` once under ``torch.profiler`` (CPU and CUDA activities)
    and sum the device time of every kernel: the device's busy time in
    that window, its idle share of the window's wall time, and the
    largest kernels by self device time.  The profiler slows the host
    side, so where the host sets the pace the idle share is an upper
    bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    # the device's own rows (kernels, copies, memsets), not the host ops
    # that launched them
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    rec = {"busy_ms": busy_ms, "profiled_wall_ms": wall * 1e3,
           "idle_share": 1 - busy_ms / (wall * 1e3),
           "device_calls": sum(e.count for e in events),
           "top": [{"kernel": e.key[:80], "ms": e.self_device_time_total
                    / 1e3, "calls": e.count} for e in top]}
    log(f"[profile] {label}: device busy {busy_ms:.3f} ms in "
        f"{rec['device_calls']} kernels, wall under the profiler "
        f"{wall * 1e3:.3f} ms, idle share {rec['idle_share']:.3f}; "
        f"largest: " + "; ".join(
            f"{t['kernel'][:40]} {t['ms']:.3f} ms x{t['calls']}"
            for t in rec["top"][:4]))
    if busy_ms <= 0:
        raise AssertionError(f"{label}: the profiler saw no device time")
    return rec


def phase_model(dev) -> dict:
    """gemma3-1b at full width on the card: prefill of S = 32,768 through
    the flash kernel (launches counted, one global and one local layer's
    operands re-checked against the plain version), the whole model with
    kernel and plain version at S = 4096, decode on from the 32k cache, and
    the elastic serving loop."""
    import numpy as np
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import decode_step, init_params, prefill

    cfg = get_config(ARCH)
    if SHAPES["prefill_32k"].seq_len != PREFILL_S:
        raise AssertionError("prefill_32k's sequence is not PREFILL_S")
    rng = np.random.default_rng(7)
    with torch.inference_mode():
        t0 = time.monotonic()
        params = init_params(cfg, 0, device=dev)
        torch.cuda.synchronize()
        init_s = time.monotonic() - t0
        n_params = sum(t.numel() for _, t in _leaves(params))
        log(f"[model] {cfg.name}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {n_params} parameters (bf16), random weights "
            f"from seed 0 in {init_s:.3f} s")
        toks = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (1, PREFILL_S + DECODE_STEPS))
        ).to(dev)

        # -- the path: prefill ------------------------------------------
        torch.cuda.reset_peak_memory_stats()
        with OperandTap("flash_attention_fwd", k=1) as tap:
            (logits, cache), pre_s, n_pre = run_path(
                "prefill", "flash_attention_fwd",
                lambda: prefill(cfg, params, {"tokens": toks[:, :PREFILL_S]}))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if n_pre != cfg.n_layers:
            raise AssertionError(f"prefill: {n_pre} flash_attention_fwd "
                                 f"launches, want {cfg.n_layers}")
        if logits.shape != (1, cfg.vocab_size) or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                                 f"finite")
        log(f"[model] prefill S={PREFILL_S} batch 1: {pre_s:.3f} s, "
            f"{PREFILL_S / pre_s:.1f} tokens/s, {n_pre} flash_attention_fwd "
            f"launches, peak memory {peak_gb:.2f} GB")

        # -- the kernel on the main path's own operands -----------------
        main_path = {}
        for (shapes, static), kept in sorted(tap.samples.items(),
                                             key=lambda kv: str(kv[0])):
            st = dict(static)
            kind = "global" if st["window"] is None else "local"
            (q2, k2, v2), _ = kept[0]
            main_path[kind] = check_flash(
                q2, k2, v2, causal=st["causal"], window=st["window"],
                softcap=st["softcap"], reps=3,
                label=f"prefill {kind} layer operands")
            main_path[kind]["launches"] = tap.seen[(shapes, static)]
        del tap, kept, q2, k2, v2
        if set(main_path) != {"global", "local"}:
            raise AssertionError(f"tapped {sorted(main_path)} layers")

        # -- the path: decode on from the 32k cache ---------------------
        arena_len = PREFILL_S + DECODE_STEPS
        arena = padded_cache(cache, arena_len)
        del cache
        nxt = torch.argmax(logits, dim=-1)[:, None]

        def decode_all():
            nonlocal nxt
            times = []
            for t in range(DECODE_STEPS):
                t1 = time.monotonic()
                lg, _ = decode_step(cfg, params, arena, {"tokens": nxt},
                                    torch.tensor([PREFILL_S + t], device=dev))
                nxt = torch.argmax(lg, dim=-1)[:, None]
                torch.cuda.synchronize()
                times.append(time.monotonic() - t1)
                if not bool(torch.isfinite(lg).all()):
                    raise AssertionError(f"decode step {t}: logits not finite")
            return times

        step_s, dec_s, n_dec = run_path("decode", "flash_attention_fwd",
                                        decode_all, required=False)
        log(f"[model] decode {DECODE_STEPS} tokens after the {PREFILL_S} "
            f"prefill (arena {arena_len}): {dec_s:.3f} s, median step "
            f"{statistics.median(step_s) * 1e3:.3f} ms, first "
            f"{step_s[0] * 1e3:.3f} ms, {n_dec} flash_attention_fwd "
            f"launches (the decode product is plain PyTorch)")
        # where the time goes: the prefill again, warm (the path's run
        # includes first-call costs), timed, then under the profiler; and
        # four decode steps (rewriting the arena's last four rows) under
        # the profiler
        t1 = time.monotonic()
        prefill(cfg, params, {"tokens": toks[:, :PREFILL_S]})
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t1
        log(f"[model] prefill S={PREFILL_S} again, warm: {warm_s:.3f} s, "
            f"{PREFILL_S / warm_s:.1f} tokens/s")
        prof = {"prefill": device_busy(
            lambda: prefill(cfg, params, {"tokens": toks[:, :PREFILL_S]}),
            f"prefill S={PREFILL_S}")}

        def four_steps():
            for t in range(arena_len - 4, arena_len):
                decode_step(cfg, params, arena, {"tokens": nxt},
                            torch.tensor([t], device=dev))

        prof["decode"] = device_busy(four_steps, "decode, 4 steps")
        prof["prefill"]["warm_wall_ms"] = warm_s * 1e3
        del arena, logits

        # -- whole model, kernel against plain version ------------------
        cmp = compare_model(cfg, params, toks[:, :MODEL_CMP_S + 1], dev)
    del params
    torch.cuda.empty_cache()

    # -- the path: serving --------------------------------------------------
    rep, serve_s, n_srv = run_path(
        "serve", "flash_attention_fwd",
        lambda: serve(ARCH, smoke=False, seed=0, device=dev, **SERVE),
        required=False)
    if rep["requests"] != SERVE["n_requests"]:
        raise AssertionError(f"serve answered {rep['requests']} of "
                             f"{SERVE['n_requests']} requests")
    log(f"[serve] {ARCH} full width, {SERVE}: {rep['requests']} requests, "
        f"{rep['tokens']} tokens, {rep['engine_decode_steps']} decode steps, "
        f"{rep['rounds']} rounds, {rep['wall_s']:.3f} s in the batcher, "
        f"{rep['tok_per_s']:.1f} tok/s, p50 TTFT {rep['ttft_p50']:.3f} s, "
        f"{n_srv} flash_attention_fwd launches")
    torch.cuda.empty_cache()
    return {"prefill": {"seq": PREFILL_S, "batch": 1, "seconds": pre_s,
                        "tokens_per_s": PREFILL_S / pre_s,
                        "peak_memory_gb": peak_gb, "launches": n_pre,
                        "init_params_s": init_s, "n_params": n_params},
            "main_path_operands": main_path,
            "decode": {"steps": DECODE_STEPS, "arena": arena_len,
                       "seconds": dec_s, "step_ms": [t * 1e3 for t in step_s],
                       "median_step_ms": statistics.median(step_s) * 1e3,
                       "launches": n_dec},
            "whole_model": cmp, "profile": prof,
            "serve": {k: rep[k] for k in ("requests", "tokens", "rounds",
                                          "wall_s", "tok_per_s", "ttft_p50",
                                          "ttft_p99", "engine_decode_steps")}
            | {"seconds": serve_s, "launches": n_srv, **SERVE},
            "launches": {"prefill": n_pre, "decode": n_dec, "serve": n_srv}}


def compare_model(cfg, params, toks, dev) -> dict:
    """Last-position logits of ``prefill`` at S = 4096 with the kernel and
    with the plain version forced (same weights), and of prefill(S) plus
    one decode step against prefill(S + 1): the whole model, right at full
    width."""
    import torch
    from repro_torch.models import decode_step, prefill

    s = toks.shape[1] - 1

    def close(a, b, what):
        a, b = a.float(), b.float()
        rel = float((a - b).abs().max() / b.abs().max())
        cos = float(torch.nn.functional.cosine_similarity(a, b, dim=-1).min())
        same = bool((a.argmax(-1) == b.argmax(-1)).all())
        log(f"[model] {what}: max |d logit| / max |logit| {rel:.3e} "
            f"(allowed {MODEL_REL_TOL:.3e}), cosine {cos:.6f} (allowed "
            f">= {MODEL_MIN_COS}), same argmax {same}")
        if not (rel <= MODEL_REL_TOL and cos >= MODEL_MIN_COS):
            raise AssertionError(f"{what}: logits disagree beyond tolerance")
        return {"rel_err": rel, "cosine": cos, "same_argmax": same}

    lk, cache = prefill(cfg, params, {"tokens": toks[:, :s]})
    lr, _ = prefill(cfg, params, {"tokens": toks[:, :s]}, backend="ref")
    out = {"seq": s, "kernel_vs_plain": close(lk, lr, f"prefill S={s}, "
                                              f"kernel vs plain version")}
    arena = padded_cache(cache, s + 1)
    ld, _ = decode_step(cfg, params, arena, {"tokens": toks[:, s:s + 1]},
                        torch.tensor([s], device=dev))
    lf, _ = prefill(cfg, params, {"tokens": toks})
    out["decode_vs_prefill"] = close(ld, lf, f"prefill {s} + decode 1 vs "
                                             f"prefill {s + 1}")
    out.update(rel_tol=MODEL_REL_TOL, min_cos=MODEL_MIN_COS)
    return out


def padded_cache(tree, length: int):
    """The prefill cache padded with zeros to ``length`` positions, each
    leaf in its own dtype (float32 k, bf16 v in a bf16 model), as
    ``tests/test_models_consistency.py`` pads the reference's."""
    import torch
    if isinstance(tree, dict):
        return {k: padded_cache(v, length) for k, v in tree.items()}
    if isinstance(tree, list):
        return [padded_cache(v, length) for v in tree]
    out = tree.new_zeros((tree.shape[0], length, *tree.shape[2:]))
    out[:, :tree.shape[1]] = tree
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda", 0)
    # the plain versions' float32 products run in full float32, not TF32,
    # and their bf16 products reduce in float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_start = time.monotonic()
    card = phase_environment()
    build = phase_build()
    sha1 = build["sha1_sass"]
    kernels = {"uts_hash": phase_kernel_uts(dev, sha1),
               "uts_expand": phase_kernel_uts_expand(dev, sha1),
               "mandelbrot": phase_kernel_mandelbrot(dev)}
    flash_fixed = phase_flash_fixed(dev)
    uts = phase_uts(dev, UTS_DEPTH)
    ms = phase_ms(dev, MS_SIDE, MS_DWELL, sha1["sm_clock_hz"])
    paper = phase_ms_paper_size(dev)
    bc = phase_bc(dev)
    model = phase_model(dev)
    # run_path has already required a launch on every path that runs a
    # hand kernel
    kernels["uts_expand"]["launches_by_path"] = uts["launches"]
    kernels["uts_hash"]["launches_by_path"] = uts["uts_hash_launches"]
    kernels["mandelbrot"]["launches_by_path"] = ms["launches"]
    # and at the main path's in-set shapes (max_iter 5,000,000), both builds
    kernels["mandelbrot"]["in_set_main_path"] = {
        k: ms["samples"]["in_set"][k] for k in ("samples", "median_ms",
                                                "speedup", "median_bound_ms")}
    # the BC lines are measured at a main-path task's shape (the paper
    # graph, block 0's 1,024 sources), per task: every level summed
    bc_task = bc["fixed"][-1]
    for name in ("bc_forward_level", "bc_backward_level"):
        k = bc_task[name]
        kernels[name] = {
            "max_abs_err": 0.0, "matched": True,
            "launches_by_path": {path: n[name] for path, n in
                                 bc["launches"].items()},
            **{x: k[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "levels", "ms_per_level")},
            "shape": f"CSR {bc_task['vertices']} vertices, "
                     f"{bc_task['edges']} edges; state [{bc_task['vertices']}"
                     f", {bc_task['sources']}]; a task's {k['levels']} "
                     f"levels summed"}
    # the flash line is measured on the prefill's own operands: a global
    # (causal, S = 32,768) layer, with the local (window 512) one beside it
    glob, loc = (model["main_path_operands"][k] for k in ("global", "local"))
    kernels["flash_attention_fwd"] = {
        "max_abs_err": max(glob["max_abs_err"], loc["max_abs_err"]),
        "max_abs_err_float32": max(glob["float32"]["max_abs_err"],
                                   loc["float32"]["max_abs_err"]),
        "matched": True, "launches_by_path": model["launches"],
        **{k: glob[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")},
        "shape": glob["shape"] + ", causal (global layer)",
        "library_dtype": glob["library_dtype"],
        "local_layer": {k: loc[k] for k in (
            "shape", "window", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "max_abs_err", "launches")}}

    summary = [{"name": name, "route": "cuda",
                "source": KERNEL_SOURCES[name][0],
                "replaces": KERNEL_SOURCES[name][1],
                "launches": sum(k["launches_by_path"].values()),
                "launches_by_path": k["launches_by_path"],
                "max_abs_err": k["max_abs_err"],
                "matched": k["matched"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
               | {x: k[x] for x in ("local_layer", "full_iteration_ms",
                                    "bound_dwell_sum_ms", "in_set_main_path",
                                    "bound_loose_ms", "levels",
                                    "ms_per_level")
                  if x in k}
               for name, k in kernels.items()]
    report = {"card": card, "device": torch.cuda.get_device_name(0),
              "seconds": time.monotonic() - t_start, "build": build,
              "kernels": kernels,
              "flash_fixed_shapes": flash_fixed, "uts": uts, "ms": ms,
              "ms_paper_size": paper, "bc": bc, "model": model}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"[done] {report['seconds']:.1f} s; report in "
        f"{OUT_DIR / 'chip_smoke.json'}")
    print(f"card: {card}")
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
