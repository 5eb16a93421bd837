#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0, no result line):

1. environment: the card's name and power limit (``nvidia-smi``);
2. build: compiles every CUDA kernel of the port from ``src/repro_torch/
   kernels/csrc`` with ``nvcc`` (one process per source, all at once);
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   card, bit-equal, with CUDA-event times (median of 10 runs) and the least
   time the card could take for the same work;
4. UTS main path: ``uts_sequential`` for depths 4..10 against the published
   tree sizes, then the paper's Table 1 first row (seed 19, b0 4, depth 14)
   through ``uts_sequential`` and through ``run_irregular`` on the elastic
   pool with and without batching; the three counts must agree;
5. Mariani-Silver main path: the paper's sd-64 geometry (64-pixel seed
   rectangles, depth 5, split 2, max dwell 5,000,000) on a 512x512 image
   (the paper's is 4096x4096: some 500,000 tasks, which the host-bound
   elastic pool, at a few hundred tasks a second, cannot finish inside
   the smoke's time limit), through
   ``run_irregular`` on the elastic pool with and without batching; both
   images must equal Mariani-Silver applied to ``naive_render``'s dwell
   map on the card, pixel for pixel; then, at the paper's full size, the
   dwell map and the number of tasks Mariani-Silver over it dispatches;
6. one JSON line with every kernel's launches on the main path, error,
   times and bound, then the last line ``{"ok": true, "device": ...}``.

Each of the five main-path runs (three UTS, two Mariani-Silver) is driven
with the launch counts set to 0 just before it and read just after it,
and fails unless its kernel launched; the depth 4..10 checks and every
comparison launch fall outside those counts.  During the runs a seeded
sample of the operands each kernel is given (a few per distinct padded
shape) is kept, and afterwards each sample goes through the kernel and
its plain version again, which must agree bit for bit: phase 3 checks one
shape, this checks the main path's own.  The script imports nothing of
the JAX reference package.  It needs CUDA: without a card it exits with
code 2.
"""
from __future__ import annotations

import hashlib
import json
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
#: the full report goes here; the output directory of a chip call
OUT_DIR = ROOT / "chiprun_out"

#: H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM3 bytes/s and the
#: float32 rate outside the tensor cores.  The card has no published int32
#: ALU rate; integer operations are held against the float32 rate, which is
#: higher than the int32 issue rate, so their bound is a lower bound too.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12

#: 32-bit operations per SHA-1 lane: 64 schedule words (3 xor + 1 rotate),
#: 80 rounds (2 rotates, 4 adds, a 2-operation boolean function on average
#: counting lop3 as one), 5 final adds
UTS_OPS_PER_LANE = 64 * 4 + 80 * 8 + 5
UTS_BYTES_PER_LANE = 44           # 20 B parent + 4 B index in, 20 B out
#: float32 operations per dwell iteration: 3 mul, 3 add/sub, 1 fma (2)
MS_OPS_PER_ITER = 8
MS_BYTES_PER_POINT = 12           # two float32 in, one int32 out

KERNEL_SOURCES = {
    "uts_hash": ("src/repro_torch/kernels/csrc/uts_hash.cu",
                 "src/repro/kernels/uts_hash/kernel.py:96"),
    "mandelbrot": ("src/repro_torch/kernels/csrc/mandelbrot.cu",
                   "src/repro/kernels/mandelbrot/kernel.py:74"),
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


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.monotonic()
    built = _build.build()
    log(f"[build] {sorted(built) or 'all cached'} in "
        f"{time.monotonic() - t0:.3f} s")
    for name in _build.KERNELS:
        for line in _build.compiler_report(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


def _hashlib_digest(parent: list, ix: int) -> list:
    msg = b"".join(w.to_bytes(4, "big") for w in parent) + ix.to_bytes(4, "big")
    dig = hashlib.sha1(msg).digest()
    return [int.from_bytes(dig[4 * i:4 * i + 4], "big") for i in range(5)]


def phase_kernel_uts(dev) -> dict:
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
    b_ms, b_by = bound_ms(n * UTS_BYTES_PER_LANE, n * UTS_OPS_PER_LANE)
    log(f"[kernel] uts_hash N={n}: bit-equal to plain version and hashlib "
        f"(1000 lanes); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    return {"name": "uts_hash", "max_abs_err": err, "matched": True,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "shape": f"parent [5, {n}] int32, child_ix [{n}] int32"}


def phase_kernel_mandelbrot(dev) -> dict:
    import torch
    from repro_torch.kernels.mandelbrot.ops import mandelbrot_cuda
    from repro_torch.kernels.mandelbrot.ref import coords, mandelbrot_ref

    side, max_iter = 1024, 256
    c_re, c_im = coords(-2.0, -1.5, 1.0, 1.5, side, side, device=dev)
    got = mandelbrot_cuda(c_re, c_im, max_iter=max_iter)
    want = mandelbrot_ref(c_re, c_im, max_iter)
    torch.cuda.synchronize()
    diff = int((got != want).sum())
    err = int((got - want).abs().max())
    if diff:
        raise AssertionError(
            f"mandelbrot: kernel differs from plain version on {diff} of "
            f"{side * side} points (max |d dwell| {err})")
    ms = cuda_time_ms(lambda: mandelbrot_cuda(c_re, c_im, max_iter=max_iter))
    plain_ms = cuda_time_ms(lambda: mandelbrot_ref(c_re, c_im, max_iter))
    iters = int(got.sum())
    b_ms, b_by = bound_ms(side * side * MS_BYTES_PER_POINT,
                          iters * MS_OPS_PER_ITER)
    log(f"[kernel] mandelbrot {side}x{side} max_iter {max_iter}: bit-equal "
        f"to plain version; {iters} iterations; kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return {"name": "mandelbrot", "max_abs_err": err, "matched": True,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
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
    its padded operands to a seeded reservoir of ``k`` per distinct
    launch signature (shapes and static arguments), so the sample spans
    the whole run.  It holds references, not copies: dispatch hands a
    body freshly padded tensors or the caller's own, which nothing writes
    afterwards.
    """

    def __init__(self, name: str, k: int, seed: int = 0) -> None:
        import random
        import threading
        self.name, self.k = name, k
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
        key = (tuple(tuple(a.shape) for a in args),
               tuple(sorted(static.items())))
        with self.lock:
            seen = self.seen[key] = self.seen.get(key, 0) + 1
            kept = self.samples.setdefault(key, [])
            if len(kept) < self.k:
                kept.append(args)
            else:
                j = self.rng.randrange(seen)
                if j < self.k:
                    kept[j] = args
        return out


def run_path(name: str, kernel: str, fn) -> tuple:
    """Drive one main path with the launch counts set to 0 just before it
    and read just after; returns ``(result, seconds, launches)``."""
    import torch
    from repro_torch.kernels import launches, reset_launches
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.monotonic()
    out = fn()
    wall = time.monotonic() - t0
    n = launches(kernel)
    if n <= 0:
        raise AssertionError(f"{name}: {kernel} not launched on this path")
    return out, wall, n


def check_uts_samples(tap: OperandTap) -> dict:
    """Every sampled ``uts_hash`` launch of the main path, again through
    the kernel and through its plain version on the card: bit-equal."""
    import torch
    from repro_torch.kernels.uts_hash.ops import uts_child_digests
    lanes = 0
    for (shapes, _), kept in sorted(tap.samples.items()):
        for parent, ix in kept:
            got = uts_child_digests(parent, ix, backend="cuda")
            want = uts_child_digests(parent, ix, backend="ref")
            if not torch.equal(got, want):
                raise AssertionError(
                    f"uts_hash at main-path shape {shapes}: kernel differs "
                    f"from plain version on "
                    f"{int((got != want).any(dim=0).sum())} lanes")
            lanes += parent.shape[1]
    sizes = sorted(s[0][1] for s, _ in tap.samples.items())
    n = sum(len(v) for v in tap.samples.values())
    log(f"[uts] {n} sampled main-path launches ({lanes} lanes, padded "
        f"sizes {sizes}) bit-equal to the plain version")
    return {"samples": n, "lanes": lanes, "padded_sizes": sizes,
            "launches_by_size": {str(s[0][1]): c
                                 for s, c in sorted(tap.seen.items())}}


def check_mandelbrot_samples(tap: OperandTap, cap: int) -> dict:
    """Every sampled ``mandelbrot`` launch of the main path, again through
    the kernel and through its plain version on the card: bit-equal.

    The plain dwell syncs with the host once per iteration and stops when
    every point has escaped, so it cannot run an in-set point's 5,000,000
    iterations.  A sample whose points all escape within ``cap``
    iterations is compared at the main path's own ``max_iter``; any other
    (it reaches the set, or escapes late) is compared at ``max_iter`` =
    ``cap``.  The kernel runs each sample at its own shape; the plain
    version, elementwise, runs one row of every sample of a class.
    """
    import torch
    from repro_torch.kernels.mandelbrot.ops import mandelbrot
    classes: dict = {}
    for (shapes, static), kept in sorted(tap.samples.items()):
        max_iter = dict(static)["max_iter"]
        for c_re, c_im in kept:
            got = mandelbrot(c_re, c_im, max_iter, backend="cuda")
            it = max_iter if max_iter <= cap or int(got.max()) < cap else cap
            if it != max_iter:
                got = mandelbrot(c_re, c_im, it, backend="cuda")
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
    return out


def phase_uts(dev, depth: int) -> dict:
    from repro_torch.algorithms import UTSParams, uts_sequential, uts_spec
    from repro_torch.core import run_irregular

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
    with OperandTap("uts_hash", k=2) as tap:
        for name, fn in paths.items():
            (count, tasks), wall, n = run_path(f"UTS {name}", "uts_hash", fn)
            runs[name] = {"nodes": count, "seconds": wall, "tasks": tasks,
                          "nodes_per_s": count / wall, "launches": n}
            log(f"[uts] depth {depth} {name}: {count} nodes, {tasks} tasks, "
                f"{wall:.3f} s, {count / wall:.1f} nodes/s, {n} uts_hash "
                f"launches")
    counts = {r["nodes"] for r in runs.values()}
    if len(counts) != 1:
        raise AssertionError(f"UTS depth {depth}: counts disagree {runs}")
    samples = check_uts_samples(tap)
    return {"launches": {k: r["launches"] for k, r in runs.items()},
            "nodes": counts.pop(), "runs": runs, "samples": samples}


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
    image and the number of rectangles evaluated (the run's tasks).
    """
    import numpy as np

    out = np.zeros_like(dwells)
    sd = p.initial_subdivision
    xs = np.linspace(0, p.width, sd + 1).astype(int)
    ys = np.linspace(0, p.height, sd + 1).astype(int)
    todo = [(xs[j], ys[i], xs[j + 1], ys[i + 1], 0)
            for i in range(sd) for j in range(sd)]
    tasks = 0
    while todo:
        tasks += len(todo)
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
    return out, tasks


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


def phase_ms(dev, side: int, max_dwell: int) -> dict:
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
    with OperandTap("mandelbrot", k=4) as tap:
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
    torch.cuda.synchronize()
    t0 = time.monotonic()
    oracle = naive_render(p, device=dev)
    naive_s = time.monotonic() - t0
    expected, tasks = mariani_silver_over(oracle, p)
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
    return {"launches": {k: r["launches"] for k, r in runs.items()},
            "side": side, "max_dwell": max_dwell,
            "naive_render_s": naive_s, "pixels_off_naive": sampled,
            "reference_tasks": tasks, "runs": runs, "samples": samples}


def phase_ms_paper_size(dev) -> dict:
    """What the paper's full ``MS_PAPER_SD64`` run would be: its dwell map
    by ``naive_render`` on the card, and the tasks Mariani-Silver over it
    dispatches, which is why phase 5 runs a smaller image."""
    import numpy as np
    import torch
    from repro_torch.algorithms import naive_render
    from repro_torch.configs.paper_workloads import MS_PAPER_SD64

    p = MS_PAPER_SD64
    torch.cuda.synchronize()
    t0 = time.monotonic()
    dwells = naive_render(p, device=dev)
    naive_s = time.monotonic() - t0
    image, tasks = mariani_silver_over(dwells, p)
    sampled = int((image != dwells).sum())
    log(f"[ms] paper size {p.width}x{p.height} sd {p.initial_subdivision} "
        f"max_dwell {p.max_dwell}: naive_render {naive_s:.3f} s, "
        f"{int(dwells.astype(np.int64).sum())} iterations; Mariani-Silver "
        f"over it: {tasks} tasks, {sampled} pixels filled with another "
        f"dwell than theirs")
    return {"naive_render_s": naive_s, "tasks": tasks,
            "pixels_off_naive": sampled}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda", 0)
    t_start = time.monotonic()
    card = phase_environment()
    phase_build()
    kernels = {"uts_hash": phase_kernel_uts(dev),
               "mandelbrot": phase_kernel_mandelbrot(dev)}
    uts = phase_uts(dev, UTS_DEPTH)
    ms = phase_ms(dev, MS_SIDE, MS_DWELL)
    paper = phase_ms_paper_size(dev)
    # run_path has already required a launch on every path
    kernels["uts_hash"]["launches_by_path"] = uts["launches"]
    kernels["mandelbrot"]["launches_by_path"] = ms["launches"]

    summary = [{"name": name, "route": "cuda",
                "source": KERNEL_SOURCES[name][0],
                "replaces": KERNEL_SOURCES[name][1],
                "launches": sum(k["launches_by_path"].values()),
                "launches_by_path": k["launches_by_path"],
                "max_abs_err": k["max_abs_err"],
                "matched": k["matched"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
               for name, k in kernels.items()]
    report = {"card": card, "device": torch.cuda.get_device_name(0),
              "seconds": time.monotonic() - t_start, "kernels": kernels,
              "uts": uts, "ms": ms, "ms_paper_size": paper}
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
