"""The benchmark's harness: one cell, run once, from the data files.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``.  Everything
that belongs to it is found by name:

* ``perfbench/configs/<config>.json``: the configuration, whose
  ``algorithm`` names the driver ``perfbench/algorithms/<algorithm>.py``
  (inputs from the seed, the job, the work a task did, the check);
* ``perfbench/traffic/<traffic>.json``: the pool and the loop that offer
  the jobs;
* ``perfbench/cells/<cell>.json``: the check's sample sizes and limits,
  and the tiny sizes of its CPU rehearsal;
* ``perfbench/metrics/<metric>.py``: one reader a metric, ``read(ctx)``
  returning the metric's value or None.

A run makes its inputs from the seed, builds and warms the cell's
kernels through a small job on the same pool (set-up, counted in
``setup_s``), then offers whole jobs back to back to ``run_irregular``
for ``seconds``.  The benchmark wraps each task body in a span of its own
(the host clock around the spec's ``execute``), and the spec's seed,
split and reduce in hooks that tell the driver which task's answer each
item and each fold came from (``Lineage``).  The window counts every task
whose body ended inside it, and its rates are the work of those tasks
over the whole window.  A job still running when the window closes is cut
there (``run_irregular``'s ``timeout``); the tasks already dispatched
finish, are checked, and are not counted.  With ``trace`` the device is
profiled from the window's start until the last task has ended.  Then the
program's state is freed and the check runs against the plain references.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import itertools
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
#: top-level module names that must not be loaded in the process that
#: prints a result: the JAX stack and the JAX package the port mirrors
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

#: the parent of a job's seed items in ``Lineage.gives``
SEED = -1

__all__ = ["Cell", "TaskRec", "Check", "Context", "Lineage", "load_cell",
           "run_cell", "main", "forbidden_modules", "FORBIDDEN", "SEED"]


@dataclass
class Cell:
    name: str
    entry: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    spec: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json; have "
                       f"{sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"])
                        .read_text())
    traffic = json.loads((root / "perfbench" / "traffic" /
                          f"{entry['traffic']}.json").read_text())
    spec = json.loads((root / "perfbench" / "cells" / f"{name}.json")
                      .read_text())
    return Cell(name, entry, config, traffic, spec,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def load_metric(name: str) -> Callable[["Context"], Optional[float]]:
    """The ``read`` function of ``perfbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "perfbench.metrics." + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class TaskRec:
    """One task body, on the benchmark's host clock; ``hook_s`` is the
    time the driver's hooks took around it, inside the same invocation."""

    job: int
    worker: str
    start: float
    end: float
    tag: Optional[int] = None
    failed: bool = False
    work: float = 0.0
    hook_s: float = 0.0
    info: Dict[str, Any] = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Check:
    """One number the check compares, beside its limit."""

    name: str
    value: float
    limit: float
    op: str = "<="

    @property
    def ok(self) -> bool:
        return (self.value <= self.limit if self.op == "<="
                else self.value >= self.limit)

    def line(self) -> str:
        return (f"check {self.name} = {self.value!r} {self.op} "
                f"{self.limit!r}: {'ok' if self.ok else 'FAILED'}")


@dataclass
class Context:
    """What a metric's reader sees of one run."""

    cell: Cell
    driver: Any
    device: Any
    t0: float
    t1: float
    setup_s: float
    tasks: List[TaskRec]
    pool_records: List[Any]
    launches: Dict[str, int]
    lineage: "Lineage"
    trace: Any = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def window_tasks(self) -> List[TaskRec]:
        """Task bodies that ended inside the window and did not raise."""
        return [r for r in self.tasks
                if not r.failed and self.t0 <= r.end <= self.t1]


class Lineage:
    """Which task's answer each work item and each fold came from.

    The seed and each split give items out, under new tags (``gives``:
    job, the parent task's tag or ``SEED``, the items' tags).  A task body
    takes its item, once, and so takes its tag; its answer is then folded
    and split by the master, once each.  Items and answers in flight are
    matched by identity, and held until taken, or folded and split.  At
    the window's end (``cut``) answers stop being held: the cut job folds
    no more.  What does not match is counted: ``stray`` bodies run on an
    item nothing gave out (or gave once and ran twice), answers folded
    (``fold_unmatched``) or split (``split_unmatched``) a second time or
    of no task, and answers folded but not split, or split but not folded,
    when the window closed (``half_done``).

    It takes no lock: each step is one dict or list operation, atomic
    under the GIL, and folds and splits run on the master alone."""

    def __init__(self) -> None:
        self._tags = itertools.count()
        self._items: Dict[int, Tuple[int, Any]] = {}
        self._answers: Dict[int, list] = {}
        self._cut = False
        self.gives: List[Tuple[int, int, List[int]]] = []
        self.stray = self.fold_unmatched = self.split_unmatched = 0
        self.half_done = 0

    def give(self, job: int, parent: Optional[int], items) -> None:
        tags = [next(self._tags) for _ in items]
        for tag, item in zip(tags, items):
            self._items[id(item)] = (tag, item)
        self.gives.append((job, parent, tags))

    def take(self, item) -> Optional[int]:
        got = self._items.pop(id(item), None)
        if got is None:
            self.stray += 1
            return None
        return got[0]

    def untake(self, tag: Optional[int], item) -> None:
        """A body that raised gives its item back for the pool's retry."""
        if tag is None:
            self.stray -= 1
        else:
            self._items[id(item)] = (tag, item)

    def answered(self, tag: Optional[int], answer) -> None:
        if not self._cut:
            self._answers[id(answer)] = [tag, answer, False, False]

    def _mark(self, answer, slot: int) -> Optional[int]:
        entry = self._answers.get(id(answer))
        if entry is None or entry[slot]:
            if slot == 2:
                self.fold_unmatched += 1
            else:
                self.split_unmatched += 1
            return None
        entry[slot] = True
        if entry[2] and entry[3]:
            del self._answers[id(answer)]
        return entry[0]

    def folded(self, answer) -> Optional[int]:
        return self._mark(answer, 2)

    def split(self, answer) -> Optional[int]:
        return self._mark(answer, 3)

    def cut(self) -> None:
        """The window has closed and the job in flight was cut."""
        self._cut = True
        held = list(self._answers.values())
        self.half_done = sum(e[2] != e[3] for e in held)
        self._answers.clear()

    def close(self) -> None:
        """The pool has run every task it was given; drop what is held."""
        self._items.clear()


class TaskLog:
    """Task records from every worker thread (``list.append`` is atomic
    under the GIL), and the run's lineage."""

    def __init__(self) -> None:
        self.records: List[TaskRec] = []
        self.lineage = Lineage()

    def add(self, rec: TaskRec) -> None:
        self.records.append(rec)


def wrap_spec(spec, job: int, driver, log: TaskLog):
    """``spec`` with the benchmark's span around each task body, the
    driver's hooks on each task's input and answer (timed apart), on the
    seed items and on each fold, and the lineage of every item."""
    execute, seed = spec.execute, spec.seed
    split, reduce = spec.split, spec.reduce
    lineage = log.lineage

    def body(item, shape):
        h_in = time.monotonic()
        tag = lineage.take(item)
        token = driver.before(job, tag, item)
        worker = threading.current_thread().name
        t_in = time.monotonic()
        try:
            result = execute(item, shape)
        except BaseException:
            lineage.untake(tag, item)
            log.add(TaskRec(job, worker, t_in, time.monotonic(), tag,
                            failed=True, hook_s=t_in - h_in))
            raise
        t_out = time.monotonic()
        rec = TaskRec(job, worker, t_in, t_out, tag)
        driver.after(rec, token, item, result)
        lineage.answered(tag, result)
        rec.hook_s = (t_in - h_in) + (time.monotonic() - t_out)
        log.add(rec)
        return result

    def seeded(shape):
        items = list(seed(shape))
        lineage.give(job, SEED, items)
        driver.seeded(job, items)
        return items

    def split_(result, shape):
        parent = lineage.split(result)
        items = list(split(result, shape))
        lineage.give(job, parent, items)
        return items

    def reduce_(state, result):
        new_state = reduce(state, result)
        driver.folded(job, lineage.folded(result), state, result, new_state)
        return new_state

    return dataclasses.replace(spec, execute=body, seed=seeded,
                               split=split_, reduce=reduce_)


def _sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _breakdown(ctx: Context) -> Dict[str, list]:
    """The device's costliest operations, and its idle gaps in the window
    by what the benchmark's spans say the host was doing."""
    import numpy as np
    from . import tracelib
    ops = sorted(ctx.trace.by_name().items(), key=lambda kv: -kv[1])[:10]
    gaps = tracelib.gaps(ctx.trace.spans(), ctx.t0, ctx.t1)
    if not gaps:
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": []}
    mids = np.array([(a + b) / 2 for a, b in gaps])
    label = np.full(len(gaps), "master_between_tasks", dtype=object)
    label[tracelib.covered(mids, [(r.start, r.end) for r in ctx.tasks])] = \
        "task_body"
    totals: Dict[str, float] = {}
    for (a, b), lab in zip(gaps, label):
        totals[lab] = totals.get(lab, 0.0) + (b - a)
    idle = [[f"all:{k}", v] for k, v in
            sorted(totals.items(), key=lambda kv: -kv[1])]
    longest = sorted(zip(gaps, label), key=lambda g: g[0][0] - g[0][1])
    for (a, b), lab in longest[:max(0, 10 - len(idle))]:
        idle.append([f"{lab}@{a - ctx.t0:.6f}s", b - a])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}


def _fifths(ctx: Context) -> List[float]:
    """The window's work in each fifth of it: where in the window a run
    is slow."""
    out = [0.0] * 5
    for r in ctx.window_tasks:
        out[min(4, int(5 * (r.end - ctx.t0) / ctx.window_s))] += r.work
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides: Optional[Dict[str, Any]] = None,
             log_fn: Callable[[str], None] = lambda s: None
             ) -> Dict[str, Any]:
    """Run ``cell`` once; returns the result line's object."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch
    from repro_torch.core import make_pool, run_irregular
    from repro_torch.kernels import launches

    overrides = overrides or {}
    traffic = {**cell.traffic, **overrides.get("traffic", {})}
    if traffic["loop"] != "closed":
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    driver = importlib.import_module(
        f"perfbench.algorithms.{cell.config['algorithm']}").Driver(
            cell, seed, device, traffic, overrides)
    log = TaskLog()
    pool_cfg = dict(traffic["pool"])
    pool = make_pool(pool_cfg.pop("kind"), **pool_cfg)
    batching = bool(traffic.get("batching", False))
    error: Optional[str] = None
    jobs = 0

    def job(k: int, spec, **kw):
        return run_irregular(pool, wrap_spec(spec, k, driver, log),
                             batching=batching, **kw)

    log_fn(f"imports {time.monotonic() - t_start:.3f} s")
    with pool:
        driver.prepare()
        log_fn(f"inputs {time.monotonic() - t_start:.3f} s")
        # a program that never finishes its warm-up job fails the run
        driver.warm(lambda spec, **kw: job(-1, spec, timeout=240, **kw))
        _sync(device)
        log = TaskLog()
        setup_s = time.monotonic() - t_start
        log_fn(f"set-up {setup_s:.3f} s")
        tracer = None
        if trace and device.type == "cuda":
            from .tracelib import DeviceTrace
            tracer = DeviceTrace(device)
            tracer.start()
        launches0 = {k: launches(k) for k in driver.kernels}
        load0, cpu0 = os.getloadavg()[0], time.process_time()
        t0 = time.monotonic()
        t1 = t0 + seconds
        while True:
            now = time.monotonic()
            if now >= t1:
                break
            spec, kw = driver.job(jobs)
            try:
                out = job(jobs, spec, timeout=t1 - now, **kw)
            except TimeoutError:
                break
            except Exception as exc:  # noqa: BLE001 — the run reports it
                error = f"{type(exc).__name__}: {exc}"
                log_fn(f"job {jobs} failed: {error}")
                break
            driver.job_done(jobs, out.output)
            jobs += 1
        log.lineage.cut()
        launched = {k: launches(k) - launches0[k] for k in driver.kernels}
    log.lineage.close()
    _sync(device)
    if tracer is not None:
        tracer.stop()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    records = list(pool.stats.records)
    del pool
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ctx = Context(cell, driver, device, t0, t1, setup_s, log.records,
                  records, launched, log.lineage, tracer)
    log_fn(f"window {seconds} s: {jobs} jobs finished, "
           f"{len(ctx.window_tasks)} tasks counted; host load "
           f"{load0:.2f} -> {os.getloadavg()[0]:.2f}, process CPU "
           f"{time.process_time() - cpu0:.2f} s; work by fifths "
           f"{_fifths(ctx)}")
    checks = driver.check(ctx)
    if error is not None:
        checks.append(Check("run.jobs_failed", 1, 0))
    failed = sum(r.failed and t0 <= r.end <= t1 for r in log.records)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_metric(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": all(c.ok for c in checks) and error is None,
              "attempted": len(ctx.window_tasks) + failed,
              "failed": failed, "metrics": metrics, "device": dev}
    if tracer is not None:
        from .tracelib import union_s
        dev["busy_s"] = union_s(tracer.spans(), t0, t1)
        dev["window_s"] = ctx.window_s
        result["breakdown"] = _breakdown(ctx)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit,
                                 "op": c.op} for c in checks}
    return result


def main(argv: List[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    err = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    cell = load_cell(args.workload)
    # CUDA's own JIT cache, if anything uses it, stays in the checkout
    os.environ.setdefault("CUDA_CACHE_PATH",
                          str(ROOT / "build" / "perfbench" / "cuda_cache"))
    import torch
    if not torch.cuda.is_available():
        err("no CUDA device: the benchmark runs on the card only")
        return 3
    if torch.cuda.device_count() < cell.chips:
        err(f"{cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} present")
        return 3
    device = torch.device("cuda", 0)
    err(f"device: {torch.cuda.get_device_name(device)}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, t_start, log_fn=err)
    bad = forbidden_modules()
    if bad:
        err(f"forbidden modules loaded: {bad}")
        return 4
    for name, c in result["checks"].items():
        err(Check(name, c["value"], c["limit"], c["op"]).line())
    print(json.dumps(result), flush=True)
    return 0 if result["correct"] else 1
