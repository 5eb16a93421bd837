"""Readings for the check's limits: the program's, and its control's.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 ...

For each seed, at the cell's own sizes, the number the cell's check
compares, read twice on the same inputs: once for the program's task body
(``spec.execute``, the body the window's tasks run) and once for the
control, the plain reference computed one precision below the
configuration's (bfloat16 for its float32) and put in the program's
place.  A limit lies between the program's largest reading and the
control's smallest.  Prints one JSON line a seed.

* UTS: ``uts.task_mismatch`` of two tasks a seed, each at the cell's
  budget: the root bag of the run's first tree that does not end within
  one task, and the fourth of the eight bags its leftover splits into,
  against the float32 child-count map.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402


def _uts(cell, seed: int, device, traffic, overrides) -> Dict[str, Any]:
    import torch
    from perfbench.algorithms.uts import Driver
    from perfbench.reference import sha1_uts as ref
    d = Driver(cell, seed, device, traffic, overrides)
    d.prepare()
    kw = dict(b0=float(d.cfg["b0"]), max_depth=int(d.cfg["max_depth"]),
              chunk=int(d.cfg["chunk"]),
              max_children=int(d.cfg["max_children"]))
    for k in range(16):
        spec, _ = d.job(k)
        bags = list(spec.seed(d.shape))[:1]
        program = [spec.execute(bags[0], d.shape)]
        parts = program[0][1].split(8)
        if parts:
            break
    bags.append(parts[min(3, len(parts) - 1)])
    program.append(spec.execute(bags[1], d.shape))
    inputs = [(b.digests, b.depths) for b in bags]
    want = ref.traverse_many(inputs, d.shape.iters, **kw)
    low = ref.traverse_many(inputs, d.shape.iters, precision="bfloat16",
                            **kw)

    def mismatches(answers) -> int:
        return sum(not (c == wc and dg.shape == wd.shape and torch.equal(
            dg.to(torch.int64) & ref.M32, wd) and torch.equal(
            dp.to(torch.int64), wp))
            for (c, dg, dp), (wc, wd, wp) in zip(answers, want))

    return {"counts": [int(c) for c, _, _ in want],
            "program": {"uts.task_mismatch": mismatches(
                [(c, b.digests, b.depths) for c, b in program])},
            "control": {"uts.task_mismatch": mismatches(low)}}


def readings(name: str, seeds: List[int], device,
             overrides: Optional[Dict[str, Any]] = None,
             root: Path = harness.ROOT) -> List[Dict[str, Any]]:
    """One record a seed: the program's and the control's readings."""
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    cell = harness.load_cell(name, root)
    overrides = overrides or {}
    traffic = {**cell.traffic, **overrides.get("traffic", {})}
    fn = {"uts": _uts}[cell.config["algorithm"]]
    return [{"seed": s, **fn(cell, s, device, traffic, overrides)}
            for s in seeds]


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    for rec in readings(args.workload, args.seeds, torch.device("cuda", 0)):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
