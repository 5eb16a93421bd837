"""Rehearse one cell on the CPU at the tiny sizes its cell file gives
(``rehearsal``), through the same harness, with the port's plain versions.

    python3 perfbench/rehearse.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

For the tests and for trying the harness on a host without a card; its
numbers are CPU numbers and stand for no device metric.  It prints the
same result line as ``run.py``, with ``"platform": "cpu"``.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    cell = harness.load_cell(args.workload)
    result = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace),
        torch.device("cpu"), T_START, overrides=cell.spec["rehearsal"],
        log_fn=lambda s: print(s, file=sys.stderr, flush=True))
    bad = harness.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
