"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON line, last on standard output, and each
number the check compared beside its limit, last on standard error.  Exits
3 without a card, 4 if a JAX module was loaded, 1 if the run is not
correct.  ``setup_s`` counts from the first line of this file.
"""
import time

T_START = time.monotonic()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
