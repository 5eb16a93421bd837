"""Each cell rehearsed end to end on the CPU at its tiny sizes, in a
process of its own: the result line has exactly the contract's keys, the
compared numbers come last, and no JAX module was loaded.  On a host
without a card the benchmark itself refuses to run."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest


ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def _run(script: str, cell: str, trace: int, seconds: float = 3.0,
         hide_card: bool = True):
    env = dict(os.environ)
    if hide_card:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, f"perfbench/{script}", "--workload", cell,
         "--seed", "2147483659", "--seconds", str(seconds),
         "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_prints_the_contracts_line(cell, trace):
    p = _run("rehearse.py", cell, trace)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "forbidden" not in p.stderr
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit", "op"}
    if trace == 0:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2


def test_without_a_card_the_benchmark_prints_no_result():
    p = _run("run.py", CELLS[0], 0, 1.0)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_runs_correct_on_the_card(card, cell):
    p = _run("run.py", cell, 0, 15.0, hide_card=False)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
