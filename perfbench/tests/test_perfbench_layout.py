"""BENCHMARK.json against the benchmark's contract, and the harness finding
each cell, configuration, traffic mix and metric by its name."""
import json
import re
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.metrics.work import uts_expand
from perfbench.metrics.work.peaks import HBM_BW, PEAK_OPS_S

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_exactly_their_keys_and_valid_names():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("perfbench/")
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    metric_keys = {"name", "unit", "better", "source"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == metric_keys | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == metric_keys | {"layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_is_found_by_name_with_its_metrics(cell):
    c = harness.load_cell(cell)
    assert (ROOT / "perfbench" / "algorithms"
            / f"{c.config['algorithm']}.py").is_file()
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.load_metric(m["name"]))
        if m in c.per_layer:
            assert m["moves"] in e2e
    for key in ("sample", "checks", "rehearsal"):
        assert key in c.spec


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell("no-such-config.no-such-traffic")


def test_uts_work_formula_against_a_count_by_hand():
    # a bag of 3 nodes; the task pops 5 and leaves 4: it pushed 6
    # children (3 - 5 + 6 = 4), each one SHA-1 of 901 operations
    assert uts_expand.children(3, 5, 4) == 6
    assert uts_expand.OPS_PER_CHILD == 901
    ops_s = 6 * 901 / PEAK_OPS_S
    bytes_s = (3 + 4) * 24 / HBM_BW
    assert uts_expand.least_s(3, 5, 4) == max(ops_s, bytes_s)
