"""The UTS cell's check against a broken timed path: each fault the cell
can have, in the task body, in the split of its leftovers and in the
reduce, and the control (the plain reference with a bfloat16 child-count
map in the program's place), comes out not correct; the sound program
comes out correct.  On the CPU at the rehearsal's tiny sizes, and on the
card at the cell's own; and the control's readings at a small size."""
import time

import pytest
import torch

import repro_torch.algorithms.uts as uts_mod
from perfbench import control, harness
from perfbench.reference import sha1_uts as ref
from perfbench.tests._faults import breaking, rehearse

CELL = "uts-t1-d17.elastic"
ORIGINAL = uts_mod.expand_bag
ORIGINAL_SPLIT = uts_mod.Bag.split
ORIGINAL_SPEC = uts_mod.WorkSpec


def unchanged(bag, iters, params):
    return 0, bag


def half(bag, iters, params):
    h = bag.size // 2
    count, left = ORIGINAL(uts_mod.Bag(bag.digests[:, h:], bag.depths[h:]),
                           iters, params)
    return 2 * count, left


def altered(bag, iters, params):
    count, left = ORIGINAL(bag, iters, params)
    return count + 1, left


def bf16_control(bag, iters, params):
    count, d, p = ref.traverse(bag.digests, bag.depths, iters, b0=params.b0,
                               max_depth=params.max_depth, chunk=params.chunk,
                               precision="bfloat16")
    return count, uts_mod.Bag(d.to(torch.int32), p.to(torch.int32))


def split_drops_a_part(self, k):
    parts = ORIGINAL_SPLIT(self, k)
    return parts[:-1] if len(parts) > 1 else parts


def split_doubles_a_part(self, k):
    parts = ORIGINAL_SPLIT(self, k)
    if len(parts) > 1:
        parts.append(uts_mod.Bag(parts[0].digests.clone(),
                                 parts[0].depths.clone()))
    return parts


def _with_reduce(reduce):
    def spec(**kw):
        return ORIGINAL_SPEC(**{**kw, "reduce": reduce})
    spec.__name__ = reduce.__name__
    return spec


def reduce_adds_one(total, result):
    return total + result[0] + 1


def reduce_skips_the_count(total, result):
    return total


#: (where, name, broken): each fault, planted once the set-up has ended
FAULTS = [(uts_mod, "expand_bag", f)
          for f in (unchanged, half, altered, bf16_control)] + [
    (uts_mod.Bag, "split", split_drops_a_part),
    (uts_mod.Bag, "split", split_doubles_a_part),
    (uts_mod, "WorkSpec", _with_reduce(reduce_adds_one)),
    (uts_mod, "WorkSpec", _with_reduce(reduce_skips_the_count)),
]
IDS = [f.__name__ for _, _, f in FAULTS]


def _plant(monkeypatch, where, name, broken):
    monkeypatch.setattr(where, name, getattr(where, name))  # restored after
    return breaking(where, name, broken)


def test_the_sound_program_is_correct():
    line = rehearse(CELL)
    assert line["correct"], line["checks"]
    assert line["checks"]["uts.splits_checked"]["value"] >= 1
    assert line["checks"]["uts.folds_checked"]["value"] >= 1


@pytest.mark.parametrize("broken", [unchanged, half, altered, bf16_control],
                         ids=lambda f: f.__name__)
def test_a_broken_task_body_is_not_correct(monkeypatch, broken):
    line = rehearse(CELL, log_fn=_plant(monkeypatch, uts_mod, "expand_bag",
                                        broken))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("where,name,broken", FAULTS[4:], ids=IDS[4:])
def test_a_broken_split_or_reduce_fails_its_own_number(monkeypatch, where,
                                                       name, broken):
    line = rehearse(CELL, log_fn=_plant(monkeypatch, where, name, broken))
    number = ("uts.split_mismatch" if name == "split"
              else "uts.reduce_mismatch")
    assert not line["correct"], line["checks"]
    assert line["checks"][number]["value"] > 0, line["checks"]


def test_control_readings_fail_the_limit_and_the_program_passes():
    cell = harness.load_cell(CELL)
    recs = control.readings(CELL, [0, 1, 3], torch.device("cpu"),
                            cell.spec["rehearsal"])
    limit = cell.spec["checks"]["uts.task_mismatch"]
    assert all(r["program"]["uts.task_mismatch"] <= limit for r in recs)
    assert all(r["control"]["uts.task_mismatch"] > limit for r in recs)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the cell's own sizes")


@pytest.mark.cuda
@pytest.mark.parametrize("where,name,broken", [(None, None, None)] + FAULTS,
                         ids=["sound"] + IDS)
def test_at_the_cells_size_on_the_card(card, monkeypatch, where, name,
                                       broken):
    log_fn = (lambda s: None) if where is None else _plant(
        monkeypatch, where, name, broken)
    line = harness.run_cell(harness.load_cell(CELL), 2147483777, 8.0, False,
                            torch.device("cuda", 0), time.monotonic(),
                            log_fn=log_fn)
    print(where and broken.__name__, line["checks"])
    assert line["correct"] is (where is None), line["checks"]
