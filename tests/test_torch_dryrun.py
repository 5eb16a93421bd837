"""The port's dry run (``repro_torch.launch.dryrun``) and roofline
(``repro_torch.benchlib.roofline``) against the reference's.

Every dry run runs in a subprocess of its own (a fake process group must
not outlive its cells in a process that runs anything else), and the
reference's ``repro.launch.dryrun``, which sets ``XLA_FLAGS`` when
imported, is imported only in a subprocess.  The checks:

* ``model_flops``, ``cell_applicable`` and the skipped cells' reason equal
  the reference's for every cell;
* one smoke config per family (dense, MoE, MLA, Mamba, RWKV-6) dry-runs
  on pod256 and pod512 with status "ok", and the rank's argument bytes
  equal the sum of the reference's ``NamedSharding.shard_shape`` bytes for
  the same specs (a subprocess with 512 forced host devices).  The MoE
  families' smoke configs get 16 experts: the model axis of 16 must
  divide the experts in both packages;
* the reference's ``roofline.table`` prints the port's records exactly as
  the port's ``table`` does;
* a world-1 cell's dry-run count (meta tensors, fake process group)
  equals the count of the same step run on CPU tensors over gloo, for the
  families whose CPU path runs no scan (the scans' plain branch keeps
  their initial state, which the kernels' does not).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

#: (arch, shape, multi-pod, experts) of the smoke-config cells
_CELLS = [(arch, "train_4k", mp, ne)
          for arch, ne in (("gemma3-1b", None), ("deepseek-moe-16b", 16),
                           ("deepseek-v3-671b", 16), ("jamba-v0.1-52b", 16),
                           ("rwkv6-1.6b", None))
          for mp in (False, True)] + [("gemma3-1b", "decode_32k", False,
                                       None)]
#: the world-1 equality of the dry run and a CPU step
_WORLD1 = ("gemma3-1b", "deepseek-moe-16b", "deepseek-v3-671b")

_COMMON = f"""
import dataclasses, json, sys
CELLS = {_CELLS!r}
WORLD1 = {_WORLD1!r}


def smoke(get_smoke_config, arch, ne):
    cfg = get_smoke_config(arch)
    if ne:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=ne))
    return cfg
"""

_REFERENCE = _COMMON + r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import tempfile
import jax
import numpy as np
import repro.launch.dryrun as ref_dryrun
from repro.configs import (ARCH_IDS, SHAPES, cell_applicable, get_config,
                           get_smoke_config)
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import input_specs
from repro.launch.steps import plan_cell
from repro.runtime.sharding import batch_specs, named


def shard_bytes(tree, shardings):
    xs, shs = jax.tree.leaves(tree), jax.tree.leaves(shardings)
    assert len(xs) == len(shs), (len(xs), len(shs))
    return sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
               for x, s in zip(xs, shs))


out = {"skip": {}, "args": {}}
with tempfile.TemporaryDirectory() as d:
    for arch in ARCH_IDS:
        if cell_applicable(get_config(arch), SHAPES["long_500k"]):
            continue
        for mp in (False, True):
            rec = ref_dryrun.run_cell(arch, "long_500k", multi_pod=mp,
                                      out_dir=d, save_hlo=False)
            out["skip"][f"{arch}/{mp}"] = [rec["status"], rec["reason"]]
meshes = {mp: make_production_mesh(multi_pod=mp) for mp in (False, True)}
for arch, shape_name, mp, ne in CELLS:
    cfg = smoke(get_smoke_config, arch, ne)
    shape = SHAPES[shape_name]
    plan = plan_cell(cfg, shape, meshes[mp])
    sh = plan.shardings
    if shape.kind == "train":
        shs = (sh["params"], sh["opt"], sh["batch"])
    else:
        pos = named(meshes[mp], batch_specs(input_specs(cfg, shape)["pos"],
                                            plan.policy))
        shs = (sh["params"], sh["cache"], sh["batch"], pos)
    out["args"][f"{arch}/{shape_name}/{mp}"] = shard_bytes(plan.lower_args,
                                                           shs)
print(json.dumps(out))
"""

_PORT = _COMMON + r"""
import torch
import torch.distributed as dist
from repro_torch.benchlib.op_analysis import analyze_step
from repro_torch.benchlib.roofline import analysis_block
from repro_torch.configs import (ARCH_IDS, SHAPES, cell_applicable,
                                 get_config, get_smoke_config)
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.dryrun import trace_cell
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import plan_cell
from repro_torch.models import init_params
from repro_torch.optim import init_opt_state
torch.set_num_threads(1)
root, root1 = sys.argv[1], sys.argv[2]
out = {"skip": {}, "cells": {}, "world1": {}}
for arch in ARCH_IDS:
    if cell_applicable(get_config(arch), SHAPES["long_500k"]):
        continue
    for mp in (False, True):
        rec = trace_cell(arch, "long_500k", mp, root, False, True, "full", "")
        out["skip"][f"{arch}/{mp}"] = [rec["status"], rec["reason"]]
for arch, shape_name, mp, ne in CELLS:
    rec = trace_cell(arch, shape_name, mp, root, True, True, "full", "",
                     cfg=smoke(get_smoke_config, arch, ne))
    out["cells"][f"{arch}/{shape_name}/{mp}"] = [
        rec["status"], rec.get("error"),
        rec.get("memory_analysis", {}).get("argument_size_in_bytes"),
        rec.get("replicated_layers")]
shape = ShapeSpec("train_4k", 64, 2, "train")
for arch in WORLD1:
    cfg = get_smoke_config(arch)
    dry = trace_cell(arch, "train_4k", False, root1, False, True, "full", "",
                     shape=shape, mesh_shape=(1, 1), cfg=cfg)
    mesh = make_host_mesh(1, 1, device="cpu")
    plan = plan_cell(cfg, shape, mesh)
    params = init_params(cfg, 0, device="cpu", ctx=plan.ctx)
    opt = init_opt_state(params, plan.opt_cfg)
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    real = analysis_block(analyze_step(plan.step, params, opt, batch))
    dist.destroy_process_group()
    out["world1"][arch] = [dry["analysis"], real]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' subprocesses, side by side."""
    root = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = {
        "ref": subprocess.Popen([sys.executable, "-c", _REFERENCE], env=env,
                                cwd=str(ROOT), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True),
        "port": subprocess.Popen(
            [sys.executable, "-c", _PORT, str(root / "cells"),
             str(root / "world1")], env=env, cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, f"{name}: {stderr[-4000:]}"
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    out["root"] = root / "cells"
    return out


def test_model_flops_equal_the_reference():
    from repro.benchlib.roofline import model_flops as ref_model_flops
    from repro.configs import ARCH_IDS as REF_ARCHS
    from repro_torch.benchlib.roofline import model_flops
    from repro_torch.configs import ARCH_IDS, SHAPES
    assert list(ARCH_IDS) == list(REF_ARCHS)
    for arch in ARCH_IDS:
        for shape in SHAPES:
            for devices in (256, 512):
                assert model_flops(arch, shape, devices) == \
                    ref_model_flops(arch, shape, devices), (arch, shape)


def test_cell_applicable_equal_the_reference():
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import cell_applicable as ref_applicable
    from repro.configs import get_config as ref_config
    from repro_torch.configs import ARCH_IDS, SHAPES, cell_applicable, \
        get_config
    for arch in ARCH_IDS:
        for shape in SHAPES:
            assert cell_applicable(get_config(arch), SHAPES[shape]) == \
                ref_applicable(ref_config(arch), REF_SHAPES[shape])


def test_skipped_cells_and_reasons_equal_the_reference(runs):
    assert runs["port"]["skip"] == runs["ref"]["skip"]
    assert len(runs["port"]["skip"]) == 14
    assert {s for s, _ in runs["port"]["skip"].values()} == {"skipped"}


@pytest.mark.parametrize("cell", [f"{a}/{s}/{m}" for a, s, m, _ in _CELLS])
def test_smoke_cells_run_and_hold_the_reference_shards(runs, cell):
    status, error, held, _ = runs["port"]["cells"][cell]
    assert status == "ok", error
    assert held == runs["ref"]["args"][cell]


def test_replicated_layers_recorded(runs):
    """A layer kind is tallied where the rules' split of its leaves does
    not fall on heads or channels: the smoke configs' 2 to 4 heads do not
    divide the model axis of 16 (attention, MLA, RWKV-6's time mix), and
    the rules split none of RWKV-6's channel-mix leaves; jamba's smoke
    ``d_inner`` of 64 splits by channels, 4 a rank, so its Mamba layers
    run split and are not tallied."""
    cells = runs["port"]["cells"]
    assert "attn" in cells["gemma3-1b/train_4k/False"][3]
    assert {"rwkv6", "rwkv6_cmix"} <= set(cells["rwkv6-1.6b/train_4k/True"][3])
    assert "mla" in cells["deepseek-v3-671b/train_4k/False"][3]
    for mp in (False, True):
        jamba = cells[f"jamba-v0.1-52b/train_4k/{mp}"][3]
        assert "attn" in jamba and "mamba" not in jamba, jamba


@pytest.mark.parametrize("mesh", ["pod256", "pod512"])
def test_reference_table_prints_the_port_records(runs, mesh):
    from repro.benchlib.roofline import table as ref_table
    from repro_torch.benchlib.roofline import table
    root = str(runs["root"])
    got = table(root, mesh=mesh)
    assert ref_table(root, mesh=mesh) == got
    assert len(got.splitlines()) == 2 + 7 + 5 + (mesh == "pod256")


@pytest.mark.parametrize("arch", _WORLD1)
def test_world1_dry_run_equals_the_step(runs, arch):
    dry, real = runs["port"]["world1"][arch]
    assert dry == real
    assert dry["kernels"]["flash_attention_fwd"] > 0


def test_reanalyze_rebuilds_the_records(runs, tmp_path):
    """The per-op lists rebuild each analysis block as written."""
    import shutil
    from repro_torch.benchlib.roofline import reanalyze
    root = tmp_path / "copy"
    shutil.copytree(runs["root"], root)
    before = {p: json.loads(p.read_text())["analysis"]
              for p in root.glob("*/*/*.json")
              if json.loads(p.read_text())["status"] == "ok"}
    assert reanalyze(str(root)) == len(before) == 11
    for p, a in before.items():
        assert json.loads(p.read_text())["analysis"] == a


def test_cli_runs_each_cell_in_a_process_of_its_own(tmp_path):
    """``python -m repro_torch.launch.dryrun``: each cell in a spawned
    process (here the two meshes of a cell the reference skips), the
    records written and the summary printed."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "glm4-9b", "--shape", "long_500k", "--both-meshes", "--jobs", "2",
         "--out", str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "dry-run complete: 0 ok, 2 skipped (documented), 0 errors" in \
        out.stdout
    recs = [json.loads(p.read_text())
            for p in sorted(tmp_path.glob("glm4-9b/long_500k/*.json"))]
    assert [(r["mesh"], r["devices"], r["status"]) for r in recs] == [
        ("pod256", 256, "skipped"), ("pod512", 512, "skipped")]
