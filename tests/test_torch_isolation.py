"""The port stands alone: it runs its main paths (UTS, Mariani-Silver,
betweenness centrality, a master killed and resumed from its journal, a
recorded run replayed and calibrated, open-loop traffic, a DAG, the
examples, the model's prefill, decode and serving loop, a MoE and an MLA
prefill, the recurrent families' prefill and decode, rwkv6's serving
loop included, training with a checkpoint and a resume, and the mesh path
at a world of 1: training, its checkpoint and resume, and an all-to-all
MoE prefill; and the dry run of a cell on a fake world of 256) with jax, the
reference package and ``ml_dtypes`` unimportable, no source file of it
(nor ``chip_smoke.py``) imports any of them, and ``device=None`` never
falls back to the CPU."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; PyTorch's intra-op threads would
    oversubscribe it (the 256x256 dwell test goes from 1 s to minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: run first in every probe: jax and the reference package cannot be
#: imported
_PRELUDE = r"""
import json, sys


class _Unimportable:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"):
            raise ModuleNotFoundError(f"No module named {name!r}")
        return None


sys.meta_path.insert(0, _Unimportable())
import numpy as np
import torch
from repro_torch.algorithms import (MSParams, RMATParams, UTSParams,
                                    bc_single_node, bc_spec, ms_spec,
                                    naive_render, rmat_graph, uts_sequential,
                                    uts_spec)
from repro_torch.core import TaskShape, make_pool, run_irregular
shape = TaskShape(4, 20)
toks = torch.arange(12)[None]
res = {}
"""

#: run last in every probe: what it found, and what it imported
_REPORT = r"""
res["jax"] = sorted(k for k in sys.modules if k == "jax" or
                    k.startswith("jax."))
res["repro"] = sorted(k for k in sys.modules if k == "repro" or
                      k.startswith("repro."))
res["ml_dtypes"] = sorted(k for k in sys.modules if k == "ml_dtypes" or
                          k.startswith("ml_dtypes."))
print(json.dumps(res))
"""

#: one probe a main path: its body, and what its result must hold
_PROBES = {
    "uts_wal_resume": (r"""
import repro_torch.core.hybrid, repro_torch.core.simpool, repro_torch.runtime
import repro_torch.trace.store
from repro_torch.chaos import MasterKilledError, kill_master_after
res["uts"] = uts_sequential(UTSParams(max_depth=5), device="cpu")
killed = make_pool("sim", max_concurrency=4)
try:
    run_irregular(killed, kill_master_after(
        uts_spec(UTSParams(max_depth=5), device="cpu"), 3), wal=True,
        shape=shape)
except MasterKilledError:
    pass
with make_pool("sim", max_concurrency=4) as pool:
    resumed = run_irregular(pool, uts_spec(UTSParams(max_depth=5),
                                           device="cpu"),
                            resume_from=killed.events, shape=shape)
killed.shutdown()
res["uts_resumed"] = resumed.output
res["recovered"] = resumed.recovered_tasks
""", lambda r: r["uts"] == r["uts_resumed"] == 416 and r["recovered"] > 0),
    "elastic_uts_ms_bc": (r"""
p = MSParams(width=32, height=32, max_dwell=32, initial_subdivision=2,
             max_depth=2)
with make_pool("elastic", max_concurrency=4, invoke_overhead=0.0,
               invoke_rate_limit=None) as pool:
    r = run_irregular(pool, uts_spec(UTSParams(max_depth=5), device="cpu"))
    m = run_irregular(pool, ms_spec(p, device="cpu"))
    b = run_irregular(pool, bc_spec(RMATParams(scale=5), n_tasks=4,
                                    device="cpu"))
res["uts_pool"] = r.output
res["ms_equal"] = bool(np.array_equal(m.output["image"],
                                      naive_render(p, device="cpu")))
res["bc_equal"] = bool(np.array_equal(b.output, bc_single_node(
    rmat_graph(RMATParams(scale=5)), n_tasks=4, device="cpu")))
res["bc_tasks"] = b.tasks
""", lambda r: (r["uts_pool"] == 416 and r["ms_equal"] and r["bc_equal"]
                and r["bc_tasks"] == 4)),
    "model_prefill_decode_serve": (r"""
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import serve
from repro_torch.models import decode_step, init_cache, init_params, prefill
cfg = get_smoke_config("gemma3-1b")
params = init_params(cfg, 0, device="cpu")
t = toks % cfg.vocab_size
logits, cache = prefill(cfg, params, {"tokens": t})
arena = init_cache(cfg, 1, 13, device="cpu")
arena["stage0"][0]["block0"]["mixer"]["k"][:, :12] = \
    cache["stage0"][0]["block0"]["mixer"]["k"]
step, _ = decode_step(cfg, params, arena, {"tokens": t[:, -1:]},
                      torch.tensor([12]))
res["prefill"] = list(logits.shape)
res["decode"] = list(step.shape)
res["served"] = serve("gemma3-1b", smoke=True, n_requests=3, n_slots=2,
                      max_seq=32, device="cpu")["requests"]
""", lambda r: r["prefill"] == r["decode"] == [1, 256] and r["served"] == 3),
    "moe_mla_prefill": (r"""
from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params, prefill
for arch in ("deepseek-moe-16b", "deepseek-v3-671b"):
    fcfg = get_smoke_config(arch)
    fl, fc = prefill(fcfg, init_params(fcfg, 0, device="cpu"),
                     {"tokens": toks % fcfg.vocab_size})
    res[arch] = [list(fl.shape), sorted(fc["stage1"][0]["block0"]
                                        ["mixer"])]
""", lambda r: (r["deepseek-moe-16b"] == [[1, 256], ["k", "v"]] and
                r["deepseek-v3-671b"] == [[1, 256], ["c_kv", "k_pe"]])),
    "recurrent_prefill_decode_serve": (r"""
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import serve
from repro_torch.models import decode_step, init_cache, init_params, prefill
for arch in ("rwkv6-1.6b", "jamba-v0.1-52b"):
    rcfg = get_smoke_config(arch)
    rp = init_params(rcfg, 0, device="cpu")
    rl, rc = prefill(rcfg, rp, {"tokens": toks % rcfg.vocab_size})
    rd, _ = decode_step(rcfg, rp, init_cache(rcfg, 1, 4, device="cpu"),
                        {"tokens": toks[:, :1] % rcfg.vocab_size},
                        torch.tensor([0]))
    res[arch] = [list(rl.shape), list(rd.shape),
                 sorted(rc["stage0"][0]["block0"]["mixer"])]
res["rwkv_served"] = serve("rwkv6-1.6b", smoke=True, n_requests=3,
                           n_slots=2, max_seq=32, device="cpu")["requests"]
""", lambda r: (r["rwkv6-1.6b"] == [[1, 256], [1, 256], ["state", "x_prev"]]
                and r["jamba-v0.1-52b"] == [[1, 256], [1, 256],
                                            ["conv", "ssm"]]
                and r["rwkv_served"] == 3)),
    "replay_dag_traffic": (r"""
import repro_torch.trace.replay, repro_torch.trace.calibrate
from repro_torch.core import ProviderModel
from repro_torch.dag import montage_dag
from repro_torch.launch.serve import serve_traffic_sim
from repro_torch.trace import (TraceStore, extract_workload, fit_provider,
                               replay)
from repro_torch.traffic import generate_stream
store = TraceStore(ring_size=64)
with make_pool("sim", max_concurrency=8, provider=ProviderModel.aws_lambda(),
               trace=store) as pool:
    rec = run_irregular(pool, uts_spec(UTSParams(max_depth=5), device="cpu"),
                        shape=shape)
rep_same = replay(extract_workload(store, provider=ProviderModel.aws_lambda()),
                  provider=ProviderModel.aws_lambda(), max_concurrency=8)
res["replayed"] = [rec.tasks, rep_same.tasks]
res["fitted"] = fit_provider(store).name
store.close()
with make_pool("sim", max_concurrency=8) as pool:
    res["dag_nodes"] = run_irregular(pool, montage_dag(tiles=8)).dag_nodes
res["sim_completed"] = serve_traffic_sim(rate=2.0, horizon_s=10.0)[
    "completed"]
""", lambda r: (r["replayed"][0] == r["replayed"][1] > 0 and
                r["fitted"] == "fitted" and r["dag_nodes"] == 17 and
                r["sim_completed"] > 0)),
    "train_checkpoint_resume": (r"""
import tempfile
from repro_torch.launch.train import train
with tempfile.TemporaryDirectory() as d:
    a = train("gemma3-1b", steps=2, global_batch=2, seq_len=16, ckpt_dir=d,
              ckpt_every=2, log_every=1, device="cpu")
    b = train("gemma3-1b", steps=3, global_batch=2, seq_len=16, ckpt_dir=d,
              ckpt_every=100, log_every=1, device="cpu")
res["losses"] = [l for _, l in a["losses"] + b["losses"]]
res["resumed"] = [b["start_step"], b["steps"]]
""", lambda r: (len(r["losses"]) == 3 and r["resumed"] == [2, 1]
                and all(l == l and l > 0 for l in r["losses"]))),
    "mesh_train_moe_world1": (r"""
import tempfile
from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.specs import abstract_params
from repro_torch.launch.steps import plan_cell
from repro_torch.launch.train import train
from repro_torch.models import init_params
from repro_torch.models.flags import reset_flags, set_flags
mesh = make_host_mesh(1, 1, device="cpu")
with tempfile.TemporaryDirectory() as d:
    a = train("glm4-9b", steps=2, global_batch=2, seq_len=16, ckpt_dir=d,
              ckpt_every=2, log_every=1, device="cpu", mesh=mesh)
    b = train("glm4-9b", steps=3, global_batch=2, seq_len=16, ckpt_dir=d,
              ckpt_every=100, log_every=1, device="cpu", mesh=mesh)
res["losses"] = [l for _, l in a["losses"] + b["losses"]]
res["resumed"] = [b["start_step"], b["steps"]]
cfg = get_smoke_config("deepseek-moe-16b")
set_flags(moe_a2a=True, seq_shard_acts=True)
pre = plan_cell(cfg, ShapeSpec("p", 12, 1, "prefill"), mesh)
lg, _ = pre.step(init_params(cfg, 0, device="cpu", ctx=pre.ctx),
                 {"tokens": toks % cfg.vocab_size})
reset_flags()
res["moe_prefill"] = list(lg.shape)
res["meta"] = {t.device.type for t in
               abstract_params(cfg)["stage1"][0]["block0"]["ffn"].values()
               if hasattr(t, "device")} == {"meta"}
""", lambda r: (len(r["losses"]) == 3 and r["resumed"] == [2, 1]
                and all(l == l and l > 0 for l in r["losses"])
                and r["moe_prefill"] == [1, 256] and r["meta"])),
    "dryrun": (r"""
import tempfile
from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch.dryrun import trace_cell
with tempfile.TemporaryDirectory() as d:
    r = trace_cell("gemma3-1b", "train_4k", False, d, True, True, "full", "",
                   cfg=get_smoke_config("gemma3-1b"))
res["dryrun"] = [r["status"], r["devices"], r["analysis"]["kernels"]]
try:
    resolve_device(None)
    res["device_none"] = "card"
except RuntimeError:
    res["device_none"] = "raises without a card"
""", lambda r: (r["dryrun"] == ["ok", 256, {"flash_attention_fwd": 14,
                                            "flash_attention_bwd": 7}]
                and r["device_none"] == "raises without a card")),
    "examples": (r"""
from repro_torch.examples import betweenness_centrality, quickstart
import repro_torch.examples.mandelbrot_render
res["quickstart"] = quickstart.main("cpu", max_depth=5)["nodes"]
res["bc_example_tasks"] = betweenness_centrality.main(
    "cpu", scale=5, n_tasks=2)["tasks"]
""", lambda r: r["quickstart"] == 416 and r["bc_example_tasks"] == 2),
}


@pytest.mark.parametrize("path", sorted(_PROBES))
def test_main_path_runs_without_jax_or_repro(path):
    """Each main path in a process of its own: it must run, exit 0 (an
    elastic pool's worker thread still alive at exit once aborted the
    process after its work was done), hold its results, and import
    neither jax nor the reference package."""
    body, holds = _PROBES[path]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _PRELUDE + body + _REPORT],
                         env=env, capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert holds(res), res
    assert res["jax"] == []
    assert res["repro"] == []
    assert res["ml_dtypes"] == []


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|jaxlib|repro|ml_dtypes)\b(?!_torch)|"
    r"from\s+(jax|jaxlib|repro|ml_dtypes)\b(?!_torch)[\w.]*\s+import)",
    re.M)


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_static_scan_finds_no_jax_or_repro_import():
    files = _port_sources()
    assert len(files) > 10
    bad = {str(f.relative_to(ROOT)): m.group(0).strip()
           for f in files for m in [_FORBIDDEN.search(f.read_text())] if m}
    assert bad == {}


def test_fake_process_group_only_in_the_dry_run():
    """The fake backend (a test utility of torch) is imported by the dry
    run alone."""
    users = sorted(str(f.relative_to(ROOT)) for f in _port_sources()
                   if "torch.testing" in f.read_text())
    assert users == ["src/repro_torch/launch/dryrun.py"]


def test_static_scan_pattern_catches_imports():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.core import run_irregular", "import repro",
                 "    from repro.kernels.dispatch import bucket",
                 "import ml_dtypes", "    import ml_dtypes  # bf16",
                 "from ml_dtypes import bfloat16", "import jaxlib"):
        assert _FORBIDDEN.search(line), line
    for line in ("from repro_torch.core import make_pool",
                 "import repro_torch", "# import jax in a comment"):
        assert not _FORBIDDEN.search(line), line


def test_no_device_without_cuda_raises(monkeypatch):
    from repro_torch.algorithms import MSParams, UTSParams, ms_spec, uts_spec
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=None means the CUDA card"):
        uts_spec(UTSParams())
    with pytest.raises(RuntimeError, match="CUDA"):
        ms_spec(MSParams())
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")
