"""The port stands alone: it runs its main paths (UTS, Mariani-Silver,
betweenness centrality, a master killed and resumed from its journal, a
recorded run replayed and calibrated, open-loop traffic, a DAG, the
examples, and the model's prefill, decode and serving loop) with jax and
the reference package unimportable, no
source file of it (nor ``chip_smoke.py``) imports either, and
``device=None`` never falls back to the CPU."""
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


_PROBE = r"""
import json, sys


class _Unimportable:
    # jax and the reference package cannot be imported in this probe
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ModuleNotFoundError(f"No module named {name!r}")
        return None


sys.meta_path.insert(0, _Unimportable())
import numpy as np
from repro_torch.algorithms import (MSParams, RMATParams, UTSParams,
                                    bc_single_node, bc_spec, ms_spec,
                                    naive_render, rmat_graph, uts_sequential,
                                    uts_spec)
from repro_torch.core import make_pool, run_irregular
import repro_torch.core.hybrid, repro_torch.core.simpool, repro_torch.runtime
import repro_torch.trace.store
from repro_torch.chaos import MasterKilledError, kill_master_after
from repro_torch.core import TaskShape
n = uts_sequential(UTSParams(max_depth=5), device="cpu")
shape = TaskShape(4, 20)
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
p = MSParams(width=32, height=32, max_dwell=32, initial_subdivision=2,
             max_depth=2)
with make_pool("elastic", max_concurrency=4, invoke_overhead=0.0,
               invoke_rate_limit=None) as pool:
    r = run_irregular(pool, uts_spec(UTSParams(max_depth=5), device="cpu"))
    m = run_irregular(pool, ms_spec(p, device="cpu"))
    b = run_irregular(pool, bc_spec(RMATParams(scale=5), n_tasks=4,
                                    device="cpu"))
same = bool(np.array_equal(m.output["image"], naive_render(p, device="cpu")))
bc_same = bool(np.array_equal(b.output, bc_single_node(
    rmat_graph(RMATParams(scale=5)), n_tasks=4, device="cpu")))
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import serve
from repro_torch.models import decode_step, init_cache, init_params, prefill
cfg = get_smoke_config("gemma3-1b")
params = init_params(cfg, 0, device="cpu")
toks = torch.arange(12)[None] % cfg.vocab_size
logits, cache = prefill(cfg, params, {"tokens": toks})
arena = init_cache(cfg, 1, 13, device="cpu")
arena["stage0"][0]["block0"]["mixer"]["k"][:, :12] = \
    cache["stage0"][0]["block0"]["mixer"]["k"]
step, _ = decode_step(cfg, params, arena, {"tokens": toks[:, -1:]},
                      torch.tensor([12]))
rep = serve("gemma3-1b", smoke=True, n_requests=3, n_slots=2, max_seq=32,
            device="cpu")
import repro_torch.trace.replay, repro_torch.trace.calibrate
from repro_torch.core import ProviderModel
from repro_torch.dag import montage_dag
from repro_torch.examples import betweenness_centrality, quickstart
import repro_torch.examples.mandelbrot_render
from repro_torch.launch.serve import serve_traffic_sim
from repro_torch.trace import TraceStore, extract_workload, fit_provider, replay
from repro_torch.traffic import generate_stream
store = TraceStore(ring_size=64)
with make_pool("sim", max_concurrency=8, provider=ProviderModel.aws_lambda(),
               trace=store) as pool:
    rec = run_irregular(pool, uts_spec(UTSParams(max_depth=5), device="cpu"),
                        shape=shape)
rep_same = replay(extract_workload(store, provider=ProviderModel.aws_lambda()),
                  provider=ProviderModel.aws_lambda(), max_concurrency=8)
fitted = fit_provider(store)
store.close()
with make_pool("sim", max_concurrency=8) as pool:
    dag = run_irregular(pool, montage_dag(tiles=8))
sim = serve_traffic_sim(rate=2.0, horizon_s=10.0)
qs = quickstart.main("cpu", max_depth=5)
bc_ex = betweenness_centrality.main("cpu", scale=5, n_tasks=2)
print(json.dumps({
    "uts": n, "uts_pool": r.output, "ms_equal": same,
    "uts_resumed": resumed.output, "recovered": resumed.recovered_tasks,
    "bc_equal": bc_same, "bc_tasks": b.tasks,
    "prefill": list(logits.shape), "decode": list(step.shape),
    "served": rep["requests"],
    "replayed": [rec.tasks, rep_same.tasks], "fitted": fitted.name,
    "dag_nodes": dag.dag_nodes, "sim_completed": sim["completed"],
    "quickstart": qs["nodes"], "bc_example_tasks": bc_ex["tasks"],
    "jax": sorted(k for k in sys.modules if k == "jax" or k.startswith("jax.")),
    "repro": sorted(k for k in sys.modules
                    if k == "repro" or k.startswith("repro.")),
}))
"""


def test_main_path_runs_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["uts"] == 416 and res["uts_pool"] == 416
    assert res["uts_resumed"] == 416 and res["recovered"] > 0
    assert res["ms_equal"]
    assert res["bc_equal"] and res["bc_tasks"] == 4
    assert res["prefill"] == res["decode"] == [1, 256]
    assert res["served"] == 3
    assert res["replayed"][0] == res["replayed"][1] > 0
    assert res["fitted"] == "fitted" and res["dag_nodes"] == 17
    assert res["sim_completed"] > 0
    assert res["quickstart"] == 416 and res["bc_example_tasks"] == 2
    assert res["jax"] == []
    assert res["repro"] == []


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)\b(?!_torch)"
    r"[\w.]*\s+import)", re.M)


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_static_scan_finds_no_jax_or_repro_import():
    files = _port_sources()
    assert len(files) > 10
    bad = {str(f.relative_to(ROOT)): m.group(0).strip()
           for f in files for m in [_FORBIDDEN.search(f.read_text())] if m}
    assert bad == {}


def test_static_scan_pattern_catches_imports():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.core import run_irregular", "import repro",
                 "    from repro.kernels.dispatch import bucket"):
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
