"""The port stands alone: it runs its main paths (UTS, Mariani-Silver,
betweenness centrality, and the model's prefill, decode and serving
loop) without importing jax or any module of the reference package, no
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
import numpy as np
from repro_torch.algorithms import (MSParams, RMATParams, UTSParams,
                                    bc_single_node, bc_spec, ms_spec,
                                    naive_render, rmat_graph, uts_sequential,
                                    uts_spec)
from repro_torch.core import make_pool, run_irregular
n = uts_sequential(UTSParams(max_depth=5), device="cpu")
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
print(json.dumps({
    "uts": n, "uts_pool": r.output, "ms_equal": same,
    "bc_equal": bc_same, "bc_tasks": b.tasks,
    "prefill": list(logits.shape), "decode": list(step.shape),
    "served": rep["requests"],
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
    assert res["ms_equal"]
    assert res["bc_equal"] and res["bc_tasks"] == 4
    assert res["prefill"] == res["decode"] == [1, 256]
    assert res["served"] == 3
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
