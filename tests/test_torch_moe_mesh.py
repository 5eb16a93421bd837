"""The port's expert-parallel ``moe_apply``, replicated and all-to-all
dispatch, at 2 x 2 ("data" x "model") over gloo, against the reference's
``moe_apply`` on a 2 x 2 mesh of 4 forced CPU devices.

This process's JAX is locked to one device, so the reference runs in a
subprocess with ``--xla_force_host_platform_device_count=4`` (as
``tests/test_hlo_analysis.py`` does), and the port's world is 4 spawned
processes meeting at a ``FileStore``; both read their inputs from, and
write their outputs to, ``.npz`` files.  Inputs: float32 parameters and
activations from one numpy seed, capacity factor 1.0 (pairs are dropped,
per shard as in the reference), one shared expert; batch 2 (split over
"data") and 1 (replicated over it).  ``y`` within 1e-5 of its largest
value, ``aux`` within 1e-6, the expert counts equal.  The backward too:
the gradients of ``sum(y * r) + aux`` (``r`` a fixed random tensor) with
respect to the router, the expert stacks and the shared expert, each
within 1e-5 of its largest value (the port's gathered whole: summed over
"data", the expert stacks' blocks concatenated over "model").
"""
import math
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch

E, K, DE, D, S = 8, 2, 16, 32, 32
CASES = [(d, b) for d in ("replicated", "a2a") for b in (2, 1)]
JOIN_TIMEOUT_S = 240


def _inputs(root: Path) -> None:
    rng = np.random.default_rng(11)
    arrs = {"router": (rng.standard_normal((D, E)) / np.sqrt(D)
                       ).astype(np.float32)}
    for name, shape in (("gate", (E, D, DE)), ("up", (E, D, DE)),
                        ("down", (E, DE, D))):
        arrs[name] = (rng.standard_normal(shape) / np.sqrt(shape[1])
                      ).astype(np.float32)
    for name, shape in (("s_gate", (D, DE)), ("s_up", (D, DE)),
                        ("s_down", (DE, D))):
        arrs[name] = (rng.standard_normal(shape) / np.sqrt(shape[0])
                      ).astype(np.float32)
    for b in (2, 1):
        arrs[f"x{b}"] = rng.standard_normal((b, S, D)).astype(np.float32)
        arrs[f"r{b}"] = rng.standard_normal((b, S, D)).astype(np.float32)
    np.savez(root / "inputs.npz", **arrs)


_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.models.config import MoEConfig
    from repro.models.moe import moe_apply
    root = sys.argv[1]
    a = dict(np.load(os.path.join(root, "inputs.npz")))
    cfg = MoEConfig(n_experts={E}, top_k={K}, d_expert={DE}, n_shared=1,
                    capacity_factor=1.0)
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    params = {{"router": {{"w": jnp.asarray(a["router"])}},
               "gate": jnp.asarray(a["gate"]), "up": jnp.asarray(a["up"]),
               "down": jnp.asarray(a["down"]),
               "shared": {{"gate": {{"w": jnp.asarray(a["s_gate"])}},
                          "up": {{"w": jnp.asarray(a["s_up"])}},
                          "down": {{"w": jnp.asarray(a["s_down"])}}}}}}
    out = {{}}
    for dispatch in ("replicated", "a2a"):
        for b in (2, 1):
            f = jax.jit(lambda p, x, _d=dispatch: moe_apply(
                p, x, cfg, mesh=mesh, dp_axes=("data",), tp_axis="model",
                dispatch=_d))
            x, r = jnp.asarray(a[f"x{{b}}"]), jnp.asarray(a[f"r{{b}}"])
            y, aux, counts = f(params, x)
            out[f"{{dispatch}}_{{b}}_y"] = np.asarray(y)
            out[f"{{dispatch}}_{{b}}_aux"] = np.asarray(aux)
            out[f"{{dispatch}}_{{b}}_counts"] = np.asarray(counts)

            def objective(p, x, r=r, f=f):
                y, aux, _ = f(p, x)
                return jnp.sum(y * r) + aux
            g = jax.jit(jax.grad(objective))(params, x)
            grads = {{"router": g["router"]["w"], "gate": g["gate"],
                      "up": g["up"], "down": g["down"],
                      **{{f"s_{{k}}": g["shared"][k]["w"]
                         for k in ("gate", "up", "down")}}}}
            for k, v in grads.items():
                out[f"{{dispatch}}_{{b}}_grad_{{k}}"] = np.asarray(v)
    np.savez(os.path.join(root, "reference.npz"), **out)
    print("OK")
""").format(E=E, K=K, DE=DE)


def _port_rank(rank: int, world: int, root: str) -> None:
    import warnings
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.config import MoEConfig
    from repro_torch.models.moe import moe_apply
    from repro_torch.runtime.collectives import all_gather_dim, axis_group
    warnings.filterwarnings("ignore", category=FutureWarning)
    torch.set_num_threads(1)
    root = Path(root)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(root / "store"), world), rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(2, 2, device="cpu")
        a = {k: torch.from_numpy(v) for k, v in
             np.load(root / "inputs.npz").items()}
        cfg = MoEConfig(n_experts=E, top_k=K, d_expert=DE, n_shared=1,
                        capacity_factor=1.0)
        m = mesh.get_local_rank("model")
        d = mesh.get_local_rank("data")
        dpg, tpg = axis_group(mesh, "data"), axis_group(mesh, "model")
        e_loc = E // 2
        out = {}
        for dispatch, b in CASES:
            leaves = {"router": a["router"],
                      **{k: a[k][m * e_loc:(m + 1) * e_loc]
                         for k in ("gate", "up", "down")},
                      **{f"s_{k}": a[f"s_{k}"]
                         for k in ("gate", "up", "down")}}
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in leaves.items()}
            params = {"router": {"w": leaves["router"]},
                      **{k: leaves[k] for k in ("gate", "up", "down")},
                      "shared": {k: {"w": leaves[f"s_{k}"]}
                                 for k in ("gate", "up", "down")}}
            x, r = a[f"x{b}"], a[f"r{b}"]
            dp_ok = b % 2 == 0
            if dp_ok:
                x, r = (t[d * (b // 2):(d + 1) * (b // 2)] for t in (x, r))
            y, aux, counts = moe_apply(params, x, cfg, mesh=mesh,
                                       dp_axes=("data",), tp_axis="model",
                                       dispatch=dispatch, dp_ok=dp_ok)
            # the objective's share on this rank: its own tokens' part, or
            # a data rank's share of the whole batch's where every data
            # rank runs it; aux is replicated (mean over "data" inside)
            part = torch.sum(y * r) * (1.0 if dp_ok else 0.5)
            grads = torch.autograd.grad(part + aux, list(leaves.values()))
            for k, g in zip(leaves, grads):
                g = g.clone()
                dist.all_reduce(g, group=dpg)
                if k in ("gate", "up", "down"):
                    g = all_gather_dim(g, 0, tpg)
                out[f"{dispatch}_{b}_grad_{k}"] = g.numpy()
            y = y.detach()
            if dp_ok:
                y = all_gather_dim(y, 0, dpg)
            counts = all_gather_dim(counts, 0, tpg)
            out[f"{dispatch}_{b}_y"] = y.numpy()
            out[f"{dispatch}_{b}_aux"] = aux.detach().numpy()
            out[f"{dispatch}_{b}_counts"] = counts.numpy()
        if rank == 0:
            np.savez(root / "port.npz", **out)
    except BaseException as e:
        (root / f"error_{rank}.txt").write_text(f"{type(e).__name__}: {e}")
        raise
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    import torch.multiprocessing as mp
    root = tmp_path_factory.mktemp("moe_mesh")
    _inputs(root)
    ctx = mp.start_processes(_port_rank, args=(4, str(root)), nprocs=4,
                             join=False, start_method="spawn")
    ref = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(root)], capture_output=True,
        text=True, timeout=JOIN_TIMEOUT_S,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu"},
        cwd=str(Path(__file__).resolve().parents[1]))
    error = None
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                error = f"the port's world did not finish in {JOIN_TIMEOUT_S} s"
                break
    except Exception as e:
        error = f"the port's world: {e}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    errors = [f.read_text() for f in root.glob("error_*.txt")]
    assert error is None and not errors, (error, errors)
    assert "OK" in ref.stdout, ref.stderr[-3000:]
    return (dict(np.load(root / "port.npz")),
            dict(np.load(root / "reference.npz")))


@pytest.mark.parametrize("dispatch,b", CASES)
def test_moe_apply_matches_reference(outputs, dispatch, b):
    port, ref = outputs
    key = f"{dispatch}_{b}"
    y, want = port[f"{key}_y"], ref[f"{key}_y"]
    assert y.shape == want.shape
    assert np.abs(y - want).max() <= 1e-5 * np.abs(want).max()
    assert abs(float(port[f"{key}_aux"]) - float(ref[f"{key}_aux"])) <= 1e-6
    np.testing.assert_array_equal(port[f"{key}_counts"],
                                  ref[f"{key}_counts"])


GRADS = ("router", "gate", "up", "down", "s_gate", "s_up", "s_down")


@pytest.mark.parametrize("dispatch,b", CASES)
def test_moe_apply_backward_matches_reference(outputs, dispatch, b):
    """The gradients of ``sum(y * r) + aux``: the aux loss's mean over the
    shards and the router's all-reduce under both dispatches."""
    port, ref = outputs
    for name in GRADS:
        key = f"{dispatch}_{b}_grad_{name}"
        g, want = port[key], ref[key]
        assert g.shape == want.shape, key
        assert np.abs(g - want).max() <= 1e-5 * np.abs(want).max(), key


def test_pairs_are_dropped(outputs):
    """The cases run where capacity cuts pairs: at batch 1 (the tokens
    replicated over "data", the counts not summed) some expert got more
    pairs than its capacity, max(4, ceil(S * k * cf / E))."""
    port, _ = outputs
    cap = max(4, math.ceil(S * K * 1.0 / E))
    counts = port["replicated_1_counts"]
    assert counts.sum() == S * K and counts.max() > cap, counts
