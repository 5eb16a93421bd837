"""The port's serving loop against the reference's.

``serve("gemma3-1b", smoke=True, ...)`` of the port answers every request
through the ElasticBatcher on the CPU, as ``tests/test_system.py`` asserts
for the reference, and the same request stream (same seed) makes the
batcher run the engine the same number of decode steps in both packages.
Open loop (``rate=``, ``arrival_trace=``) answers every request it
submits, ``trace=`` spills a timeline that ``extract_workload`` reads to
one root task a request, and ``serve_traffic_sim`` equals the reference's
at the same arguments, float for float.
"""
import numpy as np
import pytest
import torch

from repro.launch.serve import serve as jax_serve
from repro.launch.serve import serve_traffic_sim as jax_serve_traffic_sim
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.serve import TorchEngine, serve, serve_traffic_sim
from repro_torch.trace import extract_workload, read_trace
from repro_torch.traffic import generate_stream, save_stream

KW = dict(smoke=True, n_requests=6, n_slots=2, max_seq=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serving_end_to_end_matches_reference():
    rep = serve("gemma3-1b", device="cpu", **KW)
    assert rep["requests"] == 6
    assert rep["engine_decode_steps"] > 0
    assert rep["tok_per_s"] > 0
    assert rep["device"] == "cpu"
    ref = jax_serve("gemma3-1b", **KW)
    assert ref["requests"] == 6
    assert rep["engine_decode_steps"] == ref["engine_decode_steps"]
    assert rep["tokens"] == ref["tokens"]
    assert rep["rounds"] == ref["rounds"]


def test_engine_counts_prefill_and_decodes_all_slots():
    cfg = get_smoke_config("gemma3-1b")
    eng = TorchEngine(cfg, n_slots=3, max_seq=8, device="cpu")
    eng.prefill_chunk(40)
    assert eng.prefill_tokens == 40 and eng.decode_steps == 0
    for _ in range(10):
        eng.decode(1)
    assert eng.decode_steps == 10
    # positions stop at the arena's last row, as in the reference engine
    np.testing.assert_array_equal(eng.pos, [7, 7, 7])
    assert eng.tokens.shape == (3, 1)
    assert ((0 <= eng.tokens) & (eng.tokens < cfg.vocab_size)).all()


def test_unported_paths_raise(tmp_path):
    """The paths that raised before the port had ``traffic`` and
    ``trace.replay`` (open loop, the timeline spill, the traffic sim) now
    run, on the CPU when asked."""
    rep = serve("gemma3-1b", rate=4.0, time_scale=8.0, device="cpu", **KW)
    assert rep["open_loop"] and rep["requests"] == rep["submitted"] > 0
    rep = serve("gemma3-1b", trace=str(tmp_path / "t.jsonl"), device="cpu",
                **KW)
    assert rep["requests"] == 6
    assert (tmp_path / "t.jsonl").stat().st_size > 0
    assert serve_traffic_sim(rate=1.0, horizon_s=10.0)["mode"] == \
        "traffic-sim"


def test_open_loop_answers_every_request_and_its_trace_replays(tmp_path):
    """``serve(rate=...)`` paces a two-tenant MMPP stream onto the engine;
    every request it submits is answered, and the spilled timeline holds
    one root task a request."""
    path = tmp_path / "serve.jsonl"
    rep = serve("gemma3-1b", rate=4.0, n_tenants=2, arrival="mmpp",
                time_scale=8.0, trace=str(path), device="cpu", **KW)
    assert rep["open_loop"] and rep["device"] == "cpu"
    assert rep["submitted"] > 0 and rep["requests"] == rep["submitted"]
    assert rep["ttft_p99"] >= rep["ttft_p50"] > 0
    wl = extract_workload(read_trace(str(path)))
    assert len(wl.roots) == wl.n_tasks == rep["requests"]
    assert wl.n_lost == 0


def test_open_loop_from_a_saved_stream(tmp_path):
    """``arrival_trace=`` replays a saved JSONL stream onto the engine."""
    stream = generate_stream(serve_mod._tenant_mix(2, "poisson", 6.0, 64),
                             horizon_s=1.0, seed=3)
    path = str(tmp_path / "stream.jsonl")
    save_stream(stream, path)
    rep = serve("gemma3-1b", arrival_trace=path, time_scale=4.0,
                device="cpu", **KW)
    assert rep["submitted"] == len(stream) == rep["requests"]


@pytest.mark.parametrize("kw", [
    dict(provider="aws_lambda", rate=4.0, n_tenants=2, horizon_s=60,
         seed=0),
    dict(provider="gcf", rate=6.0, n_tenants=3, arrival="mmpp",
         horizon_s=30, seed=1, slo_ttft_s=0.5),
], ids=["aws_lambda", "gcf_mmpp_slo"])
def test_serve_traffic_sim_equals_the_reference(kw, tmp_path):
    got = serve_traffic_sim(trace=str(tmp_path / "t.jsonl"), **kw)
    assert got == jax_serve_traffic_sim(**kw)
    assert got["completed"] + sum(got["lost"].values()) == got["requests"]
    wl = extract_workload(read_trace(str(tmp_path / "t.jsonl")))
    assert wl.open_loop and wl.n_tasks == got["completed"]


def test_provider_presets_match_the_reference():
    from repro.launch.serve import PROVIDER_PRESETS as JAX_PRESETS
    assert sorted(serve_mod.PROVIDER_PRESETS) == sorted(JAX_PRESETS)
    for name, mk in serve_mod.PROVIDER_PRESETS.items():
        assert vars(mk()) == vars(JAX_PRESETS[name]())


def test_serve_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=None means the CUDA card"):
        serve("gemma3-1b", **KW)


def test_smoke_holds_the_reference_traffic_sim():
    """The report ``chip_smoke.py`` holds the card's ``serve_traffic_sim``
    to is the JAX package's at the same arguments."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.SERVE_SIM_ROW == jax_serve_traffic_sim(
        **smoke.SERVE_SIM_ARGS)
    assert serve_traffic_sim(**smoke.SERVE_SIM_ARGS) == smoke.SERVE_SIM_ROW
