"""The port's serving loop against the reference's.

``serve("gemma3-1b", smoke=True, ...)`` of the port answers every request
through the ElasticBatcher on the CPU, as ``tests/test_system.py`` asserts
for the reference, and the same request stream (same seed) makes the
batcher run the engine the same number of decode steps in both packages.
"""
import numpy as np
import pytest
import torch

from repro.launch.serve import serve as jax_serve
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import TorchEngine, serve, serve_traffic_sim

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


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        serve("gemma3-1b", rate=2.0, device="cpu", **KW)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        serve("gemma3-1b", trace="t.jsonl", device="cpu", **KW)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        serve_traffic_sim(rate=1.0)


def test_serve_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=None means the CUDA card"):
        serve("gemma3-1b", **KW)
