"""The port's Mariani-Silver against the reference package on the CPU:
the image of ``run_irregular(ms_spec)`` equals the reference's, the
reference's ``naive_render`` and the port's own; the fused body equals
the per-rectangle one; the WAL JSON is the reference's."""
import importlib
import json

import numpy as np
import pytest
import torch

from repro.core import make_pool as jax_make_pool
from repro.core import run_irregular as jax_run_irregular
from repro_torch.algorithms import (MSParams, Rect, evaluate_rect,
                                    evaluate_rects, ms_spec, naive_render)
from repro_torch.convert import image_from_reference, image_to_reference
from repro_torch.core import make_pool, run_irregular

# the package re-exports a function of the same name, so load the module
jax_ms = importlib.import_module("repro.algorithms.mariani_silver")

MS_P = dict(width=64, height=64, max_dwell=48, initial_subdivision=2,
            max_depth=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the CPU; PyTorch's intra-op threads would
    oversubscribe it (the 256x256 dwell test goes from 1 s to minutes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference_image():
    with jax_make_pool("local", max_concurrency=2,
                       invoke_overhead=0.0) as pool:
        r = jax_run_irregular(pool, jax_ms.ms_spec(jax_ms.MSParams(**MS_P)))
    return r.output["image"]


def test_naive_render_matches_reference(reference_image):
    mine = naive_render(MSParams(**MS_P), device="cpu")
    assert mine.dtype == np.int32
    assert np.array_equal(mine,
                          np.asarray(jax_ms.naive_render(jax_ms.MSParams(**MS_P))))
    assert np.array_equal(mine, reference_image)


@pytest.mark.parametrize("kind,cfg,kw", [
    ("local", dict(max_concurrency=3, invoke_overhead=0.0), {}),
    ("local", dict(max_concurrency=3, invoke_overhead=0.0),
     {"batching": True}),
    ("elastic", dict(max_concurrency=8, invoke_overhead=5e-4,
                     invoke_rate_limit=None), {}),
    ("elastic", dict(max_concurrency=8, invoke_overhead=5e-4,
                     invoke_rate_limit=None), {"shards": 2}),
], ids=["local", "local-batching", "elastic", "elastic-shards"])
def test_run_irregular_image_matches_reference(kind, cfg, kw,
                                               reference_image):
    p = MSParams(**MS_P)
    with make_pool(kind, **cfg) as pool:
        r = run_irregular(pool, ms_spec(p, device="cpu"), **kw)
    img = r.output["image"]
    assert img.dtype == np.int32
    assert np.array_equal(img, reference_image)
    assert np.array_equal(img, naive_render(p, device="cpu"))
    assert r.output["filled"] + r.output["evaluated"] == p.width * p.height
    assert r.output["filled"] > 0  # adjacency optimization fired


def _rects(p):
    return [Rect(0, 0, 32, 32, 0), Rect(32, 0, 64, 32, 0),
            Rect(16, 16, 24, 24, 2), Rect(40, 40, 42, 43, 3),
            Rect(0, 32, 32, 64, 0), Rect(30, 28, 34, 36, 3)]


def test_evaluate_rects_equals_evaluate_rect():
    p = MSParams(**MS_P)
    fused = evaluate_rects(_rects(p), p, device="cpu")
    for res, rect in zip(fused, _rects(p)):
        one = evaluate_rect(rect, p, device="cpu")
        assert res.rect == one.rect and res.action is one.action
        assert res.dwell_to_fill == one.dwell_to_fill
        if one.dwell_array is None:
            assert res.dwell_array is None
        else:
            assert np.array_equal(res.dwell_array, one.dwell_array)


def test_evaluate_rect_matches_reference():
    p = MSParams(**MS_P)
    jp = jax_ms.MSParams(**MS_P)
    spec, ref_spec = ms_spec(p, device="cpu"), jax_ms.ms_spec(jp)
    for rect in _rects(p):
        mine = evaluate_rect(rect, p, device="cpu")
        ref = jax_ms.evaluate_rect(jax_ms.Rect(*spec.encode_item(rect)), jp)
        assert json.dumps(spec.encode_result(mine)) \
            == json.dumps(ref_spec.encode_result(ref))
        back = spec.decode_result(ref_spec.encode_result(ref))
        assert back.action is mine.action and back.rect == mine.rect


def test_image_converters_round_trip(reference_image):
    t = image_from_reference(reference_image, device="cpu")
    assert t.dtype == torch.int32
    assert np.array_equal(image_to_reference(t), reference_image)
