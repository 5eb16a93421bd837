"""The port's sharding rule engine against ``repro.runtime.sharding``,
with no devices (the reference's own ``FakeMesh``): every leaf's spec,
the degraded list, the batch and cache specs and ``zero_extend``, spec
for spec (their strings, which checkpoint manifests store), for all 10
full configs on the single-pod 16 x 16 and multi-pod 2 x 16 x 16 meshes,
with FSDP on and off.  The rules run on the stacked layout (each stage's
leaves with a leading period axis, as ``convert.params_to_jax`` stacks
them); the port's own per-period layout gets the stacked specs without
their leading ``None``.  Then port twins of the reference's seven tests
in ``tests/test_sharding_rules.py``."""
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCH_IDS, SHAPES, get_config as jax_config
from repro.launch.specs import abstract_cache as jax_cache
from repro.launch.specs import abstract_params as jax_params
from repro.launch.specs import input_specs as jax_inputs
from repro.runtime import sharding as jsh
from repro_torch.configs import get_config
from repro_torch.launch.specs import (abstract_cache, abstract_params,
                                      input_specs)
from repro_torch.runtime import sharding as tsh
from repro_torch.runtime.sharding import P

MESHES = {"pod": {"data": 16, "model": 16},
          "multi_pod": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _policies(mesh: str, fsdp: bool):
    shape = MESHES[mesh]
    dp = ("pod", "data") if "pod" in shape else ("data",)
    fs = "data" if fsdp else None
    return (jsh.prepare(jsh.ShardingPolicy(dp_axes=dp, fsdp_axis=fs),
                        FakeMesh(shape)),
            tsh.prepare(tsh.ShardingPolicy(dp_axes=dp, fsdp_axis=fs),
                        FakeMesh(shape)))


def _jflat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]}


def _tflat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_tflat(tree[k], prefix + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, t in enumerate(tree):
            out.update(_tflat(t, prefix + (str(i),)))
        return out
    return {"/".join(prefix): tree}


def _stacked(tree):
    """The port's per-period tree -> the stacked layout (meta tensors)."""
    def stack(periods):
        first = periods[0]
        if isinstance(first, dict):
            return {k: stack([p[k] for p in periods]) for k in first}
        return torch.empty((len(periods),) + tuple(first.shape),
                           dtype=first.dtype, device="meta")
    return {k: stack(v) if isinstance(v, list) else v
            for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _shapes(arch: str):
    return jax_params(jax_config(arch)), abstract_params(get_config(arch))


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch, mesh, fsdp):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    jshapes, tshapes = _shapes(arch)
    jp, tp = _policies(mesh, fsdp)
    want = {k: str(v) for k, v in _jflat(jsh.param_specs(jshapes, jp,
                                                          jcfg)).items()}
    got = {k: str(v) for k, v in _tflat(tsh.param_specs(
        _stacked(tshapes), tp, tcfg)).items()}
    assert got == want
    assert tp.degraded == jp.degraded
    # zero_extend over every leaf's spec, on the data axis
    jleaves = _jflat(jshapes)
    for name, spec in _jflat(jsh.param_specs(jshapes, jp, jcfg)).items():
        shape = tuple(jleaves[name].shape)
        assert str(tsh.zero_extend(P(*spec), shape, "data", 16)) == \
            str(jsh.zero_extend(spec, shape, "data", 16)), name


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_specs_match_reference(arch, mesh, fsdp):
    jcfg, tcfg = jax_config(arch), get_config(arch)
    jp, tp = _policies(mesh, fsdp)
    for shape in SHAPES.values():
        want = {k: str(v) for k, v in _jflat(jsh.batch_specs(
            jax_inputs(jcfg, shape), jp)).items()}
        got = {k: str(v) for k, v in _tflat(tsh.batch_specs(
            input_specs(tcfg, shape), tp)).items()}
        assert got == want, shape.name
        if shape.kind != "decode":
            continue
        want = {k: str(v) for k, v in _jflat(jsh.cache_specs(jax_cache(
            jcfg, shape.global_batch, shape.seq_len), jp)).items()}
        got = {k: str(v) for k, v in _tflat(tsh.cache_specs(_stacked(
            abstract_cache(tcfg, shape.global_batch, shape.seq_len)),
            tp)).items()}
        assert got == want, shape.name


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-v0.1-52b",
                                  "gemma3-1b"])
def test_unstacked_specs_are_stacked_without_the_period_axis(arch):
    """The port's per-period layout: every period of a stage gets the
    stacked spec without its leading entry, and the degraded list is the
    stacked layout's; the cache likewise."""
    cfg = get_config(arch)
    _, tshapes = _shapes(arch)
    _, tp1 = _policies("pod", True)
    _, tp2 = _policies("pod", True)
    stacked = _tflat(tsh.param_specs(_stacked(tshapes), tp1, cfg))
    per = tsh.param_specs(tshapes, tp2, cfg)
    assert tp1.degraded == tp2.degraded
    for name, spec in _tflat(per).items():
        head, *rest = name.split("/")
        if head.startswith("stage"):
            want = stacked["/".join([head] + rest[1:])]
            assert spec == P(*list(want)[1:]), name
        else:
            assert spec == stacked[name], name
    assert tsh.stack_specs(per) == tsh.param_specs(_stacked(tshapes), tp1,
                                                   cfg)
    c = abstract_cache(cfg, 128, 1024)
    cs = _tflat(tsh.cache_specs(c, tp1))
    cstacked = _tflat(tsh.cache_specs(_stacked(c), tp1))
    for name, spec in cs.items():
        head, _, *rest = name.split("/")
        assert spec == P(*list(cstacked["/".join([head] + rest)])[1:])


def test_abstract_params_allocate_nothing():
    shapes = abstract_params(get_config("deepseek-v3-671b"))
    leaves = list(_tflat(shapes).values())
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) > 6e11


# -- port twins of tests/test_sharding_rules.py --------------------------------

def _policy(tp=16, data=16, fsdp=True):
    p = tsh.ShardingPolicy(fsdp_axis="data" if fsdp else None)
    p._tp_size = tp
    p._dp_size = data
    p._fsdp_size = data
    return p


def _specs(arch, policy=None):
    cfg = get_config(arch)
    return _tflat(tsh.param_specs(_stacked(_shapes(arch)[1]),
                                  policy or _policy(), cfg))


def test_glm4_specs_head_aligned():
    policy = _policy()
    specs = _tflat(tsh.param_specs(_stacked(_shapes("glm4-9b")[1]), policy,
                                   get_config("glm4-9b")))
    assert specs["stage0/block0/mixer/wq/w"][-1] == "model"
    assert specs["stage0/block0/mixer/wk/w"][-1] != "model"
    assert any("wk" in d for d in policy.degraded)
    assert specs["stage0/block0/ffn/up/w"][-1] == "model"
    assert specs["stage0/block0/ffn/down/w"][-2] == "model"
    assert specs["embed/table"][0] == "model"


def test_gemma3_tiny_heads_degrade():
    specs = _specs("gemma3-1b")
    assert specs["stage0/block0/mixer/wq/w"][-1] != "model"
    assert specs["stage0/block0/ffn/up/w"][-1] == "model"


def test_moe_expert_stacks_sharded():
    specs = _specs("deepseek-v3-671b")
    assert specs["stage1/block0/ffn/gate"][1] == "model"
    assert "data" in tuple(specs["stage1/block0/ffn/gate"])


def test_no_axis_used_twice():
    for arch in ("glm4-9b", "deepseek-v3-671b", "jamba-v0.1-52b",
                 "rwkv6-1.6b"):
        for path, spec in _specs(arch).items():
            flat = [a for e in spec for a in tsh.spec_axes(e)]
            assert len(flat) == len(set(flat)), (path, spec)


def test_batch_specs_divisibility():
    policy = _policy()
    meta = torch.empty((256, 128), dtype=torch.int32, device="meta")
    ok = tsh.batch_specs({"tokens": meta}, policy)
    assert ok["tokens"][0] in ("data", ("data",))
    bad = tsh.batch_specs({"tokens": meta[:1]}, policy)
    assert bad["tokens"][0] is None


def test_cache_specs_batch_then_seq():
    policy = _policy()
    spec = tsh.cache_specs({"mixer": {"k": torch.empty(
        (4, 128, 1024, 2, 64), device="meta")}}, policy)
    assert spec["mixer"]["k"][1] == "data"
    spec = tsh.cache_specs({"mixer": {"k": torch.empty(
        (4, 1, 1024, 2, 64), device="meta")}}, policy)
    assert spec["mixer"]["k"][2] == "data"


def test_zero_extend():
    assert tsh.zero_extend(P(None, "model"), (64, 32), "data", 16) \
        == P("data", "model")
    assert tsh.zero_extend(P(None), (7,), "data", 16) == P(None)
    assert str(P(("pod", "data"), None)) == \
        str(JP(("pod", "data"), None))
