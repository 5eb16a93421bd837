"""The port's step counter (``repro_torch.benchlib.op_analysis``) and the
kernels' work formulas.

The counter's cases are the counterparts of ``tests/test_hlo_analysis.py``
(a loop and a recomputation counted in full, a product's flops exact,
collectives with their ring factors on a fake world of 16, an in-place
cache write costing its update).  The work formulas (``KernelOp.work``
beside each op, the bound helpers of ``repro_torch.benchlib``) must give
``PERF.md``'s Bound column at the table's shapes from shapes alone, to the
printed digits.  On meta and fake tensors each model kernel's CUDA body
returns the plain version's shapes and dtypes without a launch."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.utils.checkpoint as torch_checkpoint

from repro_torch import benchlib
from repro_torch.benchlib.op_analysis import (analyze_step, collective_bytes,
                                              cost_from_ops,
                                              top_bytes_contributors)
from repro_torch.benchlib.roofline import analysis_block
from repro_torch.kernels.dispatch import (dispatch, get_kernel, launches,
                                          resolve_backend)
from repro_torch.kernels.flash_attention.ops import (flash_bound,
                                                     flash_bwd_bound,
                                                     flash_bwd_floor)

ROOT = Path(__file__).resolve().parents[1]
F32, BF16 = torch.float32, torch.bfloat16


def _meta(*shape, dtype=F32):
    return torch.empty(shape, dtype=dtype, device="meta")


# -- the counter: the reference's four cases ---------------------------------

def test_loop_and_recomputation_counted():
    """8 products in a loop count 8 times one; a checkpointed layer's
    recomputation in the backward is counted as well."""
    def model(ws, x):
        for i in range(ws.shape[0]):
            x = torch.tanh(x @ ws[i])
        return x.sum()

    ws, x = torch.ones(8, 128, 128), torch.ones(4, 128)
    cost = analyze_step(model, ws, x)
    one = 2 * 4 * 128 * 128
    assert cost.flops == 8 * one + 8 * 4 * 128 + 1     # products, tanh, sum
    assert cost.transcendentals == 8 * 4 * 128

    def step(w, x, remat):
        w = w.requires_grad_(True)
        f = (lambda y: torch.tanh(y @ w))
        y = torch_checkpoint.checkpoint(f, x, use_reentrant=False) \
            if remat else f(x)
        return torch.autograd.grad(y.sum(), [w])[0]

    plain = analyze_step(step, torch.ones(128, 128), x, False)
    remat = analyze_step(step, torch.ones(128, 128), x, True)
    assert sum(r["n"] for r in remat.ops if r["cat"] == "product") == 3
    # the recomputation adds one product and one tanh
    assert remat.flops - plain.flops == one + 4 * 128
    assert remat.transcendentals == 2 * plain.transcendentals


def test_product_flops_exact():
    cost = analyze_step(lambda a, b: a @ b, torch.ones(64, 32),
                        torch.ones(32, 16))
    assert cost.flops == 2 * 64 * 32 * 16
    assert cost.bytes == 4 * (64 * 32 + 32 * 16 + 64 * 16)


_COLLECTIVES = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.benchlib.op_analysis import analyze_step, collective_bytes
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
node = dist.new_group(list(range(8)))

def step(x):
    dist.all_reduce(x)                                  # 16 ranks: ib
    g = x.new_empty((16 * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(g, x)
    rs = x.new_empty((x.shape[0] // 16,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(rs, x)
    a = torch.empty_like(x)
    dist.all_to_all_single(a, x)
    dist.all_reduce(x, group=node)                      # one node: nvlink
    return x

cost = analyze_step(step, torch.ones(64, 32))
print(json.dumps(collective_bytes(cost)))
dist.destroy_process_group()
"""


def test_collectives_ring_factors_on_a_fake_world():
    """A fake world of 16 in a process of its own: each collective's link
    bytes by the reference's ring factors, and the link its group
    crosses."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _COLLECTIVES], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    got = json.loads(out.stdout.strip().splitlines()[-1])
    x = 64 * 32 * 4
    assert got["counts"] == {"all_reduce": 2, "all_gather": 1,
                             "reduce_scatter": 1, "all_to_all": 1}
    assert got["by_kind"] == {"all_reduce": 2 * (2 * x),
                              "all_gather": 16 * x, "reduce_scatter": x,
                              "all_to_all": x}
    assert got["by_link"] == {"ib": 2 * x + 16 * x + x + x,
                              "nvlink": 2 * x}
    assert got["link_bytes"] == sum(got["by_kind"].values())


def test_in_place_cache_write_costs_its_update():
    """A one-token write into a [B, S, D] cache costs twice the token's
    bytes, not the cache's."""
    def write(cache, x, pos):
        cache[:, pos] = x
        return cache

    cache, x = torch.zeros(4, 4096, 256), torch.ones(4, 256)
    cost = analyze_step(write, cache, x, 17)
    assert cost.bytes == 2 * x.numel() * 4
    idx = analyze_step(lambda c, i, v: c.index_copy_(1, i, v), cache,
                       torch.tensor([17]), torch.ones(4, 1, 256))
    assert idx.bytes == 2 * (4 * 256 * 4 + 8)
    (desc, b), = top_bytes_contributors(cost, 1)
    assert b == cost.bytes and "index_write" in desc


def test_rules_apply_to_saved_records():
    """The per-op records rebuild the same count (``reanalyze``)."""
    cost = analyze_step(lambda a, b: torch.exp(a @ b).sum(),
                        torch.ones(8, 8), torch.ones(8, 8))
    again = cost_from_ops(cost.ops)
    assert analysis_block(again) == analysis_block(cost)
    assert cost.transcendentals == 64
    assert collective_bytes(cost)["counts"] == {}


def test_plain_version_counted_as_its_kernel():
    """On the CPU a kernel op runs its plain version: the counter counts
    the op by its work formula, and none of the plain version's ops."""
    q = torch.randn(4, 64, 16)
    k, v = torch.randn(1, 64, 16), torch.randn(1, 64, 16)
    cost = analyze_step(lambda q, k, v: dispatch(
        "flash_attention_fwd", q, k, v, causal=True), q, k, v)
    assert cost.kernels == {"flash_attention_fwd": 1}
    assert cost.flops == get_kernel("flash_attention_fwd").work(
        q, k, v, causal=True)[0]
    assert [r["op"] for r in cost.ops] == ["flash_attention_fwd"]


# -- the work formulas against PERF.md's Bound column ------------------------

S32 = 32_768

#: (label, q2, k2, v2, causal, window) -> the printed forward bound, ms
_FLASH = [
    ("gemma3-1b global", (4, S32, 256), (1, S32, 256), True, None, "7.78"),
    ("gemma3-1b local", (4, S32, 256), (1, S32, 256), True, 512, "0.241"),
    ("deepseek-moe-16b", (16, S32, 128), (16, S32, 128), True, None,
     "15.55"),
    ("jamba", (32, S32, 128), (8, S32, 128), True, None, "31.10"),
]


@pytest.mark.parametrize("label,qs,ks,causal,window,want", _FLASH,
                         ids=[c[0] for c in _FLASH])
def test_flash_forward_bound(label, qs, ks, causal, window, want):
    q, k, v = _meta(*qs), _meta(*ks), _meta(*ks, dtype=BF16)
    ms, by, _ = flash_bound(q, k, v, causal, window)
    assert by == "operations"
    assert f"{ms:.{len(want.split('.')[1])}f}" == want


def test_flash_forward_bound_mla_unpadded():
    """deepseek-v3's MLA layer at 4,096: q.k 192, v 128, 128 heads."""
    ms, _, _ = flash_bound(_meta(128, 4096, 192), _meta(128, 4096, 192),
                           _meta(128, 4096, 128, dtype=BF16), True, None)
    assert f"{ms:.2f}" == "2.78"


#: (label, query heads, KV heads, D, window) -> bound, floor, at 4,096
_FLASH_BWD = [
    ("global", 4, 1, 256, None, "0.0869", "0.347"),
    ("local", 4, 1, 256, 512, "0.0238", "0.081"),
    ("deepseek-moe-16b", 16, 16, 128, None, "0.1738", "0.694"),
]


@pytest.mark.parametrize("label,hq,hkv,d,window,bound,floor", _FLASH_BWD,
                         ids=[c[0] for c in _FLASH_BWD])
def test_flash_backward_bound_and_floor(label, hq, hkv, d, window, bound,
                                        floor):
    q, k = _meta(hq, 4096, d), _meta(hkv, 4096, d)
    v = _meta(hkv, 4096, d, dtype=BF16)
    ms, _, flops = flash_bwd_bound(q, k, v, True, window)
    assert f"{ms:.4f}" == bound
    assert f"{flash_bwd_floor(q, k, v, True, window)[0]:.3f}" == floor
    o, lse = _meta(hq, 4096, d), _meta(hq, 4096)
    assert get_kernel("flash_attention_bwd").work(
        q, k, v, o, o, lse, causal=True, window=window)[0] == flops


def _scan_args(name, b, s):
    if name.startswith("selective_scan"):
        di, n = 8192, 16
        ops = (_meta(b, s, di), _meta(b, s, di), _meta(b, s, n),
               _meta(b, s, n), _meta(di, n))
        state, ckpt = _meta(b, di, n), _meta(b, di, s // 16 + 1, n)
    else:
        h, hd = 32, 64
        ops = (_meta(b, s, h, hd),) * 4 + (_meta(h, hd),)
        state, ckpt = _meta(b, h, hd, hd), _meta(b, h, s // 16 + 1, hd, hd)
    if name.endswith("_bwd"):
        return ops + (ckpt, _meta(*ops[0].shape), state)
    return ops + (state,)


_SCANS = [("selective_scan", 1, S32, "0.963"), ("wkv6", 1, S32, "0.449"),
          ("selective_scan_bwd", 1, 4096, "0.2415"),
          ("wkv6_bwd", 4, 4096, "0.5227"), ("wkv6_bwd", 1, 4096, "0.1307")]


@pytest.mark.parametrize("name,b,s,want", _SCANS,
                         ids=[f"{c[0]}-B{c[1]}" for c in _SCANS])
def test_scan_bounds(name, b, s, want):
    flops, n_bytes = get_kernel(name).work(*_scan_args(name, b, s))
    ms, _ = benchlib.bound_ms(n_bytes, flops)
    assert f"{ms:.{len(want.split('.')[1])}f}" == want


# -- the traced path: shapes and dtypes without a launch ---------------------

def _small(name):
    """Small operands of each model kernel op on the CPU, and its static
    arguments."""
    g = torch.Generator().manual_seed(0)

    def r(*s, dtype=F32):
        return torch.randn(s, generator=g).to(dtype)

    if name == "flash_attention_fwd":
        return (r(4, 32, 16), r(2, 32, 16), r(2, 32, 16, dtype=BF16)), {
            "causal": True, "window": None, "softcap": None,
            "return_lse": True}
    if name == "flash_attention_bwd":
        return (r(4, 32, 16), r(2, 32, 16), r(2, 32, 16), r(4, 32, 16),
                r(4, 32, 16), r(4, 32)), {"causal": True, "window": None,
                                          "softcap": None}
    if name in ("selective_scan", "selective_scan_bwd"):
        ops = (r(2, 32, 8), r(2, 32, 8).abs(), r(2, 32, 4), r(2, 32, 4),
               -r(8, 4).abs())
        if name == "selective_scan":
            return ops + (r(2, 8, 4),), {}
        return ops + (r(2, 8, 3, 4), r(2, 32, 8), r(2, 8, 4)), {}
    ops = (r(2, 32, 2, 16), r(2, 32, 2, 16), r(2, 32, 2, 16),
           r(2, 32, 2, 16).sigmoid(), r(2, 16))
    if name == "wkv6":
        return ops + (r(2, 2, 16, 16),), {}
    return ops + (r(2, 2, 3, 16, 16), r(2, 32, 2, 16), r(2, 2, 16, 16)), {}


_MODEL_OPS = ("flash_attention_fwd", "flash_attention_bwd", "selective_scan",
              "selective_scan_bwd", "wkv6", "wkv6_bwd")


def _fake_cuda(args):
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        return mode, tuple(torch.empty(a.shape, dtype=a.dtype, device="cuda")
                           for a in args)


@pytest.mark.parametrize("kind", ["meta", "fake_cuda"])
@pytest.mark.parametrize("name", _MODEL_OPS)
def test_traced_kernel_matches_plain_shapes(name, kind):
    """On meta or fake CUDA operands the op takes the hand kernel's branch,
    allocates the plain version's outputs (shapes, dtypes), is counted by
    its work formula, and launches nothing."""
    args, static = _small(name)
    want = get_kernel(name).reference_body(*[a.clone() for a in args],
                                           **static)
    before = launches(name)
    if kind == "meta":
        traced = tuple(a.to("meta") for a in args)
        cost = analyze_step(lambda *a: dispatch(name, *a, **static), *traced)
        got = cost.result
    else:
        mode, traced = _fake_cuda(args)
        with mode:
            got = dispatch(name, *traced, **static)
        cost = None
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert launches(name) == before
    if cost is not None:
        assert cost.kernels == {name: 1}
        assert (cost.flops, cost.bytes) == get_kernel(name).work(*traced,
                                                                 **static)


def test_meta_resolves_to_the_hand_kernel():
    assert resolve_backend(None, torch.device("meta")) == "cuda"
    assert resolve_backend(None, torch.device("cpu")) == "ref"
    with pytest.raises(ValueError):
        resolve_backend("cuda", torch.device("cpu"))


def test_link_classes_of_the_production_mesh():
    """16 x 16, model axis fastest, nodes of 8: a model-axis group spans 2
    nodes, a data-axis group 16; both cross InfiniBand."""
    model = list(range(16))
    data = list(range(0, 256, 16))
    assert benchlib.link_class(model) == "ib"
    assert benchlib.link_class(data) == "ib"
    assert benchlib.link_class(range(8)) == "nvlink"
    assert benchlib.link_class([3]) == "local"
    assert benchlib.link_bw("ib") == benchlib.IB_BW == 50e9
    assert benchlib.link_bw("local") is None

