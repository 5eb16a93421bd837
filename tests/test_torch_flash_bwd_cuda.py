"""The flash-attention backward kernel on the card (no JAX here).

``flash_attention_bwd_cuda`` (``csrc/flash_attention_bwd.cu``) against its
plain version, autograd over ``flash_attention_ref``, on every dtype pair,
head dim and mask the forward takes, with GQA; the forward's log-sum-exp
output, which must leave ``o`` bit for bit as it was; two runs giving the
same bits; the ``FlashAttention`` autograd function reaching q, k and v
through the model layout (MLA's zero padding included).  The scans'
backward kernels are ``tests/test_torch_recurrent_cuda.py``'s.

Tolerances, each relative to the largest value of the plain version's
gradient: float32 throughout, 1e-4 (both sum in float32, in other orders,
over up to a few hundred keys and heads); with bf16 anywhere, the
operands are also cast to float32 and held at 1e-4 through the kernel's
float32 build (one template for every dtype: the masks, the tiles and the
GQA sums are checked there), and as given within 2**-5: the plain version
rounds p and dP to bf16 before its products (the kernel keeps them in
float32), and dP - Delta cancels, so one bf16 rounding (2**-8) can grow a
few times in dS.

The cases take the kernel's tile edges (63, 64, 65 and 129 rows, and one
query row over 129 keys; G 1, 4 and 8; windows across tiles) and deepseek-moe-16b's layer shape; the
determinism case also runs at gemma3-1b's global layer, where dK and dV
are summed over G = 4 query heads' float32 partials.

Run on the card:
``python -m pytest -q -m cuda tests/test_torch_flash_bwd_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.dispatch import launches
from repro_torch.kernels.flash_attention.ops import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda,
                                                     flash_attention_fused)
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)

F32_REL = 1e-4
BF16_REL = 2**-5

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda", 0)


def _operands(dev, bhkv, g, s, d, qk_dtype, v_dtype, seed, causal=True,
              window=None, softcap=None, skv=None):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    q = rng.standard_normal((bhkv * g, s, d), np.float32) * d ** -0.5
    k = rng.standard_normal((bhkv, skv, d), np.float32)
    v = rng.standard_normal((bhkv, skv, d), np.float32)
    do = rng.standard_normal((bhkv * g, s, d), np.float32)
    q, k = (torch.from_numpy(a).to(dev, qk_dtype) for a in (q, k))
    v = torch.from_numpy(v).to(dev, v_dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    do = torch.from_numpy(do).to(dev, qk_dtype)
    return q, k, v, o, do, lse, kw


def _rel_err(got, want) -> list:
    return [float((a.float() - b.float()).abs().max()
                  / b.float().abs().max().clamp_min(1e-30))
            for a, b in zip(got, want)]


CASES = [
    # qk dtype, v dtype, D, G, S, causal, window, softcap
    (torch.float32, torch.float32, 64, 1, 200, True, None, None),
    (torch.float32, torch.float32, 16, 4, 129, True, 40, None),
    (torch.float32, torch.float32, 32, 2, 77, False, None, 5.0),
    (torch.float32, torch.float32, 128, 2, 300, True, 64, 5.0),
    (torch.bfloat16, torch.bfloat16, 128, 4, 256, True, None, None),
    (torch.bfloat16, torch.bfloat16, 256, 4, 301, True, 50, None),
    (torch.float32, torch.bfloat16, 256, 4, 333, True, None, None),
    (torch.float32, torch.bfloat16, 256, 4, 200, True, 64, 30.0),
    (torch.bfloat16, torch.bfloat16, 32, 1, 100, False, 20, None),
    # the edges of the 64-row fixed tiles and the 16-64-row streamed ones
    (torch.float32, torch.bfloat16, 128, 1, 63, True, None, None),
    (torch.float32, torch.bfloat16, 256, 8, 64, True, None, None),
    (torch.float32, torch.bfloat16, 64, 4, 65, False, None, None),
    (torch.bfloat16, torch.bfloat16, 128, 8, 129, True, None, 5.0),
    (torch.float32, torch.float32, 256, 1, 129, True, None, None),
    # deepseek-moe-16b's layer shape (16 heads of D 128, G 1)
    (torch.float32, torch.bfloat16, 128, 1, 1024, True, None, None),
    # windows that cross the tiles' edges
    (torch.float32, torch.bfloat16, 256, 4, 300, True, 100, None),
    (torch.float32, torch.float32, 64, 8, 257, True, 33, 4.0),
]


@pytest.mark.parametrize("qk_dtype,v_dtype,d,g,s,causal,window,softcap",
                         CASES)
def test_bwd_kernel_matches_plain(dev, qk_dtype, v_dtype, d, g, s, causal,
                                  window, softcap):
    q, k, v, o, do, lse, kw = _operands(dev, 2, g, s, d, qk_dtype, v_dtype,
                                        seed=s + d, causal=causal,
                                        window=window, softcap=softcap)
    got = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    want = flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert bool(torch.isfinite(a.float()).all())
    bf16 = torch.bfloat16 in (qk_dtype, v_dtype)
    assert max(_rel_err(got, want)) <= (BF16_REL if bf16 else F32_REL), \
        _rel_err(got, want)
    if bf16:
        f = [t.float() for t in (q, k, v)]
        o32, lse32 = flash_attention_cuda(*f, return_lse=True, **kw)
        got = flash_attention_bwd_cuda(*f, o32, do.float(), lse32, **kw)
        want = flash_attention_bwd_ref(*f, o32, do.float(), lse32, **kw)
        assert max(_rel_err(got, want)) <= F32_REL, _rel_err(got, want)


@pytest.mark.parametrize("d,g", [(256, 4), (128, 1)])
def test_bwd_kernel_one_query_row(dev, d, g):
    """One query row (Sq = 1, the smallest tile edge) over 129 keys, without
    a causal mask: at Sq = Skv = 1 softmax over one key makes dQ and dK
    exactly 0, where the relative check has no scale."""
    q, k, v, o, do, lse, kw = _operands(dev, 2, g, 1, d, torch.float32,
                                        torch.bfloat16, seed=d, causal=False,
                                        skv=129)
    got = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    want = flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert max(_rel_err(got, want)) <= BF16_REL, _rel_err(got, want)
    f = [t.float() for t in (q, k, v)]
    o32, lse32 = flash_attention_cuda(*f, return_lse=True, **kw)
    got = flash_attention_bwd_cuda(*f, o32, do.float(), lse32, **kw)
    want = flash_attention_bwd_ref(*f, o32, do.float(), lse32, **kw)
    assert max(_rel_err(got, want)) <= F32_REL, _rel_err(got, want)


@pytest.mark.parametrize("qk_dtype,v_dtype,d", [
    (torch.float32, torch.float32, 64), (torch.bfloat16, torch.bfloat16, 256),
    (torch.float32, torch.bfloat16, 256)])
@pytest.mark.parametrize("window,softcap", [(None, None), (40, 5.0)])
def test_lse_leaves_o_unchanged(dev, qk_dtype, v_dtype, d, window, softcap):
    q, k, v, o, _, lse, kw = _operands(dev, 2, 4, 301, d, qk_dtype, v_dtype,
                                       seed=3, window=window,
                                       softcap=softcap)
    plain_o = flash_attention_cuda(q, k, v, **kw)
    _, want_lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, plain_o)
    assert lse.shape == (q.shape[0], q.shape[1])
    torch.testing.assert_close(lse, want_lse, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("bhkv,s,window", [
    (2, 1000, 128),
    # gemma3-1b's global layer at B 1: G = 4 partial sums of dK and dV
    (1, 4096, None)])
def test_bwd_is_deterministic(dev, bhkv, s, window):
    q, k, v, o, do, lse, kw = _operands(dev, bhkv, 4, s, 256, torch.float32,
                                        torch.bfloat16, seed=9, window=window)
    a = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    b = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("dk,dv,g", [(64, 64, 2), (192, 128, 1)])
def test_fused_gradients_reach_q_k_v(dev, dk, dv, g):
    """Through the model layout and ``FlashAttention``: one forward and one
    backward launch, and every operand gets the plain version's gradient
    (MLA's q.k 192 / v 128 padded to 256 and cut back)."""
    rng = np.random.default_rng(dk)
    shapes = ((2, 150, 2, g, dk), (2, 150, 2, dk), (2, 150, 2, dv))
    leaves = [torch.from_numpy(rng.standard_normal(sh, np.float32)).to(dev)
              for sh in shapes]
    leaves[0] = leaves[0] * dk ** -0.5
    grads = []
    for backend in (None, "ref"):
        ts = [t.clone().requires_grad_() for t in leaves]
        f0 = launches("flash_attention_fwd")
        b0 = launches("flash_attention_bwd")
        out = flash_attention_fused(*ts, window=64, backend=backend)
        out.square().sum().backward()
        if backend is None:
            assert launches("flash_attention_fwd") == f0 + 1
            assert launches("flash_attention_bwd") == b0 + 1
        else:
            assert launches("flash_attention_bwd") == b0
        grads.append([t.grad for t in ts])
    torch.cuda.synchronize()
    assert all(g is not None for g in grads[0])
    assert max(_rel_err(grads[0], grads[1])) <= F32_REL
