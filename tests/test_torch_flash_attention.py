"""The port's flash attention against the reference package.

The plain PyTorch version (what ``flash_attention_fused`` runs on CPU
tensors) against the JAX ``flash_attention_ref`` and the Pallas kernel in
interpret mode, on the shapes of ``tests/test_flash_kernel.py``, in
float32 to the tolerance the JAX tests use (``atol=3e-5, rtol=1e-4``).
Also the [B, S, Hkv, G, D] <-> [BHG, S, D] layout moves, the soft-cap
(which the Pallas kernel lacks) against a float64 numpy oracle, and the
row blocks, and the pair of dtypes a bf16 model feeds it (float32 q and
k, bf16 v).  The kernel's scheme for float32 products on the tensor
cores (three TF32 passes) is emulated against the float32 plain version.
Training: the ``FlashAttention`` autograd function's gradients on the CPU
against ``jax.grad`` of the reference model's flash (causal, window,
soft-cap, GQA, MLA's zero padding), and the plain version's row
log-sum-exp against a float64 oracle.  The tests marked ``cuda`` hold the
hand kernel against the plain version and need the card (the backward
kernel's are in ``tests/test_torch_flash_bwd_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import \
    flash_attention_fused as jax_flash_fused
from repro.models.attention import flash_attention as jax_model_flash
from repro_torch.kernels.dispatch import (compile_log, dispatch, get_kernel,
                                          registered_kernels,
                                          reset_compile_log)
from repro_torch.kernels.flash_attention.ops import (flash_attention_cuda,
                                                     flash_attention_fused,
                                                     kernel_tiles)
from repro_torch.kernels.flash_attention import ref as ref_module
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.attention import flash_attention

ATOL, RTOL = 3e-5, 1e-4

SHAPES = [
    (1, 64, 1, 1, 16, 16, None, 16, 16),
    (2, 48, 2, 2, 8, 8, None, 16, 16),
    (1, 80, 1, 2, 16, 8, 24, 16, 16),   # sliding window + GQA
    (1, 33, 1, 1, 8, 8, None, 16, 8),   # ragged S (padding path)
    (1, 64, 1, 1, 16, 16, 8, 32, 16),   # narrow window
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, s, hkv, g, dk, dv, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, s, hkv, g, dk)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((b, s, hkv, dk)) * 0.3).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dv)).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def _bf16_allowed(want: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Per-element bound for two versions that each round every p_j to bf16
    once (at any scale) and their output once: with u = 2**-8 and
    weight = sum_j p_j |v_j|, |got - want| <= u (2 weight + |want| + |got|),
    solved for the error, plus the float32 tolerance for the scores' sums."""
    u = 2**-8
    return 2 * u * (weight.float() + want.float().abs()) / (1 - u) + ATOL


def _oracle(q, k, v, *, causal=True, window=None, softcap=None):
    """float64 direct softmax attention in the model layout."""
    b, s, hkv, g, _ = q.shape
    skv = k.shape[1]
    sc = np.einsum("bqhgd,bkhd->bhgqk", q.astype(np.float64),
                   k.astype(np.float64))
    if softcap is not None:
        sc = softcap * np.tanh(sc / softcap)
    qp, kp = np.arange(s)[:, None], np.arange(skv)[None, :]
    mask = np.ones((s, skv), bool)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    sc = np.where(mask, sc, -np.inf)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhgqk,bkhd->bqhgd", p, v.astype(np.float64))


@pytest.mark.parametrize("b,s,hkv,g,dk,dv,window,qc,kc", SHAPES)
def test_plain_matches_jax_ref_and_interpret(b, s, hkv, g, dk, dv, window,
                                             qc, kc):
    q, k, v = _inputs(b, s, hkv, g, dk, dv, seed=s + (window or 0))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want_ref = np.asarray(jax_flash_fused(jq, jk, jv, window=window,
                                          backend="ref"))
    want_int = np.asarray(jax_flash_fused(jq, jk, jv, window=window,
                                          q_chunk=qc, kv_chunk=kc,
                                          backend="interpret"))
    got = flash_attention_fused(*_t(q, k, v), window=window, q_chunk=qc,
                                kv_chunk=kc).numpy()
    assert got.shape == (b, s, hkv, g, dv)
    np.testing.assert_allclose(got, want_ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, want_int, atol=ATOL, rtol=RTOL)


def test_model_flash_matches_jax_model_path():
    """The port's ``models.attention.flash_attention`` (what every prefill
    layer runs) against the reference model's XLA triangular flash."""
    q, k, v = _inputs(2, 40, 2, 2, 8, 8, seed=7)
    for window in (None, 16):
        want = np.asarray(jax_model_flash(
            *(jnp.asarray(a) for a in (q, k, v)), window=window,
            q_chunk=16, kv_chunk=8))
        got = flash_attention(*_t(q, k, v), window=window).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dk,dv,padded", [(12, 8, 16), (24, 16, 32),
                                           (192, 128, 256), (40, 40, 64)])
def test_unbuilt_head_dims_are_zero_padded(dk, dv, padded):
    """Head dims the kernel is not built for (MLA's q.k 192 and v 128)
    go to it zero-padded to the next one it is, on either backend, and
    the output is cut back to v's: the same values as the reference
    model's flash, which takes Dk != Dv itself."""
    from repro_torch.kernels.flash_attention.ops import padded_head_dim
    assert padded_head_dim(dk, dv) == padded
    assert padded_head_dim(128, 128) == 128 and padded_head_dim(300, 8) == 300
    q, k, v = _inputs(1, 24, 2, 2, dk, dv, seed=dk)
    want = np.asarray(jax_model_flash(*(jnp.asarray(a) for a in (q, k, v)),
                                      q_chunk=8, kv_chunk=8))
    reset_compile_log("flash_attention_fwd")
    got = flash_attention_fused(*_t(q, k, v))
    sigs = compile_log("flash_attention_fwd")["flash_attention_fwd"]
    assert {tuple(shape[-1] for shape, _ in sig) for _, _, sig in sigs} \
        == {(padded, padded, padded)}
    assert got.shape == (1, 24, 2, 2, dv)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(flash_attention(*_t(q, k, v)).numpy(), want,
                               atol=ATOL, rtol=RTOL)


def test_layout_round_trip_is_per_head_attention():
    """[B, S, Hkv, G, D] -> [BHG, S, D] -> back: each (b, h, g) of the
    fused call equals the plain version run on that one head alone."""
    b, s, hkv, g, d = 2, 24, 2, 3, 8
    q, k, v = _t(*_inputs(b, s, hkv, g, d, d, seed=3))
    out = flash_attention_fused(q, k, v, window=10)
    assert out.shape == (b, s, hkv, g, d)
    for bi in range(b):
        for h in range(hkv):
            for gi in range(g):
                one = flash_attention_ref(
                    q[bi, :, h, gi][None].contiguous(),
                    k[bi, :, h][None].contiguous(),
                    v[bi, :, h][None].contiguous(), window=10)[0]
                torch.testing.assert_close(out[bi, :, h, gi], one,
                                           atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("window", [None, 12])
def test_softcap_on_plain_path(window):
    q, k, v = _inputs(1, 30, 1, 2, 8, 8, seed=5)
    q = q * 10.0                       # scores well past the cap
    got = flash_attention_fused(*_t(q, k, v), window=window,
                                softcap=2.0).numpy()
    want = _oracle(q, k, v, window=window, softcap=2.0)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    uncapped = flash_attention_fused(*_t(q, k, v), window=window).numpy()
    assert np.abs(uncapped - got).max() > 1e-2


@pytest.mark.parametrize("causal,window", [(True, None), (True, 7),
                                           (False, None)])
def test_plain_row_blocks_change_nothing(causal, window, monkeypatch):
    q, k, v = _inputs(1, 37, 2, 2, 8, 8, seed=11)
    q2 = torch.from_numpy(q).permute(0, 2, 3, 1, 4).reshape(4, 37, 8)
    k2 = torch.from_numpy(k).permute(0, 2, 1, 3).reshape(2, 37, 8)
    v2 = torch.from_numpy(v).permute(0, 2, 1, 3).reshape(2, 37, 8)
    whole = flash_attention_ref(q2, k2, v2, causal=causal, window=window)
    # a score budget of 4 heads x 5 rows x 37 keys: blocks of 5 rows
    monkeypatch.setattr(ref_module, "_SCORE_BUDGET", 4 * 5 * 37)
    blocks = flash_attention_ref(q2, k2, v2, causal=causal, window=window)
    torch.testing.assert_close(blocks, whole, atol=1e-6, rtol=1e-6)
    want = _oracle(q, k, v, causal=causal, window=window)
    got = whole.reshape(1, 2, 2, 37, 8).permute(0, 3, 1, 2, 4).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_plain_bf16_matches_jax_ref():
    """bfloat16 operands: p is cast to v's dtype before the PV product and
    the output is in q's dtype, as in the JAX oracle.  Tolerance: two bf16
    roundings (2**-8 relative each) of outputs of magnitude below 2."""
    q, k, v = _inputs(1, 48, 1, 2, 16, 16, seed=13)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jax_flash_fused(jq, jk, jv, window=20, backend="ref"),
                      np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention_fused(tq, tk, tv, window=20)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 * 2**-7,
                               rtol=0)


def test_plain_mixed_dtypes_match_jax_ref():
    """float32 q and k with bf16 v, as a bf16 model feeds attention (its
    RoPE returns float32): scores in float32, p cast to bf16, output in q's
    dtype, as in the JAX oracle."""
    q, k, v = _inputs(1, 40, 1, 4, 32, 32, seed=17)
    want = np.array(jax_flash_fused(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v, jnp.bfloat16),
                                    window=24, backend="ref"))
    tq, tk, tv = _t(q, k, v)
    got = flash_attention_fused(tq, tk, tv.to(torch.bfloat16), window=24)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    weight = flash_attention_fused(tq, tk, tv.to(torch.bfloat16).float().abs(),
                                   window=24)
    want = torch.from_numpy(want)
    assert bool(((got - want).abs() <= _bf16_allowed(want, weight)).all())


def test_registration_has_no_elastic_axes():
    assert "flash_attention_fwd" in registered_kernels()
    op = get_kernel("flash_attention_fwd")
    assert op.arg_dims == ((), (), ()) and op.out_dims == ()
    q, k, v = _t(*_inputs(1, 20, 1, 2, 8, 8, seed=1))
    q2 = q.permute(0, 2, 3, 1, 4).reshape(2, 20, 8).contiguous()
    k2 = k.permute(0, 2, 1, 3).reshape(1, 20, 8).contiguous()
    v2 = v.permute(0, 2, 1, 3).reshape(1, 20, 8).contiguous()
    dispatch("flash_attention_fwd", q2, k2, v2, causal=True, window=None,
             softcap=None)
    sigs = {sig for (backend, _, sig) in compile_log("flash_attention_fwd")[
        "flash_attention_fwd"] if backend == "ref"}
    assert (((2, 20, 8), "torch.float32"), ((1, 20, 8), "torch.float32"),
            ((1, 20, 8), "torch.float32")) in sigs


def test_cuda_body_refuses_cpu_tensors():
    q, k, v = _t(*_inputs(1, 16, 1, 1, 64, 64, seed=2))
    q2, k2, v2 = q[:, :, 0, 0], k[:, :, 0], v[:, :, 0]
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_cuda(q2.contiguous(), k2.contiguous(),
                             v2.contiguous())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention_fused(q, k, v, backend="cuda")


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 rounded to TF32's 10 mantissa bits,
    ties away from zero, as integer rounding of the low 13 bits."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _qk_one_tf32(q, kt):
    """q.k^T as one TF32 pass: both operands rounded, the rest exact."""
    return (_tf32_rna(q).double() @ _tf32_rna(kt).double()).float()


def _qk_three_tf32(q, kt):
    """q.k^T as the kernel forms a float32 product: x = hi + lo, both TF32,
    hi.lo + lo.hi + hi.hi (lo.lo dropped), the rest exact."""
    qh, kh = _tf32_rna(q), _tf32_rna(kt)
    ql, kl = _tf32_rna(q - qh), _tf32_rna(kt - kh)
    qh, kh, ql, kl = (t.double() for t in (qh, kh, ql, kl))
    return (qh @ kl + ql @ kh + qh @ kh).float()


def _causal_attention_with(product, q, k, v):
    """The plain version's arithmetic on one KV head (float32 scores, the
    causal mask, softmax, p.v in float32) with q.k^T formed by
    ``product``."""
    s = product(q, k[0].T)
    n = s.shape[-1]
    live = torch.ones(n, n, dtype=torch.bool).tril()
    return torch.softmax(torch.where(live, s, ref_module.NEG_INF), -1) @ v[0]


@pytest.fixture(scope="module")
def main_path_scale():
    """Causal, S = 1024, D = 256, G = 4 on one KV head, at the operand
    scales ``chip_smoke.py`` uses (q pre-scaled by D**-0.5), with the
    float32 plain version's output and its tolerance."""
    rng = np.random.default_rng(21)
    s, d = 1024, 256
    q = torch.from_numpy(
        (rng.standard_normal((4, s, d)) * d ** -0.5).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, s, d)).astype(np.float32))
            for _ in range(2))
    want = flash_attention_ref(q, k, v, causal=True)
    return q, k, v, want, ATOL + RTOL * want.abs()


def test_three_tf32_passes_hold_the_float32_tolerance(main_path_scale):
    q, k, v, want, allowed = main_path_scale
    got = _causal_attention_with(_qk_three_tf32, q, k, v)
    assert float(((got - want).abs() / allowed).max()) <= 0.1


def test_single_pass_tf32_misses_the_float32_tolerance(main_path_scale):
    """Why the kernel pays three passes: one TF32 pass of q.k^T (what a
    float32 wgmma does alone) misses the float32 tolerance."""
    q, k, v, want, allowed = main_path_scale
    got = _causal_attention_with(_qk_one_tf32, q, k, v)
    assert float(((got - want).abs() / allowed).max()) > 1


def _product(a, b, passes: int):
    """a @ b in float64 as the backward kernel forms a float32 product: one
    TF32 pass (both operands rounded), or three (hi.lo + lo.hi + hi.hi)."""
    if passes == 1:
        return _tf32_rna(a).double() @ _tf32_rna(b).double()
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    ah, bh, al, bl = (t.double() for t in (ah, bh, al, bl))
    return ah @ bl + al @ bh + ah @ bh


def _bf16(x):
    return x.to(torch.bfloat16).double()


def _emulated_backward(q, k, v, o, dout, *, mixed: bool, grad_passes: int):
    """(dq, dk, dv) of causal attention on one KV head with the backward
    kernel's rounding, the rest exact (float64): s = q.k^T in three TF32
    passes; p = exp(s - lse); with ``mixed`` (bf16 v) dO and p rounded to
    bf16 for dP = dO v^T and dV = p^T dO, which are then exact, else those
    two in three TF32 passes; Delta over the dO that dP takes; dS = p (dP -
    Delta); dQ = dS k and dK = dS^T q (summed over the G heads) in
    ``grad_passes`` TF32 passes."""
    kt, vt = k[0], v[0].float()
    s = _product(q, kt.T, 3)
    n = s.shape[-1]
    live = torch.ones(n, n, dtype=torch.bool).tril()
    s = torch.where(live, s, -torch.inf)
    p = torch.exp(s - torch.logsumexp(s, -1, keepdim=True))
    if mixed:
        do = _bf16(dout)
        dp = do @ vt.double().T
        dv = (_bf16(p).transpose(1, 2) @ do).sum(0)
    else:
        do = dout.double()
        dp = _product(dout, vt.T, 3)
        dv = _product(p.float().transpose(1, 2), dout, 3).sum(0)
    ds = p * (dp - (do * o.double()).sum(-1, keepdim=True))
    dq = _product(ds.float(), kt, grad_passes)
    dk = _product(ds.float().transpose(1, 2), q, grad_passes).sum(0)
    return dq, dk[None], dv[None]


@pytest.mark.parametrize("case,mixed,grad_passes,allowed", [
    ("float32", False, 3, 1e-4),
    ("float32 q/k, bf16 v", True, 3, 2**-5),
    ("float32, one TF32 pass for dQ and dK", False, 1, None),
])
def test_backward_precision_plan(main_path_scale, case, mixed, grad_passes,
                                 allowed):
    """The backward kernel's precision plan, emulated at the main path's
    scale (causal, S 1,024, D 256, G 4), against autograd over the float32
    plain version, each of dQ, dK, dV by its largest |value|: within the
    card tests' float32 tolerance (1e-4) where every product is three TF32
    passes, within the bf16 one (2**-5) in the model's build (float32 q
    and k, bf16 v), which rounds p and dO to bf16 only where the plain
    version does (dV and dP).  With one TF32 pass for dQ and dK instead of
    three, the float32 case misses 1e-4 (dQ 5.1e-4, dK 2.8e-4 here, against
    7e-7 with three; the model's build reads 3.4e-3 either way, its bf16
    dP and dV's rounding): why the kernel pays three."""
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_bwd_ref
    q, k, v, _, _ = main_path_scale
    if mixed:
        v = v.to(torch.bfloat16)
    dout = torch.from_numpy(np.random.default_rng(22).standard_normal(
        q.shape).astype(np.float32))
    o, lse = flash_attention_ref(q, k, v, causal=True, return_lse=True)
    want = flash_attention_bwd_ref(q, k, v, o, dout, lse, causal=True)
    got = _emulated_backward(q, k, v, o, dout, mixed=mixed,
                             grad_passes=grad_passes)
    err = [float((a - b.double()).abs().max() / b.double().abs().max())
           for a, b in zip(got, want)]
    if allowed is not None:
        assert max(err) <= allowed, err
    else:
        assert min(err[:2]) > 1e-4, err


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1 + 2.0 ** -10                     # a TF32 value: 10 mantissa bits
    x = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12,
                      one + 2.0 ** -11, 1 + 3 * 2.0 ** -12],
                     dtype=torch.float32)
    want = torch.tensor([one, -one, 1.0, one + 2.0 ** -10, one],
                        dtype=torch.float32)
    assert torch.equal(_tf32_rna(x), want)


# -- training: the autograd function and the forward's log-sum-exp ----------

GRAD_CASES = [
    # b, s, hkv, g, dk, dv, window, softcap
    (1, 40, 1, 1, 16, 16, None, None),      # causal
    (2, 33, 2, 2, 8, 8, 12, None),          # window, GQA, ragged S
    (1, 48, 1, 4, 16, 16, None, 5.0),       # softcap, G = 4
    (1, 30, 2, 1, 24, 16, 10, 4.0),         # MLA's unbuilt dims, padded
]


@pytest.mark.parametrize("b,s,hkv,g,dk,dv,window,softcap", GRAD_CASES)
def test_flash_gradients_match_jax_model_flash(b, s, hkv, g, dk, dv, window,
                                               softcap):
    """``FlashAttention`` (what ``flash_attention_fused`` runs when an
    operand requires grad; on the CPU its backward is autograd over the
    plain version, zero padding included) against ``jax.grad`` of the
    reference model's flash (XLA's chunked flash, what its
    ``attention_train`` differentiates), float32, at the reference's
    3e-5 + 1e-4 |value| on q, k and v's gradients."""
    import jax
    q, k, v = _inputs(b, s, hkv, g, dk, dv, seed=s + dk)
    w = np.random.default_rng(s).standard_normal(
        (b, s, hkv, g, dv)).astype(np.float32)

    def jax_loss(q, k, v):
        out = jax_model_flash(q, k, v, window=window, softcap=softcap,
                              q_chunk=16, kv_chunk=8)
        return (out * w).sum()

    want = jax.grad(jax_loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    ts = [t.requires_grad_() for t in _t(q, k, v)]
    out = flash_attention_fused(*ts, window=window, softcap=softcap)
    assert out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    for t, jg in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg),
                                   atol=ATOL, rtol=RTOL)


def test_plain_lse_is_the_rows_logsumexp():
    """The plain version's ``return_lse`` (what the CUDA forward writes for
    its backward) against a float64 oracle, masks and soft-cap included;
    the output does not change with it."""
    q, k, v = _inputs(1, 37, 1, 2, 8, 8, seed=4)
    q2 = torch.from_numpy(q).permute(0, 2, 3, 1, 4).reshape(2, 37, 8)
    k2 = torch.from_numpy(k).permute(0, 2, 1, 3).reshape(1, 37, 8)
    v2 = torch.from_numpy(v).permute(0, 2, 1, 3).reshape(1, 37, 8)
    kw = dict(causal=True, window=9, softcap=3.0)
    out, lse = flash_attention_ref(q2, k2, v2, return_lse=True, **kw)
    assert torch.equal(out, flash_attention_ref(q2, k2, v2, **kw))
    sc = np.einsum("hqd,kd->hqk", q2.double().numpy(), k2[0].double().numpy())
    sc = 3.0 * np.tanh(sc / 3.0)
    i, j = np.arange(37)[:, None], np.arange(37)[None, :]
    sc = np.where((i >= j) & (i - j < 9), sc, -np.inf)
    want = np.log(np.exp(sc - sc.max(-1, keepdims=True)).sum(-1)) + \
        sc.max(-1)
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=1e-6)


def test_backward_op_registered_and_refuses_cpu_tensors():
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention_bwd_cuda, flash_attention_bwd_ref)
    assert "flash_attention_bwd" in registered_kernels()
    op = get_kernel("flash_attention_bwd")
    assert op.reference_body is flash_attention_bwd_ref
    assert op.arg_dims == ((),) * 6 and op.out_dims == ()
    q = torch.zeros(2, 16, 16)
    k = torch.zeros(1, 16, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd_cuda(q, k, k, q, q, torch.zeros(2, 16))


def test_no_grad_path_skips_the_autograd_function():
    """Inference (no operand requires grad, or grad disabled) goes straight
    to the forward op: nothing is kept for a backward."""
    ts = [t.requires_grad_() for t in _t(*_inputs(1, 20, 1, 2, 8, 8,
                                                   seed=3))]
    with torch.no_grad():
        assert flash_attention_fused(*ts).grad_fn is None
    assert flash_attention_fused(*(t.detach() for t in ts)).grad_fn is None
    assert flash_attention_fused(*ts).grad_fn is not None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("qk_dtype,v_dtype,d", [
    (torch.float32, torch.float32, 64), (torch.bfloat16, torch.bfloat16, 128),
    (torch.bfloat16, torch.bfloat16, 256), (torch.float32, torch.bfloat16, 256),
    (torch.float32, torch.float32, 16), (torch.bfloat16, torch.bfloat16, 32)])
@pytest.mark.parametrize("s,window,softcap", [(200, None, None),
                                              (333, 64, None),
                                              (130, None, 5.0),
                                              # Skv not a multiple of the
                                              # key tile
                                              (301, None, None),
                                              # rows whose first live key
                                              # tile is wholly masked
                                              (300, 40, None)])
def test_cuda_kernel_matches_plain(cuda_device, qk_dtype, v_dtype, d, s,
                                   window, softcap):
    q, k, v = _inputs(2, s, 1, 4, d, d, seed=s)
    tq, tk = (torch.from_numpy(a).to(cuda_device, qk_dtype)
              for a in (q * d ** -0.5 / 0.3, k / 0.3))
    tv = torch.from_numpy(v).to(cuda_device, v_dtype)
    got = flash_attention_fused(tq, tk, tv, window=window, softcap=softcap)
    want = flash_attention_fused(tq, tk, tv, window=window, softcap=softcap,
                                 backend="ref")
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == qk_dtype
    if v_dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    else:
        weight = flash_attention_fused(tq.float(), tk.float(),
                                       tv.float().abs(), window=window,
                                       softcap=softcap, backend="ref")
        assert bool(((got.float() - want.float()).abs()
                     <= _bf16_allowed(want, weight)).all())


def _trap_rows(s: int, window: int, tiles: tuple) -> list:
    """Rows whose first live key tile in the kernel is wholly masked."""
    bq, bk = tiles
    return [r for r in range(s)
            if r - window + 1 > max(0, r // bq * bq - window + 1) // bk * bk
            + bk - 1]


@pytest.mark.cuda
def test_cuda_edge_cases_fall_on_the_kernel_tiles(cuda_device):
    """The last two cases of ``test_cuda_kernel_matches_plain`` reach the
    edges they name at the kernel's own tiles."""
    tiles = kernel_tiles()
    assert 301 % tiles[1] != 0
    assert _trap_rows(300, 40, tiles)


@pytest.mark.cuda
def test_cuda_kernel_takes_mla_head_dims_padded(cuda_device):
    """MLA's shape (q.k over 192 dims, v over 128; float32 q and k, bf16
    v) goes through the kernel zero-padded to 256, within the bf16 bound
    of its plain version."""
    from repro_torch.kernels.dispatch import launches
    q, k, v = _inputs(1, 300, 4, 1, 192, 128, seed=11)
    tq, tk = (torch.from_numpy(a).to(cuda_device)
              for a in (q * 192 ** -0.5 / 0.3, k / 0.3))
    tv = torch.from_numpy(v).to(cuda_device, torch.bfloat16)
    before = launches("flash_attention_fwd")
    got = flash_attention_fused(tq, tk, tv)
    assert launches("flash_attention_fwd") == before + 1
    want = flash_attention_fused(tq, tk, tv, backend="ref")
    weight = flash_attention_fused(tq, tk, tv.float().abs(), backend="ref")
    torch.cuda.synchronize()
    assert got.shape == want.shape == (1, 300, 4, 1, 128)
    assert bool(((got.float() - want.float()).abs()
                 <= _bf16_allowed(want, weight)).all())
