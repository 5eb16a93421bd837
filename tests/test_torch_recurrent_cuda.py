"""The recurrent scan kernels against their plain versions on the card.

``csrc/selective_scan.cu`` and ``csrc/wkv6.cu`` through their wrappers,
against ``selective_scan_ref`` and ``wkv6_ref`` on the same CUDA tensors:
the outputs and the final states bit for bit (every operation rounds once
in both, and both sum in the same pairwise tree), at shapes with ragged
chunks, heads split over several blocks, channels past a block's last
full set of 32, decode steps (S = 1) at B 1 to 4, and jamba's and
rwkv6-1.6b's widths; and
the two recurrent models' prefill and decode with kernel and with plain
version, within 1e-4 of the largest logit (jamba's attention layer runs
the flash kernel, which is not bit-equal to its plain version).
The backward kernels (``csrc/selective_scan_bwd.cu``, ``csrc/wkv6_bwd.cu``)
against autograd over the plain forwards (``*_bwd_ref``): each of the six
gradients within 1e-4 of its largest |value| (float32; they sum in other
orders over up to 8,192 terms and 4,096 steps), two launches bit-equal,
and the forward's output, final state and checkpoints the same bits with the
checkpoints on and off, at ragged shapes (S not a multiple of 16, and
below 16, hd 16: one block a head, N 4 and 8, channels past a block's
16, Di 200: a cluster of 8 blocks padded past Di, several clusters),
with more than 66 heads (the many-heads plan), with unaligned operands,
and at rwkv6-1.6b's training shape, B 4 x 4,096, every cluster resident
at once; the
autograd functions reaching them through the wrappers; and the two smoke
configs' whole-model gradient with the kernels against ``backend="ref"``
(float32, capacity factor 16), within 1e-4 of each leaf's largest value.
This file imports no JAX, so it runs as it is on the machine with the
card (``python -m pytest -m cuda tests/test_torch_recurrent_cuda.py``);
here every test skips.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.dispatch import launches
from repro_torch.kernels.selective_scan.ops import (selective_scan,
                                                    selective_scan_bwd_cuda,
                                                    selective_scan_bwd_ref,
                                                    selective_scan_cuda)
from repro_torch.kernels.wkv6.ops import (wkv6, wkv6_bwd_cuda, wkv6_bwd_ref,
                                          wkv6_cuda)
from repro_torch.models import (decode_step, init_cache, init_params,
                                loss_fn, prefill)

#: a backward kernel against autograd over its plain forward, relative to
#: each gradient's largest |value|
BWD_REL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _close(got, want, rel):
    scale = float(want.abs().max())
    assert scale > 0
    gap = float((got - want).abs().max())
    assert gap <= rel * scale, f"max |d| {gap} > {rel} * {scale}"


def _twice(fn, state):
    """``fn(state)`` through the kernel and the plain version, each on its
    own copy of the state."""
    s_k, s_r = state.clone(), state.clone()
    before = sum(launches(n) for n in ("selective_scan", "wkv6"))
    out_k, ret = fn(s_k, None)
    assert ret is s_k
    assert sum(launches(n) for n in ("selective_scan", "wkv6")) == before + 1
    out_r, _ = fn(s_r, "ref")
    torch.cuda.synchronize()
    return out_k, out_r, s_k, s_r


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,di,n", [
    (2, 37, 64, 4), (1, 70, 200, 8), (3, 5, 130, 16), (1, 1, 8192, 16),
    (1, 1000, 8192, 16),
    # channels past a block's 32 (a ragged edge inside a warp), N 4 and 8
    # with ragged chunks, decode steps at B > 1
    (2, 37, 200, 16), (1, 21, 8200, 16), (3, 19, 200, 4), (2, 45, 8200, 8),
    (4, 1, 200, 16), (4, 1, 8192, 16), (2, 1, 8200, 4)])
def test_selective_scan_kernel_matches_plain_on_card(cuda_device, b, s, di,
                                                     n):
    g = torch.Generator(device=cuda_device).manual_seed(b * 1000 + s)
    rand = lambda *shape: torch.randn(*shape, device=cuda_device, generator=g)
    xi, bm, cm = rand(b, s, di), rand(b, s, n), rand(b, s, n)
    dt = torch.nn.functional.softplus(rand(b, s, di) - 2)
    a = -torch.arange(1, n + 1, device=cuda_device,
                      dtype=torch.float32).repeat(di, 1)
    yk, yr, sk, sr = _twice(lambda st, be: selective_scan(
        xi, dt, bm, cm, a, st, backend=be), rand(b, di, n))
    assert torch.equal(yk, yr) and torch.equal(sk, sr)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hd", [
    (2, 37, 2, 16), (1, 70, 3, 64), (3, 1, 32, 64), (1, 1000, 32, 64),
    # heads split over blocks at B > 1, ragged chunks, decode steps
    (3, 21, 5, 64), (4, 50, 3, 16), (2, 17, 32, 64), (4, 1, 32, 64),
    (2, 1, 2, 16)])
def test_wkv6_kernel_matches_plain_on_card(cuda_device, b, s, h, hd):
    g = torch.Generator(device=cuda_device).manual_seed(b * 100 + s)
    rand = lambda *shape: torch.randn(*shape, device=cuda_device, generator=g)
    r, k, v = (rand(b, s, h, hd) * 0.5 for _ in range(3))
    w = torch.exp(-torch.exp(rand(b, s, h, hd) - 2))
    u = rand(h, hd) * 0.1
    ok, orf, sk, sr = _twice(lambda st, be: wkv6(r, k, v, w, u, st,
                                                 backend=be),
                             rand(b, h, hd, hd))
    assert torch.equal(ok, orf) and torch.equal(sk, sr)


def _unaligned(t):
    """``t`` copied to a contiguous view 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 != 0
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["selective_scan", "wkv6"])
def test_scan_kernels_on_unaligned_operands(cuda_device, name):
    """Operands off a 16-byte boundary take the kernels' 4-byte staging
    copies; they must give the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    rand = lambda *shape: torch.randn(*shape, device=cuda_device, generator=g)
    if name == "selective_scan":
        b, s, di, n = 2, 37, 200, 16
        ops = [rand(b, s, di), torch.nn.functional.softplus(
            rand(b, s, di) - 2), rand(b, s, n), rand(b, s, n),
            -torch.arange(1, n + 1, device=cuda_device,
                          dtype=torch.float32).repeat(di, 1)]
        state, fn = rand(b, di, n), selective_scan
    else:
        b, s, h, hd = 2, 37, 3, 64
        ops = [rand(b, s, h, hd) * 0.5 for _ in range(3)] + [
            torch.exp(-torch.exp(rand(b, s, h, hd) - 2)), rand(h, hd) * 0.1]
        state, fn = rand(b, h, hd, hd), wkv6
    ops = [_unaligned(t) for t in ops]
    ok, orf, sk, sr = _twice(lambda st, be: fn(*ops, st, backend=be), state)
    assert torch.equal(ok, orf) and torch.equal(sk, sr)


@pytest.mark.cuda
def test_wkv6_kernel_refuses_other_head_sizes(cuda_device):
    ops = [torch.zeros(s, device=cuda_device)
           for s in ((1, 2, 2, 32),) * 4 + ((2, 32), (1, 2, 32, 32))]
    with pytest.raises(ValueError, match="head size 32"):
        wkv6(*ops)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_recurrent_model_kernel_matches_plain_on_card(cuda_device, arch):
    """The smoke config in float32 (capacity factor 16): prefill logits and
    cache, then two decode steps, with the kernels and with the plain
    versions forced."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    params = init_params(cfg, 0, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 14), device=cuda_device,
                         generator=g)
    with torch.inference_mode():
        lk, ck = prefill(cfg, params, {"tokens": toks[:, :12]})
        lr, cr = prefill(cfg, params, {"tokens": toks[:, :12]},
                         backend="ref")
        _close(lk, lr, 1e-4)
        arenas = []
        for cache in (ck, cr):
            arena = init_cache(cfg, 2, 14, device=cuda_device)
            for dst, src in zip(_leaves(arena), _leaves(cache)):
                if dst.shape == src.shape:
                    dst.copy_(src)
                else:
                    dst[:, :12] = src
            arenas.append(arena)
        for t in (12, 13):
            pos = torch.full((2,), t, device=cuda_device)
            step = {"tokens": toks[:, t:t + 1]}
            dk, _ = decode_step(cfg, params, arenas[0], step, pos)
            dr, _ = decode_step(cfg, params, arenas[1], step, pos,
                                backend="ref")
            _close(dk, dr, 1e-4)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _bwd_operands(dev, name, shape, unaligned):
    """Operands from a seed, the forward kernel's checkpoints, random
    gradients of the output and of the final state."""
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    rand = lambda *sh: torch.randn(*sh, device=dev, generator=g)
    if name == "wkv6":
        b, s, h, hd = shape
        ops = [rand(b, s, h, hd) * 0.5 for _ in range(3)] + [
            torch.exp(-torch.exp(rand(b, s, h, hd) - 2)), rand(h, hd) * 0.1]
        state, dout, fwd = rand(b, h, hd, hd), rand(b, s, h, hd), wkv6_cuda
    else:
        b, s, di, n = shape
        ops = [rand(b, s, di), torch.nn.functional.softplus(
            rand(b, s, di) - 2), rand(b, s, n), rand(b, s, n),
            -torch.arange(1, n + 1, device=dev,
                          dtype=torch.float32).repeat(di, 1)]
        state, dout, fwd = rand(b, di, n), rand(b, s, di), selective_scan_cuda
    if unaligned:
        ops, dout = [_unaligned(t) for t in ops], _unaligned(dout)
    return fwd, ops, state, dout, rand(*state.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,unaligned", [
    ("wkv6", (2, 37, 3, 16), False), ("wkv6", (2, 32, 2, 16), False),
    ("wkv6", (1, 70, 2, 64), False), ("wkv6", (3, 21, 5, 64), True),
    ("wkv6", (2, 1, 2, 16), False),
    # the design's edges: hd 16 (one block a head) and 64 with S below 16;
    # more than 66 heads (the many-heads plan: 8 values a lane, sub-chunks
    # of 8 steps) with S ragged, a multiple of 16, and unaligned
    ("wkv6", (2, 9, 3, 16), False), ("wkv6", (1, 11, 2, 64), False),
    ("wkv6", (2, 37, 40, 64), False), ("wkv6", (2, 48, 40, 64), False),
    ("wkv6", (3, 21, 32, 64), True),
    ("selective_scan", (2, 37, 200, 4), False),
    ("selective_scan", (1, 45, 130, 8), False),
    ("selective_scan", (2, 32, 64, 16), False),
    ("selective_scan", (3, 19, 200, 16), True),
    ("selective_scan", (1, 1, 8200, 16), False),
    # Di 200: 13 blocks of 16, a cluster of 8 padded with 3 past Di; S
    # below 16; more than one cluster's partials
    ("selective_scan", (2, 37, 200, 16), False),
    ("selective_scan", (2, 9, 200, 8), False),
    ("selective_scan", (1, 40, 1000, 16), True)])
def test_backward_kernel_matches_autograd_over_plain_forward(
        cuda_device, name, shape, unaligned):
    _check_backward(cuda_device, name, shape, unaligned)


@pytest.mark.cuda
def test_wkv6_backward_kernel_at_rwkv6_training_shape(cuda_device):
    """An rwkv6-1.6b layer at its training shape, B 4 x 4,096 (32 heads of
    64): the many-heads plan, every cluster resident at once."""
    from repro_torch.kernels.wkv6.ops import wkv6_bwd_plan
    plan = wkv6_bwd_plan(4, 4096, 32, 64)
    assert plan["blocks_a_cluster"] > 1
    assert plan["clusters_resident"] * plan["blocks_a_cluster"] >= \
        plan["blocks_launched"]
    _check_backward(cuda_device, "wkv6", (4, 4096, 32, 64), False)


def _check_backward(cuda_device, name, shape, unaligned):
    fwd, ops, state, dout, dstate = _bwd_operands(cuda_device, name, shape,
                                                  unaligned)
    bwd, plain = ((wkv6_bwd_cuda, wkv6_bwd_ref) if name == "wkv6" else
                  (selective_scan_bwd_cuda, selective_scan_bwd_ref))
    s_on, s_off = state.clone(), state.clone()
    out_on, _, ckpt = fwd(*ops, s_on, checkpoints=True)
    out_off, _ = fwd(*ops, s_off)
    assert torch.equal(out_on, out_off) and torch.equal(s_on, s_off)
    assert torch.equal(ckpt[:, :, 0], state)
    args = (*ops, ckpt, dout, dstate)
    before = launches(f"{name}_bwd")
    got = bwd(*args)
    again = bwd(*args)
    assert launches(f"{name}_bwd") == before + 2
    want = plain(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for a, b in zip(got, want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        _close(a, b, BWD_REL)
    _, _, ckpt_again = fwd(*ops, state.clone(), checkpoints=True)
    assert torch.equal(ckpt_again, ckpt)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["wkv6", "selective_scan"])
def test_wrapper_trains_through_the_backward_kernel(cuda_device, name):
    """The wrapper with operands that require grad: one forward and one
    backward launch, gradients of every operand and the initial state
    against the plain version's autograd."""
    shape = (2, 37, 3, 64) if name == "wkv6" else (2, 37, 200, 16)
    fn = wkv6 if name == "wkv6" else selective_scan
    _, ops, state, dout, dstate = _bwd_operands(cuda_device, name, shape,
                                                False)
    grads = []
    for backend in (None, "ref"):
        leaves = [t.clone().requires_grad_() for t in ops]
        state0 = state.clone().requires_grad_()
        f0, b0 = launches(name), launches(f"{name}_bwd")
        out, st = fn(*leaves, state0.clone(), backend=backend)
        loss = (out * dout).sum() + (st * dstate).sum()
        grads.append(torch.autograd.grad(loss, leaves + [state0]))
        assert launches(name) - f0 == (backend is None)
        assert launches(f"{name}_bwd") - b0 == (backend is None)
    torch.cuda.synchronize()
    for a, b in zip(*grads):
        _close(a, b, BWD_REL)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_recurrent_model_gradient_kernel_matches_plain_on_card(cuda_device,
                                                               arch):
    """``loss_fn`` and every leaf's gradient of the smoke config (float32,
    capacity factor 16) with the kernels against the plain versions."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=16.0))
    params = init_params(cfg, 0, device=cuda_device)
    leaves = list(_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    g = torch.Generator(device=cuda_device).manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (2, 41), device=cuda_device,
                         generator=g)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    results = []
    for backend in (None, "ref"):
        before = launches("wkv6_bwd") + launches("selective_scan_bwd")
        loss, _ = loss_fn(cfg, params, batch, backend=backend)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        ran = launches("wkv6_bwd") + launches("selective_scan_bwd") - before
        assert (ran > 0) == (backend is None)
        results.append((loss.detach(), grads))
    (lk, gk), (lr, gr) = results
    _close(lk.reshape(1), lr.reshape(1), BWD_REL)
    for a, b in zip(gk, gr):
        assert (a is None) == (b is None)
        if b is not None and float(b.abs().max()) > 0:
            _close(a, b, BWD_REL)

