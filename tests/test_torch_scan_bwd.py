"""The two scans' backward, on the CPU: the kernels' algorithm and the
autograd functions.

``csrc/wkv6_bwd.cu`` and ``csrc/selective_scan_bwd.cu`` cannot run here,
so this file transcribes each kernel's algorithm into plain PyTorch, step
for step: the forward's state checkpoints every 16 steps, a chunk's states
recomputed from its checkpoint by the forward's own operations (for
``wkv6_bwd`` a sub-chunk at a time from its first state; for
``selective_scan_bwd`` each step's exp kept from the recompute and reused),
the adjoint recurrences walked from the last step, and every sum in the
kernel's order: a lane's values in order (an FMA chain's order) and then
the lanes in the pairwise tree (dk, dr, dw, a_t; dx, ddt); dv over a
thread's rows in order, the block's row groups in the pairwise tree, plus
do_t times the block's part of b_t, then the cluster's blocks in the
pairwise tree; dB and dC over a cluster's 128 channels in the pairwise
tree (past Di, zeros), then the clusters in ``tree_sum``'s order; a
per-batch partial summed over t from the last step and then over the
batch rows in order.  (The kernels fuse products into FMAs; this rounds
each product.)  Each transcription is held against ``jax.vjp`` of the
reference's own scan: ``lax.scan`` inside ``repro.models.rwkv6._tmix_full``
(its projections replaced by the given r, k, v, w) and ``lax.scan`` over
``repro.models.mamba._ssm_step``, on inputs from a numpy seed with a
nonzero initial state and a nonzero gradient of the final state, within
float32 rounding: 1e-5 of each gradient's largest |value| (the two sum in
other orders over up to 200 terms and 48 steps), at every plan of
``wkv6_bwd`` and at the kernels' edges (S below 16, ragged, a multiple of
16; hd 16; Di not a multiple of a cluster's channels).  This checks the
derivation the kernels implement before they reach the card, where
``tests/test_torch_recurrent_cuda.py`` holds the kernels to autograd over
the plain forward.

The autograd functions (``WKV6``, ``SelectiveScan``) on CPU tensors run
the plain versions: their gradients must be autograd's over the plain
forward bit for bit, the state must be updated in place as the forward
updates it, the backward must return None for operands that need no
gradient, and ``loss_fn`` under its remat must reach them: the forward
twice and the backward once a recurrent layer.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.rwkv6 as jax_rwkv
from repro.models import mamba as jax_mamba
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.dispatch import get_kernel, register_kernel
from repro_torch.kernels.selective_scan.ops import (SelectiveScan,
                                                    selective_scan,
                                                    selective_scan_ref)
from repro_torch.kernels.selective_scan.ref import tree_sum
from repro_torch.kernels.wkv6.ops import WKV6, wkv6, wkv6_ref
from repro_torch.models import init_params, loss_fn

REL = 1e-5
#: steps between two checkpoints, the kernels' kChunk
CHUNK = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL):
    got = got.detach().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _t(a):
    """A tensor of its own (the scans write their state in place)."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


# -- the kernels' algorithms, transcribed -------------------------------------

#: the backward kernel's plans (``csrc/wkv6_bwd.cu``): values a lane of a
#: row, rows a thread, rows a block, steps a sub-chunk
WKV6_PLANS = {"many": (8, 2, 32, 4), "few": (8, 1, 16, 8),
              "head16": (8, 1, 16, 4)}
#: selective_scan_bwd's lanes a channel and channels a cluster
SSM_LANES, SSM_CLUSTER = 4, 128


def wkv6_plan(b, h, hd):
    """The plan the kernel launches: many heads once B H hd / 16 blocks
    pass two an SM of an H100's 132."""
    if hd == 16:
        return "head16"
    return "many" if b * h * 4 > 2 * 132 else "few"


def _seq(x, dim):
    """Sum over ``dim`` in order, one value after another (an FMA chain's
    order)."""
    acc = x.select(dim, 0)
    for q in range(1, x.shape[dim]):
        acc = acc + x.select(dim, q)
    return acc


def _lanes(x, dim, vals):
    """A lane's ``vals`` values in order, then the lanes in the pairwise
    tree: the kernels' sum over a row's (or channel's) values."""
    n = x.shape[dim]
    parts = x.unflatten(dim, (n // vals, vals))
    return tree_sum(_seq(parts, dim + 1 if dim >= 0 else dim), dim)


def wkv6_bwd_transcribed(r, k, v, w, u, state0, do, dstate, plan=None):
    """``csrc/wkv6_bwd.cu``'s algorithm; operands as ``wkv6_bwd_cuda``
    takes them, the initial state in place of the checkpoints.  ``plan``
    (default: the kernel's choice) sets the orders of the sums over j
    (``vals``) and over the rows (a thread's ``rpt`` rows first, the
    block's ``rows``, then the cluster's blocks) and the sub-chunks."""
    b, s, h, hd = r.shape
    vals, rpt, rows, sub = WKV6_PLANS[plan or wkv6_plan(b, h, hd)]
    rows = min(rows, hd)
    kv = lambda t: k[:, t, :, :, None] * v[:, t, :, None, :]
    # the forward kernel's checkpoints: the state before steps 0, 16, ...
    ckpt, p = [], state0.clone()
    for t in range(s):
        if t % CHUNK == 0:
            ckpt.append(p)
        p = p * w[:, t, :, :, None] + kv(t)
    g = dstate.clone()                # gradient of the state after step t
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du_part = torch.zeros((b, h, hd))
    for n in reversed(range(len(ckpt))):
        t0, t1 = n * CHUNK, min(s, (n + 1) * CHUNK)
        # the chunk's states: the first of each sub-chunk kept, each
        # sub-chunk's recomputed from it
        first, p = {}, ckpt[n]
        for t in range(t0, t1):
            if (t - t0) % sub == 0:
                first[t] = p
            p = p * w[:, t, :, :, None] + kv(t)
        a = _lanes(v[:, t0:t1] * do[:, t0:t1], -1, vals)      # v_t . do_t
        # b_t's part of each block's rows, in row order
        ur = (u * r[:, t0:t1] * k[:, t0:t1]).unflatten(-1, (hd // rows, rows))
        bpart = _seq(ur, -1)                                # [B, T, H, blk]
        for s0 in reversed(range(t0, t1, sub)):
            hist, p = {}, first[s0]
            for t in range(s0, min(t1, s0 + sub)):
                hist[t] = p
                p = p * w[:, t, :, :, None] + kv(t)
            for t in reversed(range(s0, min(t1, s0 + sub))):
                at = a[:, t - t0, :, None]
                prod = (k[:, t, :, :, None] * g).unflatten(2, (hd // rpt,
                                                               rpt))
                rowsum = tree_sum(_seq(prod, 3).unflatten(
                    2, (hd // rows, rows // rpt)), 3)       # [B, H, blk, j]
                dv[:, t] = tree_sum(rowsum + do[:, t, :, None, :] *
                                    bpart[:, t - t0, :, :, None], 2)
                dk[:, t] = _lanes(v[:, t, :, None, :] * g, -1, vals) + \
                    u * r[:, t] * at
                dr[:, t] = _lanes(do[:, t, :, None, :] * hist[t], -1,
                                  vals) + u * k[:, t] * at
                dw[:, t] = _lanes(g * hist[t], -1, vals)
                du_part = du_part + r[:, t] * k[:, t] * at
                g = w[:, t, :, :, None] * g + \
                    r[:, t, :, :, None] * do[:, t, :, None, :]
    du = torch.zeros((h, hd))
    for i in range(b):
        du = du + du_part[i]
    return dr, dk, dv, dw, du, g


def _channels(x):
    """The sum over channels (dim 1): a cluster's 128 channels in the
    pairwise tree (channels past Di add exact zeros), then the clusters in
    tree_sum's order."""
    di = x.shape[1]
    pad = -di % SSM_CLUSTER
    x = torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)
    x = x.unflatten(1, (x.shape[1] // SSM_CLUSTER, SSM_CLUSTER))
    return tree_sum(tree_sum(x, 2), 1)


def selective_scan_bwd_transcribed(xi, dt, bm, cm, a, state0, dy, dstate):
    """``csrc/selective_scan_bwd.cu``'s algorithm; operands as
    ``selective_scan_bwd_cuda`` takes them, the initial state in place of
    the checkpoints."""
    b, s, di = xi.shape
    vals = a.shape[-1] // SSM_LANES

    def step(p, t):
        h = dt[:, t, :, None]
        return p * torch.exp(h * a) + h * (xi[:, t, :, None] *
                                           bm[:, t, None, :])
    ckpt, p = [], state0.clone()
    for t in range(s):
        if t % CHUNK == 0:
            ckpt.append(p)
        p = step(p, t)
    gc = dstate.clone()     # G_{t+1} e_{t+1}: the later steps' gradient
    dxi, ddt = torch.empty_like(xi), torch.empty_like(dt)
    dbm, dcm = torch.empty_like(bm), torch.empty_like(cm)
    da_part = torch.zeros((b,) + a.shape)
    for n in reversed(range(len(ckpt))):
        t0, t1 = n * CHUNK, min(s, (n + 1) * CHUNK)
        hist, ex, p = {}, {}, ckpt[n]
        for t in range(t0, t1):       # the states and the exps, kept
            hist[t] = p
            ex[t] = torch.exp(dt[:, t, :, None] * a)
            p = step(p, t)
        for t in reversed(range(t0, t1)):
            h, x = dt[:, t, :, None], xi[:, t, :, None]
            bq, cq = bm[:, t, None, :], cm[:, t, None, :]
            gy = dy[:, t, :, None]
            e = ex[t]
            pe = hist[t] * e
            xb = x * bq
            st = pe + h * xb                           # the state after t
            g = gy * cq + gc                           # G_t
            gh, gpe = g * h, g * pe
            dxi[:, t] = _lanes(gh * bq, -1, vals)
            # ddt's two terms a value in turn, then the lanes
            terms = torch.stack([gpe * a, g * xb], -1).flatten(-2)
            ddt[:, t] = _lanes(terms, -1, 2 * vals)
            da_part = da_part + gpe * h
            dbm[:, t] = _channels(gh * x)
            dcm[:, t] = _channels(st * gy)
            gc = g * e
    da = torch.zeros(a.shape)
    for i in range(b):
        da = da + da_part[i]
    return dxi, ddt, dbm, dcm, da, gc


# -- the reference's scans, differentiated by JAX -----------------------------

def _jax_wkv(r, k, v, w, u, state):
    """(o, final state) of the reference's ``lax.scan`` in ``_tmix_full``,
    its projections replaced by r, k, v, w ([B, S, H, hd])."""
    b, s, h, hd = r.shape
    d = h * hd
    flat = [x.reshape(b, s, d) for x in (r, k, v, w)]
    ones = jnp.ones((b, s, d), jnp.float32)
    kept = {}
    real_scan = jax.lax.scan

    def scan(*args, **kw):
        kept["out"] = real_scan(*args, **kw)
        return kept["out"]
    params = {"u": u, "ln_out": {"scale": jnp.ones(d)},
              "wo": {"w": jnp.eye(d, dtype=jnp.float32)}}
    with mock.patch.object(jax_rwkv, "_tmix_inputs",
                           lambda p, x, x_prev: (*flat[:3], ones, flat[3])), \
            mock.patch.object(jax.lax, "scan", scan):
        jax_rwkv._tmix_full(params, jnp.zeros((b, s, d), jnp.float32), hd,
                            state, jnp.zeros((b, d), jnp.float32))
    final, outs = kept["out"]
    return jnp.moveaxis(outs, 0, 1), final


def _jax_ssm(xi, dt, bm, cm, a, state):
    """(y, final state) of ``lax.scan`` over the reference's ``_ssm_step``,
    fed x * B as ``_mamba_full`` forms it."""
    bx = jnp.einsum("bsd,bsn->bsdn", xi, bm)
    xs = tuple(jnp.moveaxis(x, 1, 0) for x in (dt, bx, cm))
    final, ys = jax.lax.scan(lambda st, inp: jax_mamba._ssm_step(st, inp, a),
                             state, xs)
    return jnp.moveaxis(ys, 0, 1), final


def _wkv_inputs(rng, b, s, h, hd):
    r, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((b, s, h, hd)) - 2)).astype(
        np.float32)
    u = (rng.standard_normal((h, hd)) * 0.1).astype(np.float32)
    state = rng.standard_normal((b, h, hd, hd)).astype(np.float32)
    do = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    dstate = rng.standard_normal((b, h, hd, hd)).astype(np.float32)
    return (r, k, v, w, u, state), (do, dstate)


def _ssm_inputs(rng, b, s, di, n):
    xi = rng.standard_normal((b, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)) - 2)).astype(
        np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32)
              for _ in range(2))
    a = -np.tile(np.arange(1, n + 1, dtype=np.float32), (di, 1))
    state = rng.standard_normal((b, di, n)).astype(np.float32)
    dy = rng.standard_normal((b, s, di)).astype(np.float32)
    dstate = rng.standard_normal((b, di, n)).astype(np.float32)
    return (xi, dt, bm, cm, a, state), (dy, dstate)


CASES = [("wkv6", (1, 5, 2, 16)), ("wkv6", (2, 16, 1, 16)),
         ("wkv6", (2, 37, 2, 16)), ("wkv6", (1, 21, 1, 64)),
         ("selective_scan", (1, 5, 8, 4)), ("selective_scan", (2, 16, 24, 8)),
         ("selective_scan", (2, 37, 20, 16)),
         ("selective_scan", (3, 19, 33, 8))]


@pytest.mark.parametrize("name,shape", CASES)
def test_transcribed_backward_matches_jax_grad_of_reference_scan(name,
                                                                 shape):
    """Every gradient of the kernel's algorithm (including the initial
    state's) against ``jax.vjp`` of the reference's scan, at S below,
    at and past a checkpoint interval and not a multiple of it."""
    rng = np.random.default_rng(sum(shape) * 7 + len(name))
    if name == "wkv6":
        ops, cots = _wkv_inputs(rng, *shape)
        ref_fn, mine = _jax_wkv, wkv6_bwd_transcribed
    else:
        ops, cots = _ssm_inputs(rng, *shape)
        ref_fn, mine = _jax_ssm, selective_scan_bwd_transcribed
    _, vjp = jax.vjp(ref_fn, *map(jnp.asarray, ops))
    want = vjp(tuple(map(jnp.asarray, cots)))
    got = mine(*map(_t, ops), *map(_t, cots))
    assert len(got) == len(want) == 6
    for g, w_ in zip(got, want):
        _close(g, w_)


#: the kernels' edges: S below 16 at hd 16 (one block a head) and 64, the
#: many-heads plan (two rows a thread, sub-chunks of 4) at S ragged and a
#: multiple of 16, Di 200 (13 blocks of 16: a cluster of 8 padded past Di)
EDGE_CASES = [("wkv6", (2, 9, 3, 16), None), ("wkv6", (1, 11, 2, 64), None),
              ("wkv6", (2, 37, 2, 64), "many"),
              ("wkv6", (1, 48, 1, 64), "many"),
              ("selective_scan", (2, 37, 200, 16), None),
              ("selective_scan", (2, 9, 200, 8), None)]


@pytest.mark.parametrize("name,shape,plan", EDGE_CASES)
def test_transcribed_backward_at_the_kernels_edges(name, shape, plan):
    """As above, at the shapes where the kernels' plans change: every
    gradient of the algorithm against ``jax.vjp`` of the reference's
    scan."""
    rng = np.random.default_rng(sum(shape) * 11 + len(name))
    if name == "wkv6":
        ops, cots = _wkv_inputs(rng, *shape)
        ref_fn = _jax_wkv
        mine = lambda *x: wkv6_bwd_transcribed(*x, plan=plan)
    else:
        ops, cots = _ssm_inputs(rng, *shape)
        ref_fn, mine = _jax_ssm, selective_scan_bwd_transcribed
    _, vjp = jax.vjp(ref_fn, *map(jnp.asarray, ops))
    want = vjp(tuple(map(jnp.asarray, cots)))
    got = mine(*map(_t, ops), *map(_t, cots))
    assert len(got) == len(want) == 6
    for g, w_ in zip(got, want):
        _close(g, w_)


# -- the autograd functions on the CPU ----------------------------------------

def _function_case(name):
    if name == "wkv6":
        ops, cots = _wkv_inputs(np.random.default_rng(3), 2, 21, 2, 16)
        return wkv6, wkv6_ref, WKV6, ops, cots
    ops, cots = _ssm_inputs(np.random.default_rng(4), 2, 21, 12, 8)
    return selective_scan, selective_scan_ref, SelectiveScan, ops, cots


@pytest.mark.parametrize("name", ["wkv6", "selective_scan"])
def test_function_on_cpu_is_autograd_over_plain_forward(name):
    """Through the wrapper (which runs the autograd function) and through
    autograd over the plain version: the same output, the same final state
    written into the caller's tensor, and the same gradients of every
    operand and of the initial state, bit for bit."""
    fn, plain, _, ops, (cot, cot_state) = _function_case(name)
    results = []
    for run in (fn, plain):
        leaves = [_t(x).requires_grad_() for x in ops[:5]]
        state0 = _t(ops[5]).requires_grad_()
        state = state0.clone()
        out, ret = run(*leaves, state)
        assert ret is state                           # updated in place
        loss = (out * _t(cot)).sum() + (ret * _t(cot_state)).sum()
        grads = torch.autograd.grad(loss, leaves + [state0])
        results.append((out.detach(), state.detach(), grads))
    (out_f, st_f, g_f), (out_p, st_p, g_p) = results
    assert torch.equal(out_f, out_p) and torch.equal(st_f, st_p)
    assert all(torch.equal(a, b) for a, b in zip(g_f, g_p))
    assert not torch.equal(st_f, _t(ops[5]))


@pytest.mark.parametrize("name", ["wkv6", "selective_scan"])
def test_function_backward_returns_none_where_no_grad_is_needed(name):
    """Only the first operand requires grad: the backward returns its
    gradient and None for the other operands, the state and the backend;
    the first gradient is autograd's over the plain version."""
    fn, plain, function, ops, (cot, _) = _function_case(name)
    first = _t(ops[0]).requires_grad_()
    rest = [_t(x) for x in ops[1:]]
    saved = []
    real = function.backward

    def spy(ctx, *grads):
        saved.append(real(ctx, *grads))
        return saved[-1]
    with mock.patch.object(function, "backward", staticmethod(spy)):
        out, _ = fn(first, *rest[:4], _t(ops[5]))
        (got,) = torch.autograd.grad((out * _t(cot)).sum(), [first])
    (returned,) = saved
    assert len(returned) == 7 and returned[0] is not None
    assert all(g is None for g in returned[1:])
    leaf = _t(ops[0]).requires_grad_()
    want_out, _ = plain(leaf, *rest[:4], _t(ops[5]))
    (want,) = torch.autograd.grad((want_out * _t(cot)).sum(), [leaf])
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch,op,mixer", [
    ("rwkv6-1.6b", "wkv6", "rwkv6"),
    ("jamba-v0.1-52b", "selective_scan", "mamba")])
def test_loss_under_remat_runs_forward_twice_and_backward_once(arch, op,
                                                               mixer):
    """``loss_fn``'s default remat ("full") on the smoke config: each
    recurrent layer's scan runs its forward twice (once more when its
    period is recomputed) and its backward op once."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    layers = sum(st.n_periods * sum(b.mixer == mixer for b in st.pattern)
                 for st in cfg.stages)
    params = init_params(cfg, 0, device="cpu")
    leaves = []
    stack = [params]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, list):
            stack.extend(x)
        else:
            leaves.append(x.requires_grad_())
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 13)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    calls = {op: 0, f"{op}_bwd": 0}
    originals = {name: get_kernel(name) for name in calls}

    def counted(name):
        body = originals[name].reference_body

        def run(*args, **kw):
            calls[name] += 1
            return body(*args, **kw)
        return run
    try:
        for name, kop in originals.items():
            register_kernel(dataclasses.replace(kop,
                                                reference_body=counted(name)))
        loss, _ = loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for kop in originals.values():
            register_kernel(kop)
    assert calls == {op: 2 * layers, f"{op}_bwd": layers}
    assert all(g is None or bool(torch.isfinite(g).all()) for g in grads)
