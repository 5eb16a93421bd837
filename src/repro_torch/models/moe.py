"""Fine-grained Mixture-of-Experts, token-choice with capacity (PyTorch).

Counterpart of ``repro.models.moe`` for one device: the same names,
parameter tree (``router.w`` [D, E] float32; expert stacks ``gate``,
``up`` [E, D, De] and ``down`` [E, De, D]; an optional ``shared`` dense
MLP) and semantics, step for step:

* the router runs in float32: softmax, top-k, the k weights renormalised
  among the picked experts, and the Switch load-balance loss
  ``E * sum_e f_e * p_e``;
* each expert has ``max(4, int(T * k * cf / E + 0.999))`` slots; the
  (token, k) pairs are **stably** sorted by expert, so the c-th pair routed
  to an expert takes slot c and the latest tokens are the ones dropped;
* dispatch gathers each slot's source row, the expert FFN is three batched
  products in the activation dtype (the reference leaves them to XLA, so
  they stay ``torch.matmul``), and the combine gathers each pair's slot
  back, weights it in the activation dtype and sums over k.

:func:`moe_block_local` keeps the reference's signature: ``n_shards`` and
``shard_ix`` pick the slice of experts a shard owns (plain arithmetic, so
the shard partition test runs on one device); ``tp_axis`` names the axis
its caller reduces the partial output over (the body itself runs no
collective, as in the reference).

:func:`moe_apply` is the reference's expert-parallel MoE over a mesh, as
explicit SPMD over ``torch.distributed`` (``runtime/collectives.py``):
each rank holds its ``E / n_shards`` experts and its block of the
activations, and the reference's ``shard_map`` bodies run on them.

* ``dispatch="replicated"``: the tokens of this rank's dp block are
  replicated over the model axis; every rank routes them all, keeps the
  pairs bound to its own experts, and the partial outputs are all-reduced
  over the model axis.
* ``dispatch="a2a"`` (where the sequence divides the model axis): each
  rank routes its own sequence block, buckets each (token, k) pair to the
  rank owning its expert with the reference's per-peer capacity
  ``c_send``, ships the buckets with one ``all_to_all_single``, runs its
  experts with the per-expert capacity ``c_loc`` over what it received,
  and ships the rows back with a second one.

Capacity is per shard, as in the reference, so on a mesh the pairs
dropped (and the output) can differ from the meshless block's.  ``aux`` is
mean-reduced over the model axis and over the dp axes, and the counts are
summed over the dp axes where the batch is split over them.  Under
autograd the router is a parameter each rank uses on its own pairs, so
its gradient (and the tokens') is summed over the model axis.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..runtime.collectives import (all_reduce, all_to_all, axis_group,
                                   axis_index, axis_size, copy_to, gather_rep,
                                   mean_rep, reduce_from, split_rep)
from .config import MoEConfig
from .layers import dense, init_dense

__all__ = ["init_moe", "moe_block_local", "moe_apply", "shared_expert_mlp",
           "expert_capacity"]


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype: torch.dtype, device: torch.device) -> dict:
    e, de = cfg.n_experts, cfg.d_expert

    def expert_stack(d_in, d_out):
        # drawn in float32 one stack at a time, then cast
        w = torch.randn((e, d_in, d_out), generator=gen, dtype=torch.float32,
                        device=device)
        return (w / d_in ** 0.5).to(dtype)

    router = torch.randn((d_model, e), generator=gen, dtype=torch.float32,
                         device=device) / d_model ** 0.5
    p = {
        "router": {"w": router},  # router kept in float32
        "gate": expert_stack(d_model, de),
        "up": expert_stack(d_model, de),
        "down": expert_stack(de, d_model),
    }
    if cfg.n_shared:
        p["shared"] = {
            "gate": init_dense(gen, d_model, cfg.n_shared * de, dtype, device),
            "up": init_dense(gen, d_model, cfg.n_shared * de, dtype, device),
            "down": init_dense(gen, cfg.n_shared * de, d_model, dtype,
                               device),
        }
    return p


def shared_expert_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The always-on experts as one SiLU-gated MLP, whatever ``cfg.act``."""
    h = F.silu(dense(params["gate"], x)) * dense(params["up"], x)
    return dense(params["down"], h)


def _route(router_w: torch.Tensor, x_flat: torch.Tensor, cfg: MoEConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (weights [T, k] float32, experts [T, k] int64, aux loss scalar)."""
    logits = x_flat.float() @ router_w                        # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch-style load-balance loss: E * sum_e f_e * p_e
    e = cfg.n_experts
    f = torch.zeros((e,), dtype=torch.float32, device=x_flat.device)
    f.index_add_(0, top_e.reshape(-1),
                 torch.full((top_e.numel(),), 1.0 / top_e.numel(),
                            device=x_flat.device))
    aux = e * torch.sum(f * probs.mean(dim=0))
    return top_w, top_e, aux


def expert_capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """Slots per expert: the mean load times the capacity factor, at
    least 4 (static, as in the reference)."""
    return max(4, int(n_tokens * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts + 0.999))


def _bucket_counts(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(keys, minlength=n)`` for keys known to lie in
    [0, n): a static shape (the dry run traces it on meta tensors, which
    ``bincount``'s data-dependent length cannot run on)."""
    return torch.zeros(n, dtype=torch.int64, device=keys.device).scatter_add_(
        0, keys.long(), torch.ones_like(keys, dtype=torch.int64))


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    # jax.nn.gelu is the tanh approximation by default
    return F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")


def moe_block_local(params: dict, x_loc: torch.Tensor, cfg: MoEConfig, *,
                    n_shards: int, shard_ix, tp_axis: Optional[str],
                    act: str = "silu"
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MoE body over one shard's experts (the reference's replicated
    dispatch body).

    x_loc: [T, D]; params: expert stacks already local ([E_loc, ...]),
    router full.  Returns (output [T, D] — the sum over shards is the
    whole —, aux loss scalar, per-local-expert pair counts [E_loc], before
    the capacity cut)."""
    del tp_axis     # the caller reduces over it
    t, d = x_loc.shape
    dev = x_loc.device
    e_loc = params["gate"].shape[0]
    top_w, top_e, aux = _route(params["router"]["w"], x_loc, cfg)

    # map global expert ids -> local slot (or drop if owned elsewhere)
    local_e = top_e - int(shard_ix) * e_loc                   # [T, k]
    mine = (local_e >= 0) & (local_e < e_loc)
    capacity = expert_capacity(t, cfg)

    flat_e = torch.where(mine, local_e, e_loc).reshape(-1)    # e_loc = drop
    n_pairs = flat_e.numel()
    flat_t = torch.arange(t, device=dev).repeat_interleave(cfg.top_k)

    # position of each (token, k) pair within its expert's slots
    sort_ix = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_ix]
    counts = _bucket_counts(flat_e, e_loc + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(n_pairs, device=dev) - starts[sorted_e]
    pos = torch.empty_like(pos_sorted).scatter_(0, sort_ix, pos_sorted)

    # gather dispatch: slot (e, c) is filled by the c-th pair routed to e
    slots = torch.arange(capacity, device=dev)
    slot_src = starts[:e_loc, None] + slots[None, :]
    valid = slots[None, :] < counts[:e_loc, None]
    slot_pair = sort_ix[slot_src.clamp(0, n_pairs - 1)]
    slot_tok = torch.where(valid, flat_t[slot_pair], t)
    x_pad = torch.cat([x_loc, x_loc.new_zeros((1, d))])
    buf = x_pad[slot_tok]                                     # [E_loc, C, D]

    # expert FFN: three batched products
    h = _act(torch.matmul(buf, params["gate"]), act) * \
        torch.matmul(buf, params["up"])
    y_buf = torch.matmul(h, params["down"])                   # [E_loc, C, D]

    # combine: gather each pair's slot, weight it in the activation dtype,
    # and reduce over k (pairs are (t, k)-contiguous)
    in_cap = (pos < capacity) & (flat_e < e_loc)
    flat_w = torch.where(mine.reshape(-1) & in_cap, top_w.reshape(-1), 0.0)
    flat_ix = torch.where(in_cap, flat_e * capacity + pos, e_loc * capacity)
    y_pad = torch.cat([y_buf.reshape(e_loc * capacity, d),
                       y_buf.new_zeros((1, d))])
    gathered = y_pad[flat_ix] * flat_w[:, None].to(y_buf.dtype)
    out = gathered.reshape(t, cfg.top_k, d).sum(dim=1)
    return out, aux, counts[:e_loc]


def _ranked(keys: torch.Tensor, n_buckets: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    """Stable bucketing of ``keys`` (``n_buckets`` = drop) -> (sort order,
    counts [n_buckets + 1], starts, rank of each key in its bucket)."""
    n = keys.numel()
    order = torch.argsort(keys, stable=True)
    counts = _bucket_counts(keys, n_buckets + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(n, device=keys.device) - starts[keys[order]]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    return order, counts, starts, rank


def _slot_rows(order: torch.Tensor, counts: torch.Tensor,
               starts: torch.Tensor, n_buckets: int, cap: int,
               src: torch.Tensor, none: int) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """Gather dispatch: slot (b, c) takes the c-th key of bucket b ->
    (its ``src`` row or ``none``, [n_buckets, cap]; the slot's key)."""
    slots = torch.arange(cap, device=order.device)
    valid = slots[None, :] < counts[:n_buckets, None]
    key = order[(starts[:n_buckets, None] + slots[None, :])
                .clamp(0, order.numel() - 1)]
    return torch.where(valid, src[key], none), torch.where(valid, key, -1)


def _experts(params: dict, buf: torch.Tensor, act: str) -> torch.Tensor:
    h = _act(torch.matmul(buf, params["gate"]), act) * \
        torch.matmul(buf, params["up"])
    return torch.matmul(h, params["down"])


def _moe_a2a_local(params: dict, x_loc: torch.Tensor, cfg: MoEConfig, *,
                   n_shards: int, group, act: str
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All-to-all expert-parallel body: x_loc [T_loc, D] is this rank's
    sequence block.  Each (token, k) pair goes to the rank owning its
    expert (at most ``c_send`` a peer), is computed there by its expert (at
    most ``c_loc`` an expert) and comes back."""
    t, d = x_loc.shape
    dev = x_loc.device
    e_loc = params["gate"].shape[0]
    top_w, top_e, aux = _route(params["router"]["w"], x_loc, cfg)

    k = cfg.top_k
    npairs = t * k
    flat_e = top_e.reshape(-1)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    dest = flat_e // e_loc                                 # owner shard
    le = flat_e % e_loc                                    # local expert

    # per-destination send capacity (uniform load x cf, like experts)
    c_send = max(4, int(npairs * cfg.capacity_factor / n_shards + 0.999))
    order, dcounts, dstarts, rank = _ranked(dest, n_shards)
    in_send = rank < c_send
    slot_tok, slot_pair = _slot_rows(order, dcounts, dstarts, n_shards,
                                     c_send, flat_t, t)
    x_pad = torch.cat([x_loc, x_loc.new_zeros((1, d))])
    send_x = x_pad[slot_tok]                               # [P, C_send, D]
    send_le = torch.where(slot_pair >= 0, le[slot_pair.clamp_min(0)],
                          e_loc)                           # [P, C_send]

    rx = all_to_all(send_x, group).reshape(n_shards * c_send, d)
    rle = all_to_all(send_le, group).reshape(n_shards * c_send)

    # local dispatch by expert (gather form, k = 1)
    tr = rx.shape[0]
    c_loc = max(4, int(tr * cfg.capacity_factor / e_loc + 0.999))
    order2, ecounts, estarts, pos2 = _ranked(rle, e_loc)
    rows = torch.arange(tr, device=dev)
    eslot_row, _ = _slot_rows(order2, ecounts, estarts, e_loc, c_loc, rows,
                              tr)
    rx_pad = torch.cat([rx, rx.new_zeros((1, d))])
    y_buf = _experts(params, rx_pad[eslot_row], act)       # [E_loc, C, D]

    # back to received-row order, then the reverse all_to_all
    row_ok = (rle < e_loc) & (pos2 < c_loc)
    row_ix = torch.where(row_ok, rle * c_loc + pos2, e_loc * c_loc)
    y_pad = torch.cat([y_buf.reshape(e_loc * c_loc, d),
                       y_buf.new_zeros((1, d))])
    back = all_to_all(y_pad[row_ix].reshape(n_shards, c_send, d), group)
    back = back.reshape(n_shards * c_send, d)

    # combine at the source: pair -> (dest, rank) bucket slot
    pair_ix = torch.where(in_send, dest * c_send + rank, n_shards * c_send)
    back_pad = torch.cat([back, back.new_zeros((1, d))])
    flat_w = torch.where(in_send, top_w.reshape(-1), 0.0)
    gathered = back_pad[pair_ix] * flat_w[:, None].to(back.dtype)
    out = gathered.reshape(t, k, d).sum(dim=1)
    return out, aux, ecounts[:e_loc]


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig, *, mesh,
              dp_axes: Tuple[str, ...], tp_axis: str, act: str = "silu",
              dispatch: str = "replicated", dp_ok: bool = True,
              shared_split: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MoE over this rank's activations under a (pod?, data, model) mesh.

    ``params``: the router whole, the expert stacks this rank's
    ``[E / n_shards, ...]`` (``n_shards`` the model axis's size), the
    shared experts whole or, with ``shared_split``, this rank's column
    (gate, up) and row (down) blocks.  ``x``: [B, S, D], this rank's block
    of a batch split over ``dp_axes`` (``dp_ok``) or the whole batch,
    replicated over ``tp_axis``.  Returns (y [B, S, D] in x's layout, aux
    scalar, this rank's experts' counts [E_loc])."""
    b, s, d = x.shape
    n_shards = axis_size(mesh, tp_axis)
    tpg, dpg = axis_group(mesh, tp_axis), axis_group(mesh, dp_axes)
    e_loc = params["gate"].shape[0]
    if e_loc * n_shards != cfg.n_experts:
        raise ValueError(f"{e_loc} local experts on {n_shards} shards; the "
                         f"config has {cfg.n_experts}")
    local = {"router": {"w": copy_to(params["router"]["w"], tpg)},
             **{k: params[k] for k in ("gate", "up", "down")}}
    if dispatch == "a2a" and s % n_shards == 0 and s > 1:
        xs = split_rep(x, 1, tpg)                 # this rank's sequence
        out, aux, counts = _moe_a2a_local(
            local, xs.reshape(-1, d), cfg, n_shards=n_shards, group=tpg,
            act=act)
        y = gather_rep(out.reshape(xs.shape), 1, tpg)
    else:
        if dispatch not in ("replicated", "a2a"):
            raise ValueError(f"unknown dispatch {dispatch!r}")
        out, aux, counts = moe_block_local(
            local, copy_to(x, tpg).reshape(b * s, d), cfg,
            n_shards=n_shards, shard_ix=axis_index(mesh, tp_axis),
            tp_axis=tp_axis, act=act)
        y = reduce_from(out, tpg).reshape(b, s, d)
    aux = mean_rep(mean_rep(aux, tpg), dpg)
    if dp_ok:
        counts = all_reduce(counts, dpg)
    if cfg.n_shared:
        if shared_split:
            y = y + reduce_from(shared_expert_mlp(params["shared"],
                                                  copy_to(x, tpg)), tpg)
        else:
            y = y + shared_expert_mlp(params["shared"], x)
    return y, aux, counts
