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
the shard partition test runs on one device) and ``tp_axis`` must be None.
The mesh path :func:`moe_apply` (replicated and all-to-all dispatch over
``torch.distributed``) is not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    # jax.nn.gelu is the tanh approximation by default
    return F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")


def moe_block_local(params: dict, x_loc: torch.Tensor, cfg: MoEConfig, *,
                    n_shards: int, shard_ix, tp_axis: Optional[str],
                    act: str = "silu"
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MoE body over one shard's experts.

    x_loc: [T, D]; params: expert stacks already local ([E_loc, ...]),
    router full.  Returns (output [T, D] — the sum over shards is the
    whole —, aux loss scalar, per-local-expert pair counts [E_loc], before
    the capacity cut)."""
    if tp_axis is not None:
        raise NotImplementedError(
            "moe_block_local over a mesh axis is not ported to repro_torch "
            "yet (ROADMAP.md, queue 1)")
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
    counts = torch.bincount(flat_e, minlength=e_loc + 1)
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


def moe_apply(*args, **kw):
    """The reference's MoE over a device mesh (replicated or all-to-all
    expert-parallel dispatch); not ported yet."""
    raise NotImplementedError(
        "moe_apply (mesh dispatch, replicated and a2a) is not ported to "
        "repro_torch yet (ROADMAP.md, queue 1)")
