"""GQA attention: flash prefill path + cached decode path (PyTorch).

Counterpart of ``repro.models.attention`` with the same names and
layouts: q [B, S, H, D] is folded to [B, S, Hkv, G, D] for the flash
core, the KV cache is ``{"k", "v"}`` of [B, max_seq, Hkv, D].

* :func:`flash_attention` keeps the JAX signature and routes through
  ``dispatch("flash_attention_fwd", ...)``: on CUDA tensors that is the
  hand-written kernel (``kernels/csrc/flash_attention.cu``), on the CPU
  the plain version.  It is what ``attention_train`` and therefore every
  layer of ``prefill`` and of training runs; with grad enabled it goes
  through the ``FlashAttention`` autograd function, whose backward is the
  hand-written backward kernel (``csrc/flash_attention_bwd.cu``).
* In a bf16 model q and k leave RoPE in float32 and v stays bf16, as in
  the reference; the kernel takes that pair of dtypes.  The attention
  output is cast to v's dtype before the output projection, the dtype
  the reference's flash attention returns (its accumulator's).
* :func:`attention_prefill` computes q, k, v once (the reference runs
  ``_qkv`` a second time for the cache; the values are the same, float32
  k included).
* :func:`attention_decode` writes the new K and V into the cache **in
  place** (``index_put_``).  The reference blends a one-hot row into a
  new cache by default; that gives exactly the values of the in-place
  write, which moves one row per sequence instead of the whole cache.
  Its masked dot over the cache stays plain PyTorch, as the reference
  leaves it to XLA.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..kernels.flash_attention.ops import flash_attention_fused
from .config import AttentionConfig
from .layers import apply_rope, dense, init_dense, rope_freqs

__all__ = ["init_attention", "attention_train", "attention_prefill",
           "attention_decode", "init_kv_cache", "flash_attention"]

NEG_INF = -1e30
DEFAULT_Q_CHUNK = 512
DEFAULT_KV_CHUNK = 1024


def init_attention(gen: torch.Generator, d_model: int, cfg: AttentionConfig,
                   dtype: torch.dtype, device: torch.device) -> dict:
    return {
        "wq": init_dense(gen, d_model, cfg.q_dim, dtype, device),
        "wk": init_dense(gen, d_model, cfg.kv_dim, dtype, device),
        "wv": init_dense(gen, d_model, cfg.kv_dim, dtype, device),
        "wo": init_dense(gen, cfg.q_dim, d_model, dtype, device),
    }


def _qkv(params: dict, x: torch.Tensor, positions: torch.Tensor,
         cfg: AttentionConfig
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    q = dense(params["wq"], x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = dense(params["wk"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = dense(params["wv"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    rd = cfg.rotary_dim or cfg.head_dim
    cos, sin = rope_freqs(positions, rd, cfg.rope_theta)
    q = apply_rope(q, cos, sin, rd)
    k = apply_rope(k, cos, sin, rd)
    return q, k, v


def _soft_cap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    q_chunk: int = DEFAULT_Q_CHUNK,
                    kv_chunk: int = DEFAULT_KV_CHUNK,
                    backend: Optional[str] = None) -> torch.Tensor:
    """Fused online-softmax attention.

    q: [B, Sq, Hkv, G, Dk] (already scaled); k: [B, Skv, Hkv, Dk];
    v: [B, Skv, Hkv, Dv].  Positions are implicit (arange).  Returns
    [B, Sq, Hkv, G, Dv].  ``backend`` as in ``dispatch``: None picks the
    CUDA kernel for CUDA tensors and the plain version on the CPU;
    ``"ref"`` forces the plain version on the card.
    """
    return flash_attention_fused(q, k, v, causal=causal, window=window,
                                 softcap=softcap, q_chunk=q_chunk,
                                 kv_chunk=kv_chunk, backend=backend)


def _attend(params: dict, q: torch.Tensor, k: torch.Tensor,
            v: torch.Tensor, cfg: AttentionConfig, **kw) -> torch.Tensor:
    b, s = q.shape[:2]
    groups = cfg.n_heads // cfg.n_kv_heads
    q = (q * cfg.head_dim ** -0.5).reshape(
        b, s, cfg.n_kv_heads, groups, cfg.head_dim)
    out = flash_attention(q, k, v, causal=True,
                          window=cfg.sliding_window,
                          softcap=cfg.logit_softcap, **kw)
    return dense(params["wo"], out.reshape(b, s, cfg.q_dim).to(v.dtype))


def attention_train(params: dict, x: torch.Tensor, positions: torch.Tensor,
                    cfg: AttentionConfig, *,
                    q_chunk: int = DEFAULT_Q_CHUNK,
                    kv_chunk: int = DEFAULT_KV_CHUNK,
                    backend: Optional[str] = None) -> torch.Tensor:
    """Causal (optionally sliding-window) self-attention over a full
    sequence. x: [B, S, D]; positions: [B, S] (arange).  Differentiable:
    with grad enabled the flash core runs forward and backward kernels
    (``FlashAttention``); ``backend="ref"`` forces the plain versions."""
    q, k, v = _qkv(params, x, positions, cfg)
    return _attend(params, q, k, v, cfg, q_chunk=q_chunk, kv_chunk=kv_chunk,
                   backend=backend)


def init_kv_cache(batch: int, max_seq: int, cfg: AttentionConfig,
                  dtype: torch.dtype, device: torch.device) -> dict:
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_prefill(params: dict, x: torch.Tensor, positions: torch.Tensor,
                      cfg: AttentionConfig, **kw
                      ) -> Tuple[torch.Tensor, dict]:
    """Full-sequence pass that also emits the KV cache for [0, S).
    ``kw`` goes to :func:`flash_attention` (``backend="ref"`` forces the
    plain version on the card)."""
    q, k, v = _qkv(params, x, positions, cfg)
    return _attend(params, q, k, v, cfg, **kw), {"k": k, "v": v}


def attention_decode(params: dict, cache: dict, x: torch.Tensor,
                     pos: torch.Tensor, cfg: AttentionConfig
                     ) -> Tuple[torch.Tensor, dict]:
    """One decode step. x: [B, 1, D]; pos: [B] write/attend position.
    Writes the new K and V into ``cache`` in place; returns (output
    [B, 1, D], the same cache)."""
    b = x.shape[0]
    k, v = cache["k"], cache["v"]
    max_seq = k.shape[1]
    q, k_new, v_new = _qkv(params, x, pos[:, None], cfg)
    bi = torch.arange(b, device=x.device)
    k.index_put_((bi, pos), k_new[:, 0].to(k.dtype))
    v.index_put_((bi, pos), v_new[:, 0].to(v.dtype))

    groups = cfg.n_heads // cfg.n_kv_heads
    scale = cfg.head_dim ** -0.5
    qh = (q * scale).reshape(b, cfg.n_kv_heads, groups, cfg.head_dim)
    # scores in float32, as the reference's preferred_element_type asks
    scores = torch.einsum("bhgd,bshd->bhgs", qh.float(), k.float())
    scores = _soft_cap(scores, cfg.logit_softcap)
    k_pos = torch.arange(max_seq, device=x.device)
    mask = k_pos[None, :] <= pos[:, None]                     # [B, S]
    if cfg.sliding_window is not None:
        mask &= (pos[:, None] - k_pos[None, :]) < cfg.sliding_window
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgs,bshd->bhgd", p, v)
    out = out.reshape(b, 1, cfg.q_dim)
    return dense(params["wo"], out), cache
