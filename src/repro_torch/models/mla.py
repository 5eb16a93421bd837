"""Multi-head Latent Attention (DeepSeek-V2/V3), PyTorch.

Counterpart of ``repro.models.mla`` with the same names and parameter
tree.  Queries go through a ``q_lora_rank`` bottleneck, keys and values
through a ``kv_lora_rank`` latent ``c_kv``, which (with the decoupled RoPE
key ``k_pe``) is all the decode cache holds: ``{"c_kv": [B, S, R],
"k_pe": [B, S, Dr]}``.

* :func:`mla_train` / :func:`mla_prefill` expand the latent into per-head
  keys and values and run :func:`attention.flash_attention`, so the
  hand-written flash kernel on CUDA tensors.  q·k spans nope + rope dims
  (192 in deepseek-v3) and v has ``v_head_dim`` (128): the kernel takes
  neither, so ``flash_attention_fused`` zero-pads q, k and v to its next
  head dim (256) and slices the output back, which is exact.
* As in the reference, RoPE returns float32 ``q_pe`` and ``k_pe`` in a
  bf16 model, so the concatenated q and k are float32 and v is bf16; the
  attention output is cast to v's dtype (the reference's flash returns its
  accumulator's), and the prefill cache holds float32 ``k_pe``.
* :func:`mla_decode` is the absorbed form: the per-head content-key block
  of ``wkv_b`` folds into the query and the value block into the output,
  so scores and values contract against the latent cache directly.  It
  writes the new latent row into the cache **in place** (the reference
  blends a one-hot row into a new cache: the same values) and stays
  plain PyTorch, as the reference leaves it to XLA.
* On a mesh whose model axis splits the heads, ``cfg`` is the rank's
  (``n_heads`` its own) and ``wq_b``, ``wkv_b`` and ``wo`` its blocks; the
  latent path (``wq_a``, ``wkv_a``, the two norms, ``k_pe``) is computed
  whole, and ``enter`` is applied to the latents ``c_q``, ``c_kv`` and the
  rope key ``k_pe`` where they pass to the rank's heads (the caller's
  :func:`~repro_torch.runtime.collectives.copy_to`).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .attention import flash_attention
from .config import MLAConfig
from .layers import (apply_rope, dense, init_dense, init_rms_norm, rms_norm,
                     rope_freqs)

__all__ = ["init_mla", "mla_train", "mla_prefill", "mla_decode",
           "init_mla_cache"]

NEG_INF = -1e30


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def init_mla(gen: torch.Generator, d_model: int, cfg: MLAConfig,
             dtype: torch.dtype, device: torch.device) -> dict:
    h, dq = cfg.n_heads, cfg.qk_head_dim
    return {
        # query path: d -> q_lora -> heads*(nope+rope)
        "wq_a": init_dense(gen, d_model, cfg.q_lora_rank, dtype, device),
        "q_norm": init_rms_norm(cfg.q_lora_rank, device),
        "wq_b": init_dense(gen, cfg.q_lora_rank, h * dq, dtype, device),
        # kv path: d -> (kv_lora + rope_dim)
        "wkv_a": init_dense(gen, d_model,
                            cfg.kv_lora_rank + cfg.qk_rope_head_dim, dtype,
                            device),
        "kv_norm": init_rms_norm(cfg.kv_lora_rank, device),
        # latent -> heads*(nope_k + v)
        "wkv_b": init_dense(gen, cfg.kv_lora_rank,
                            h * (cfg.qk_nope_head_dim + cfg.v_head_dim),
                            dtype, device),
        "wo": init_dense(gen, h * cfg.v_head_dim, d_model, dtype, device),
    }


def _project_q(params: dict, x: torch.Tensor, positions: torch.Tensor,
               cfg: MLAConfig, eps: float, enter: Callable = _same
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> q_nope [B,S,H,Dn], q_pe [B,S,H,Dr] (rope applied)."""
    b, s, _ = x.shape
    c_q = rms_norm(params["q_norm"], dense(params["wq_a"], x), eps)
    q = dense(params["wq_b"], enter(c_q))
    q = q.reshape(b, s, cfg.n_heads, cfg.qk_head_dim)
    q_nope = q[..., :cfg.qk_nope_head_dim]
    q_pe = q[..., cfg.qk_nope_head_dim:]
    cos, sin = rope_freqs(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    return q_nope, apply_rope(q_pe, cos, sin)


def _project_kv_latent(params: dict, x: torch.Tensor,
                       positions: torch.Tensor, cfg: MLAConfig, eps: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> c_kv [B,S,R] (normed latent), k_pe [B,S,Dr] (rope applied)."""
    kv = dense(params["wkv_a"], x)
    c_kv = rms_norm(params["kv_norm"], kv[..., :cfg.kv_lora_rank], eps)
    k_pe = kv[..., cfg.kv_lora_rank:]
    cos, sin = rope_freqs(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
    return c_kv, apply_rope(k_pe[..., None, :], cos, sin)[..., 0, :]


def _expanded(params: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: MLAConfig, eps: float, backend: Optional[str],
              enter: Callable = _same
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal MLA in the expanded form -> (output [B,S,D], c_kv, k_pe)."""
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_pe = _project_q(params, x, positions, cfg, eps, enter)
    c_kv, k_pe = _project_kv_latent(params, x, positions, cfg, eps)
    kv = dense(params["wkv_b"], enter(c_kv)).reshape(
        b, s, h, cfg.qk_nope_head_dim + cfg.v_head_dim)
    k_nope = kv[..., :cfg.qk_nope_head_dim]
    v = kv[..., cfg.qk_nope_head_dim:]

    scale = cfg.qk_head_dim ** -0.5
    q = torch.cat([q_nope.to(q_pe.dtype), q_pe], dim=-1) * scale
    k = torch.cat([k_nope.to(k_pe.dtype),
                   enter(k_pe)[:, :, None, :].expand(
                       b, s, h, cfg.qk_rope_head_dim)], dim=-1)
    out = flash_attention(q.reshape(b, s, h, 1, cfg.qk_head_dim), k, v,
                          causal=True, backend=backend)
    out = out.reshape(b, s, h * cfg.v_head_dim).to(v.dtype)
    return dense(params["wo"], out), c_kv, k_pe


def mla_train(params: dict, x: torch.Tensor, positions: torch.Tensor,
              cfg: MLAConfig, *, eps: float = 1e-6,
              backend: Optional[str] = None,
              enter: Callable = _same) -> torch.Tensor:
    """Full-sequence causal MLA (expanded form) on the flash core: the
    nope and rope parts fold into one q·k contraction over their
    concatenated head dim.  ``backend="ref"`` forces the plain version."""
    return _expanded(params, x, positions, cfg, eps, backend, enter)[0]


def mla_prefill(params: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: MLAConfig, *, eps: float = 1e-6,
                backend: Optional[str] = None,
                enter: Callable = _same) -> Tuple[torch.Tensor, dict]:
    """Full-sequence pass that also emits the latent cache for [0, S)
    (projected once; the reference projects it a second time, to the
    same values)."""
    out, c_kv, k_pe = _expanded(params, x, positions, cfg, eps, backend,
                                enter)
    return out, {"c_kv": c_kv, "k_pe": k_pe}


def init_mla_cache(batch: int, max_seq: int, cfg: MLAConfig,
                   dtype: torch.dtype, device: torch.device) -> dict:
    return {
        "c_kv": torch.zeros((batch, max_seq, cfg.kv_lora_rank), dtype=dtype,
                            device=device),
        "k_pe": torch.zeros((batch, max_seq, cfg.qk_rope_head_dim),
                            dtype=dtype, device=device),
    }


def mla_decode(params: dict, cache: dict, x: torch.Tensor, pos: torch.Tensor,
               cfg: MLAConfig, *, eps: float = 1e-6
               ) -> Tuple[torch.Tensor, dict]:
    """One decode step against the latent cache (absorbed form).

    x: [B, 1, D]; pos: [B].  Writes the new ``c_kv`` and ``k_pe`` rows into
    ``cache`` in place; returns (output [B, 1, D], the same cache)."""
    b = x.shape[0]
    h = cfg.n_heads
    r = cfg.kv_lora_rank
    c_kv, k_pe = cache["c_kv"], cache["k_pe"]
    max_seq = c_kv.shape[1]

    q_nope, q_pe = _project_q(params, x, pos[:, None], cfg, eps)
    c_new, kpe_new = _project_kv_latent(params, x, pos[:, None], cfg, eps)
    bi = torch.arange(b, device=x.device)
    c_kv.index_put_((bi, pos), c_new[:, 0].to(c_kv.dtype))
    k_pe.index_put_((bi, pos), kpe_new[:, 0].to(k_pe.dtype))

    # absorb wkv_b's content-key block into the query: q_abs [B, H, R]
    wkv_b = params["wkv_b"]["w"].reshape(
        r, h, cfg.qk_nope_head_dim + cfg.v_head_dim)
    w_k = wkv_b[..., :cfg.qk_nope_head_dim]        # [R, H, Dn]
    w_v = wkv_b[..., cfg.qk_nope_head_dim:]        # [R, H, Dv]
    scale = cfg.qk_head_dim ** -0.5
    q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0] * scale, w_k)
    # scores in float32, as the reference's preferred_element_type asks
    scores = torch.einsum("bhr,bsr->bhs", q_abs.float(), c_kv.float())
    scores = scores + torch.einsum("bhd,bsd->bhs", (q_pe[:, 0] * scale).float(),
                                   k_pe.float())
    mask = torch.arange(max_seq, device=x.device)[None, :] <= pos[:, None]
    scores = torch.where(mask[:, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    # attend in latent space, then expand through the value block
    ctx = torch.einsum("bhs,bsr->bhr", p.to(c_kv.dtype), c_kv)
    out = torch.einsum("bhr,rhd->bhd", ctx, w_v.to(ctx.dtype))
    out = out.reshape(b, 1, h * cfg.v_head_dim)
    return dense(params["wo"], out), cache
