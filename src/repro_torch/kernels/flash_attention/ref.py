"""Plain PyTorch version of the fused flash-attention kernel.

Counterpart of ``repro.kernels.flash_attention.ref.flash_attention_ref``:
direct softmax attention with scores in float32, ``-1e30`` on masked
scores, probabilities cast to ``v``'s dtype before the PV product, and
the output in ``q``'s dtype.  It adds the model path's optional logit
soft-cap (``softcap * tanh(s / softcap)``, before the mask), which the
CUDA kernel also takes.

It works through the query rows in blocks so that its memory stays
bounded: a [4, 32768, 32768] float32 score tensor alone is 17 GB.  Every
row gets the same arithmetic as in one block; the block size changes
nothing but the peak memory.  With ``return_lse`` it also returns each
row's log-sum-exp over its masked scores (what the CUDA forward writes for
its backward).  Under ``FLAGS.p_bf16`` (``models/flags.py``) the
probabilities are rounded to bf16 before the PV product, as the
reference's attention rounds them under that flag.

:func:`flash_attention_bwd_ref` is the plain version of the backward
kernel: autograd over :func:`flash_attention_ref`, which recomputes the
forward (it takes ``o`` and ``lse`` only to have the kernel's signature).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["flash_attention_ref", "flash_attention_bwd_ref", "NEG_INF"]

NEG_INF = -1e30
#: score elements (float32) held at once across all heads of a row block
_SCORE_BUDGET = 1 << 27


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        return_lse: bool = False):
    """Direct softmax attention. q: [BHG, Sq, Dk] (pre-scaled);
    k: [BHkv, Skv, Dk]; v: [BHkv, Skv, Dv]; BHG = BHkv * G.
    Returns [BHG, Sq, Dv] in q's dtype, and with ``return_lse`` also the
    rows' log-sum-exp, float32 [BHG, Sq]."""
    bhg, sq, dk = q.shape
    bhkv, skv, dv = v.shape
    if bhg % bhkv or k.shape != (bhkv, skv, dk):
        raise ValueError(f"flash_attention_ref: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} do not fit")
    g = bhg // bhkv
    from ...models.flags import FLAGS   # (models imports this module)
    p_bf16 = FLAGS.p_bf16
    block_rows = max(1, _SCORE_BUDGET // max(1, bhg * skv))
    # GQA: the G query heads of one KV head share its K and V, so fold G
    # into the row axis instead of repeating K and V
    qf = q.reshape(bhkv, g, sq, dk)
    kf = k.float().transpose(1, 2)                       # [BHkv, Dk, Skv]
    kpos = torch.arange(skv, device=q.device)
    out = torch.empty((bhkv, g, sq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((bhkv, g, sq), dtype=torch.float32,
                      device=q.device) if return_lse else None
    for r0 in range(0, sq, block_rows):
        r1 = min(sq, r0 + block_rows)
        s = torch.matmul(qf[:, :, r0:r1].float(), kf[:, None])
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        qpos = torch.arange(r0, r1, device=q.device)
        mask = torch.ones((r1 - r0, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= (qpos[:, None] - kpos[None, :]) < window
        s = torch.where(mask, s, NEG_INF)
        if lse is not None:
            lse[:, :, r0:r1] = torch.logsumexp(s, dim=-1)
        p = torch.softmax(s, dim=-1)
        del s
        if p_bf16:
            p = p.to(torch.bfloat16)
        out[:, :, r0:r1] = torch.matmul(p.to(v.dtype), v[:, None]).to(q.dtype)
    out = out.reshape(bhg, sq, dv)
    return (out, lse.reshape(bhg, sq)) if return_lse else out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            dout: torch.Tensor, lse: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            softcap: Optional[float] = None):
    """(dq, dk, dv) of :func:`flash_attention_ref` at ``dout``, by autograd
    over it, each in its input's dtype.  ``o`` and ``lse`` are unused."""
    del o, lse
    with torch.enable_grad():
        qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
        out = flash_attention_ref(qd, kd, vd, causal=causal, window=window,
                                  softcap=softcap)
        return torch.autograd.grad(out, (qd, kd, vd), dout.to(out.dtype))
