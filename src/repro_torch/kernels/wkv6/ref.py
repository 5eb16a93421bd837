"""Plain PyTorch version of RWKV-6's WKV recurrence.

The reference's ``step`` inside ``_tmix_full`` (``repro.models.rwkv6``),
scanned over time, for each batch row and head, with a float32 state
``S`` of ``[hd, hd]`` (key index first):

    o_t = r_t (S + diag(u) k_t^T v_t)
    S  <- diag(w_t) S + k_t^T v_t

with the operands (all float32)

* ``r``, ``k``, ``v`` ``[B, S, H, hd]``, receptance, key and value;
* ``w``     ``[B, S, H, hd]``, the data-dependent decay, in (0, 1);
* ``u``     ``[H, hd]``, the per-head bonus;
* ``state`` ``[B, H, hd, hd]``, the state before step 0, **updated in
  place** to the state after the last step.

Returns ``(o [B, S, H, hd] float32, state)``.  The sum over the key index
is :func:`~repro_torch.kernels.selective_scan.ref.tree_sum`'s, the order
the kernel of ``csrc/wkv6.cu`` adds in, and every other operation rounds
once, as the kernel's does: so the kernel and this, the CPU path of the
port, agree bit for bit on the card.  (The reference's einsum sums in
XLA's order: the CPU tests hold this to it within float32 rounding.)

:func:`wkv6_bwd_ref` is the plain version of the backward kernel: autograd
over :func:`wkv6_ref` from the initial state, which it recomputes.
"""
from __future__ import annotations

import torch

from ..selective_scan.ref import tree_sum

__all__ = ["wkv6_ref", "wkv6_bwd_ref"]


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, state: torch.Tensor) -> tuple:
    """One step at a time, as the reference's ``lax.scan``; see the module
    docstring for the operands."""
    o = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    uu = u[None, :, :, None]                               # [1, H, hd, 1]
    # a copy: on a float32 state ``float()`` is the state itself, which the
    # in-place write below would change under autograd's saved tensors
    st = state.to(torch.float32, copy=True)
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]     # [B, H, hd, hd]
        o[:, t] = tree_sum(r[:, t, :, :, None] * (st + uu * kv), 2)
        st = st * w[:, t, :, :, None] + kv
    state.copy_(st)
    return o, state


def wkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, ckpt: torch.Tensor,
                 do: torch.Tensor, dstate: torch.Tensor) -> tuple:
    """``(dr, dk, dv, dw, du, dstate0)`` of :func:`wkv6_ref` at the
    gradients ``do`` of ``o`` and ``dstate`` of the final state, by
    autograd over it; ``ckpt[:, :, 0]`` is the initial state (the kernel's
    other checkpoints are not read)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (r, k, v, w, u)]
        state0 = ckpt[:, :, 0].detach().clone().requires_grad_()
        o, state = wkv6_ref(*leaves, state0.clone())
        return torch.autograd.grad((o, state), (*leaves, state0),
                                   (do, dstate))
