"""Plain PyTorch version of Mamba's selective scan.

The reference's ``_ssm_step`` (``repro.models.mamba``) scanned over time,
for a diagonal state of ``N`` values per channel:

    state <- state * exp(dt_t * A) + dt_t * (x_t * B_t)
    y_t    = sum_n state * C_t

with the operands (all float32)

* ``xi``    ``[B, S, Di]``, the channels' inputs (after the convolution);
* ``dt``    ``[B, S, Di]``, the step sizes;
* ``bm``, ``cm`` ``[B, S, N]``, the input and output projections;
* ``a``     ``[Di, N]``, the (negative) decay rates;
* ``state`` ``[B, Di, N]``, the state before step 0, **updated in place**
  to the state after the last step.

Returns ``(y [B, S, Di] float32, state)``.  The reference builds
``x * B`` for every step at once (``[B, S, Di, N]``, 17 GB a layer at
jamba's 32k prefill); this forms it one step at a time, the same
elementwise products, so the same bits.  The sum over n is
:func:`tree_sum`'s, the order the kernel of ``csrc/selective_scan.cu``
adds in, and every other operation rounds once, as the kernel's does: so
the kernel and this, the CPU path of the port, agree bit for bit on the
card.  (The reference's einsum sums in XLA's order: the CPU tests hold
this to it within float32 rounding.)

:func:`selective_scan_bwd_ref` is the plain version of the backward
kernel: autograd over :func:`selective_scan_ref` from the initial state,
which it recomputes.
"""
from __future__ import annotations

import torch

__all__ = ["selective_scan_ref", "selective_scan_bwd_ref", "tree_sum"]


def tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` pairwise, level by level: x[0] + x[1], x[2] + x[3],
    ..., then the same over those sums, until one is left (an odd one out
    goes up a level as it is).  The scan kernels sum in this order, so a
    sum of a power-of-two count has the same bits here and there."""
    while x.shape[dim] > 1:
        n = x.shape[dim]
        pairs = x.narrow(dim, 0, n - n % 2).unflatten(dim, (n // 2, 2))
        summed = pairs.select(dim + 1 if dim >= 0 else dim, 0) + \
            pairs.select(dim + 1 if dim >= 0 else dim, 1)
        x = summed if n % 2 == 0 else torch.cat(
            [summed, x.narrow(dim, n - 1, 1)], dim)
    return x.squeeze(dim)


def selective_scan_ref(xi: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                       cm: torch.Tensor, a: torch.Tensor,
                       state: torch.Tensor) -> tuple:
    """One step at a time, as the reference's ``lax.scan``; see the module
    docstring for the operands."""
    b, s, di = xi.shape
    y = torch.empty((b, s, di), dtype=torch.float32, device=xi.device)
    # a copy: on a float32 state ``float()`` is the state itself, which the
    # in-place write below would change under autograd's saved tensors
    st = state.to(torch.float32, copy=True)
    for t in range(s):
        dtt = dt[:, t, :, None]                            # [B, Di, 1]
        bx = xi[:, t, :, None] * bm[:, t, None, :]         # [B, Di, N]
        st = st * torch.exp(dtt * a) + dtt * bx
        y[:, t] = tree_sum(st * cm[:, t, None, :], -1)
    state.copy_(st)
    return y, state


def selective_scan_bwd_ref(xi: torch.Tensor, dt: torch.Tensor,
                           bm: torch.Tensor, cm: torch.Tensor,
                           a: torch.Tensor, ckpt: torch.Tensor,
                           dy: torch.Tensor, dstate: torch.Tensor) -> tuple:
    """``(dxi, ddt, dbm, dcm, da, dstate0)`` of :func:`selective_scan_ref`
    at the gradients ``dy`` of ``y`` and ``dstate`` of the final state, by
    autograd over it; ``ckpt[:, :, 0]`` is the initial state (the kernel's
    other checkpoints are not read)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (xi, dt, bm, cm, a)]
        state0 = ckpt[:, :, 0].detach().clone().requires_grad_()
        y, state = selective_scan_ref(*leaves, state0.clone())
        return torch.autograd.grad((y, state), (*leaves, state0),
                                   (dy, dstate))
