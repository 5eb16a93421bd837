"""AdamW + schedules (PyTorch), the counterpart of ``repro.optim.adamw``.

The same config, schedule and update, step for step: the gradients are
clipped to ``grad_clip`` by their global norm, scaled in float32 and cast
back to each gradient's dtype (so a bf16 gradient is rounded once more, as
in the reference); the moments are kept in ``m_dtype`` and ``v_dtype`` and
updated in float32; ``step`` is an int32 scalar; the learning rate is the
cosine schedule at the new step.

Two differences of form:

* **In place.**  :func:`adamw_update` writes the new parameters and moments
  into the tensors it is given (the counterpart of the reference's donated
  buffers under ``jit``) and returns the same objects.  It runs under
  ``torch.no_grad()``.
* **A slice at a time.**  A leaf of more than ``SLICE_ELEMS`` elements is
  updated a slice of its first axis at a time, so the update's float32
  temporaries stay near that size (jamba's expert stacks are 0.94e9
  elements, 3.8 GB for each temporary); every element goes through the
  same operations, so the bits are those of the whole-leaf update.
* **Weight decay by the reference's leaf.**  The reference decays a leaf
  with ``ndim >= 2`` and stacks every stage leaf on a leading ``n_periods``
  axis, so a block's ``norm1.scale`` ([n_periods, D] there) is decayed and
  ``final_norm.scale`` ([D]) is not.  The port keeps stage leaves one
  period at a time (a list under ``params["stageN"]``), so
  :func:`decay_mask` decides per leaf as the reference does: a leaf under a
  stage list counts one more dimension.  The tree walks are over nested
  dicts, lists and tuples of tensors, in sorted-key order (``jax.tree``'s
  order for dicts).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, Tuple

import torch

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update",
           "cosine_schedule", "global_norm", "clip_by_global_norm",
           "decay_mask", "tree_leaves", "tree_map"]


#: elements of a leaf that one update step holds float32 temporaries for
SLICE_ELEMS = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    #: moment dtypes — bf16 halves optimizer memory (DeepSeek-V3 recipe)
    m_dtype: str = "float32"
    v_dtype: str = "float32"


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts/lists/tuples (the structure of
    ``tree``; ``rest`` must share it)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in ``jax.tree.leaves``' order: dict keys sorted, lists
    and tuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def cosine_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor],
                                                   torch.Tensor]:
    """Linear warmup to ``peak_lr``, then cosine decay to ``min_lr_ratio``
    of it at ``total_steps``; float32, as the reference computes it."""
    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
        prog = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
        cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
            * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)
    return lr


def _dt(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def init_opt_state(params: Any, cfg: AdamWConfig) -> dict:
    """Zero moments shaped like ``params`` (on their devices) and an int32
    step on the first leaf's device."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=_dt(cfg.m_dtype),
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=_dt(cfg.v_dtype),
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    leaves = tree_leaves(tree)
    total = sum(torch.sum(torch.square(x.float())) for x in leaves)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(tree: Any, max_norm: float) -> Tuple[Any,
                                                               torch.Tensor]:
    """(tree scaled to at most ``max_norm``, the norm before the clip); the
    scale is applied in float32 and each leaf cast back to its dtype."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), norm


def decay_mask(params: Any) -> Any:
    """Per leaf, whether the reference's ``ndim >= 2`` test decays it: a
    leaf inside a list (a stage's periods, stacked on one more axis in the
    reference) counts one more dimension."""
    def walk(tree, extra: int):
        if isinstance(tree, dict):
            return {k: walk(v, extra) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, extra + 1) for v in tree)
        return tree.dim() + extra >= 2
    return walk(params, 0)


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: dict, cfg: AdamWConfig
                 ) -> Tuple[Any, dict, dict]:
    """-> (params, state, metrics {"grad_norm", "lr"}), params and moments
    updated in place; weight decay where :func:`decay_mask` says."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = cosine_schedule(cfg)(step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    decay = decay_mask(params)

    def upd(p, g, m, v, dec):
        if p.dim() >= 1 and p.numel() > SLICE_ELEMS and p.shape[0] > 1:
            rows = max(1, SLICE_ELEMS // (p.numel() // p.shape[0]))
            for i in range(0, p.shape[0], rows):
                part = slice(i, i + rows)
                upd(p[part], g[part], m[part], v[part], dec)
            return
        g32 = g.float()
        m32 = m.float() * b1 + (1 - b1) * g32
        v32 = v.float() * b2 + (1 - b2) * g32 * g32
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay and dec:   # no decay on norms/biases
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr.to(p.device) * delta).to(p.dtype))
        m.copy_(m32)
        v.copy_(v32)

    tree_map(upd, params, grads, state["m"], state["v"], decay)
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
