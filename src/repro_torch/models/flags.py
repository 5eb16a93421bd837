"""Performance flags (counterpart of ``repro.models.flags``).

The same fields, defaults and setters.  The model code reads each where
the reference reads it:

* ``p_bf16``: the plain attention (``kernels/flash_attention/ref.py``)
  rounds its probabilities to bf16 before the PV product;
* ``seq_shard_acts``: under a ``ShardCtx``, the residual stream between
  blocks is split over (model x seq), Megatron-SP style, and gathered
  before each half-block;
* ``moe_a2a``: under a ``ShardCtx``, MoE layers take the all-to-all
  expert-parallel dispatch where the sequence divides the model axis.

``ssm_unroll`` and ``scatter_cache`` are accepted and change no number in
the port: its recurrences are kernels (no XLA scan to unroll), and its
decode caches are already written in place.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

__all__ = ["PerfFlags", "FLAGS", "set_flags", "reset_flags"]


@dataclass
class PerfFlags:
    #: attention probabilities cast to bf16 before the PV product
    p_bf16: bool = False
    #: Megatron-SP: residual stream sharded over ("model" x seq) between
    #: blocks
    seq_shard_acts: bool = False
    #: unroll factor of the reference's recurrent scans (no effect here)
    ssm_unroll: int = 1
    #: the reference's in-place decode cache writes (always so here)
    scatter_cache: bool = False
    #: expert-parallel all-to-all MoE dispatch (falls back to replicated
    #: when the sequence does not divide the model axis)
    moe_a2a: bool = False


FLAGS = PerfFlags()


def set_flags(**kw) -> PerfFlags:
    for k, v in kw.items():
        if not hasattr(FLAGS, k):
            raise KeyError(f"unknown perf flag {k!r}")
        cur = getattr(FLAGS, k)
        setattr(FLAGS, k, type(cur)(int(v) if isinstance(cur, (bool, int))
                                    and isinstance(v, str) else v))
    return FLAGS


def reset_flags() -> None:
    d = PerfFlags()
    for f in fields(PerfFlags):
        setattr(FLAGS, f.name, getattr(d, f.name))
