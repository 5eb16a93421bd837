"""rwkv6-1.6b [ssm] — 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536 — Finch, data-dependent decay. [arXiv:2404.05892; unverified]

Attention-free: the paper technique's attention-sharding aspects are
inapplicable (DESIGN.md §Arch-applicability); elastic serving + DP still
apply.  O(1) state per token => long_500k RUNS.
"""
from ..models.config import BlockSpec, ModelConfig, Stage


def make_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        d_model=2048,
        vocab_size=65_536,
        d_ff=7168,
        attention=None,
        stages=(Stage(24, (BlockSpec("rwkv6", "rwkv6_cmix"),)),),
        rwkv_head_size=64,
        subquadratic=True,
        source="[arXiv:2404.05892; unverified]",
    )


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b-smoke", family="ssm", d_model=32,
        vocab_size=256, d_ff=64, attention=None,
        stages=(Stage(2, (BlockSpec("rwkv6", "rwkv6_cmix"),)),),
        rwkv_head_size=16, subquadratic=True,
    )
