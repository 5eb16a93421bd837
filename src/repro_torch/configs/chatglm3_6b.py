"""chatglm3-6b [dense] — 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — RoPE 2d, GQA. [arXiv:2406.12793; hf]

"2d RoPE" = rotary over half the head dim (GLM-130B convention).
"""
from ..models.config import (AttentionConfig, BlockSpec, ModelConfig,
                                 Stage)

ATTN = AttentionConfig(n_heads=32, n_kv_heads=2, head_dim=128,
                       rope_theta=10_000.0, rotary_dim=64)


def make_config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        d_model=4096,
        vocab_size=65_024,
        d_ff=13_696,
        attention=ATTN,
        stages=(Stage(28, (BlockSpec("attn", "mlp"),)),),
        act="silu",
        source="[arXiv:2406.12793; hf]",
    )


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b-smoke", family="dense", d_model=32,
        vocab_size=256, d_ff=64,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=8,
                                  rotary_dim=4),
        stages=(Stage(2, (BlockSpec("attn", "mlp"),)),),
        act="silu",
    )
