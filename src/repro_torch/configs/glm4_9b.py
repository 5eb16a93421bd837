"""glm4-9b [dense] — 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552 — RoPE, GQA. [hf:THUDM/glm-4-9b; hf]

GLM applies rotary to half the head dim (rotary_dim=64 of 128).
"""
from ..models.config import (AttentionConfig, BlockSpec, ModelConfig,
                                 Stage)

ATTN = AttentionConfig(n_heads=32, n_kv_heads=2, head_dim=128,
                       rope_theta=10_000.0, rotary_dim=64)


def make_config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b",
        family="dense",
        d_model=4096,
        vocab_size=151_552,
        d_ff=13_696,
        attention=ATTN,
        stages=(Stage(40, (BlockSpec("attn", "mlp"),)),),
        act="silu",
        source="[hf:THUDM/glm-4-9b; hf]",
    )


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b-smoke", family="dense", d_model=32,
        vocab_size=256, d_ff=64,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=8,
                                  rotary_dim=4),
        stages=(Stage(2, (BlockSpec("attn", "mlp"),)),),
        act="silu",
    )
