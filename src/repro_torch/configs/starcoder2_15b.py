"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152 — GQA, RoPE. [arXiv:2402.19173; hf]

StarCoder2 uses a plain (non-gated) GELU MLP.
"""
from ..models.config import (AttentionConfig, BlockSpec, ModelConfig,
                                 Stage)

ATTN = AttentionConfig(n_heads=48, n_kv_heads=4, head_dim=128,
                       rope_theta=100_000.0)


def make_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b",
        family="dense",
        d_model=6144,
        vocab_size=49_152,
        d_ff=24_576,
        attention=ATTN,
        stages=(Stage(40, (BlockSpec("attn", "mlp"),)),),
        act="gelu",
        source="[arXiv:2402.19173; hf]",
    )


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-15b-smoke", family="dense", d_model=32,
        vocab_size=256, d_ff=64,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=8),
        stages=(Stage(2, (BlockSpec("attn", "mlp"),)),),
        act="gelu",
    )
