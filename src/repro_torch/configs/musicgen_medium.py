"""musicgen-medium [audio] — 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Backbone only: the EnCodec frontend is a STUB — ``input_specs()`` feeds
precomputed frame embeddings [B, S, d] (cfg.frontend="encodec"); labels
are codebook token ids over the 2048-entry vocab.
"""
from ..models.config import (AttentionConfig, BlockSpec, ModelConfig,
                                 Stage)

ATTN = AttentionConfig(n_heads=24, n_kv_heads=24, head_dim=64,
                       rope_theta=10_000.0)


def make_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        d_model=1536,
        vocab_size=2048,
        d_ff=6144,
        attention=ATTN,
        stages=(Stage(48, (BlockSpec("attn", "mlp"),)),),
        act="gelu",
        frontend="encodec",
        source="[arXiv:2306.05284; hf]",
    )


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium-smoke", family="audio", d_model=32,
        vocab_size=128, d_ff=64,
        attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=8),
        stages=(Stage(2, (BlockSpec("attn", "mlp"),)),),
        act="gelu", frontend="encodec",
    )
