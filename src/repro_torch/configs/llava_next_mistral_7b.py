"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=32000 — anyres tiling.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

Backbone only (Mistral-7B): the anyres vision tower + projector are a
STUB — ``input_specs()`` feeds precomputed patch+text embeddings
[B, S, d] (cfg.frontend="vision_patches").  The irregular #tiles per
image shows up as irregular prefill lengths — the elastic batcher's
native workload.
"""
from ..models.config import (AttentionConfig, BlockSpec, ModelConfig,
                                 Stage)

ATTN = AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                       rope_theta=1_000_000.0)


def make_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        d_model=4096,
        vocab_size=32_000,
        d_ff=14_336,
        attention=ATTN,
        stages=(Stage(32, (BlockSpec("attn", "mlp"),)),),
        act="silu",
        frontend="vision_patches",
        source="[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]",
    )


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b-smoke", family="vlm", d_model=32,
        vocab_size=256, d_ff=64,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=8),
        stages=(Stage(2, (BlockSpec("attn", "mlp"),)),),
        act="silu", frontend="vision_patches",
    )
