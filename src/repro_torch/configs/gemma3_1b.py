"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144, 5:1 local:global, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

Pattern: 5 sliding-window (512) local layers per global layer; 26 layers
= 4 full periods of 6 + 2 local tail layers.  Local layers use
theta=10k, globals theta=1M (the gemma3 long-context recipe).  1B ties
embeddings.  Sub-quadratic (5/6 of layers windowed) => long_500k RUNS.
"""
from ..models.config import (AttentionConfig, BlockSpec, ModelConfig,
                                 Stage)

LOCAL = AttentionConfig(n_heads=4, n_kv_heads=1, head_dim=256,
                        rope_theta=10_000.0, sliding_window=512)
GLOBAL = AttentionConfig(n_heads=4, n_kv_heads=1, head_dim=256,
                         rope_theta=1_000_000.0)


def make_config() -> ModelConfig:
    period = tuple([BlockSpec("attn", "mlp", attn_override=LOCAL)] * 5
                   + [BlockSpec("attn", "mlp", attn_override=GLOBAL)])
    tail = (BlockSpec("attn", "mlp", attn_override=LOCAL),)
    return ModelConfig(
        name="gemma3-1b",
        family="dense",
        d_model=1152,
        vocab_size=262_144,
        d_ff=6912,
        attention=GLOBAL,
        stages=(Stage(4, period), Stage(2, tail)),
        tie_embeddings=True,
        act="gelu",
        subquadratic=True,
        source="[hf:google/gemma-3-1b-pt; unverified]",
    )


def make_smoke_config() -> ModelConfig:
    local = AttentionConfig(n_heads=2, n_kv_heads=1, head_dim=16,
                            rope_theta=10_000.0, sliding_window=8)
    glob = AttentionConfig(n_heads=2, n_kv_heads=1, head_dim=16)
    period = tuple([BlockSpec("attn", "mlp", attn_override=local)] * 2
                   + [BlockSpec("attn", "mlp", attn_override=glob)])
    return ModelConfig(
        name="gemma3-1b-smoke", family="dense", d_model=32,
        vocab_size=256, d_ff=64, attention=glob,
        stages=(Stage(2, period), Stage(1, (BlockSpec(
            "attn", "mlp", attn_override=local),))),
        tie_embeddings=True, act="gelu", subquadratic=True,
    )
