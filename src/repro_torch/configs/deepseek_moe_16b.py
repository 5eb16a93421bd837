"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (MHA, kv=16) vocab=102400,
MoE 64 routed experts top-6 + 2 shared, fine-grained (d_expert=1408).
[arXiv:2401.06066; hf]

The assignment's d_ff=1408 is the per-expert hidden size (fine-grained
granularity); the single dense layer 0 uses 10944 per the HF config.
"""
from ..models.config import (AttentionConfig, BlockSpec, ModelConfig,
                                 MoEConfig, Stage)

ATTN = AttentionConfig(n_heads=16, n_kv_heads=16, head_dim=128,
                       rope_theta=10_000.0)


def make_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        d_model=2048,
        vocab_size=102_400,
        d_ff=10_944,                      # dense layer 0 only
        attention=ATTN,
        moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
        stages=(
            Stage(1, (BlockSpec("attn", "mlp"),)),
            Stage(27, (BlockSpec("attn", "moe"),)),
        ),
        act="silu",
        source="[arXiv:2401.06066; hf]",
    )


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b-smoke", family="moe", d_model=32,
        vocab_size=256, d_ff=64,
        attention=AttentionConfig(n_heads=4, n_kv_heads=4, head_dim=8),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=16, n_shared=1),
        stages=(
            Stage(1, (BlockSpec("attn", "mlp"),)),
            Stage(2, (BlockSpec("attn", "moe"),)),
        ),
        act="silu",
    )
