"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE.
[arXiv:2403.19887; hf]

Each 8-layer Jamba block: attention at index 4, Mamba elsewhere (1:7);
MoE replaces the MLP on every second layer (odd indices).  4 blocks.
Mamba recurrent state => long_500k RUNS.
"""
from ..models.config import (AttentionConfig, BlockSpec, MambaConfig,
                                 ModelConfig, MoEConfig, Stage)

ATTN = AttentionConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                       rope_theta=10_000.0)


def _pattern(attn_cfg):
    blocks = []
    for i in range(8):
        mixer = "attn" if i == 4 else "mamba"
        ffn = "moe" if i % 2 == 1 else "mlp"
        blocks.append(BlockSpec(mixer, ffn,
                                attn_override=attn_cfg if mixer == "attn"
                                else None))
    return tuple(blocks)


def make_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        d_model=4096,
        vocab_size=65_536,
        d_ff=14_336,
        attention=ATTN,
        moe=MoEConfig(n_experts=16, top_k=2, d_expert=14_336),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        stages=(Stage(4, _pattern(ATTN)),),
        act="silu",
        subquadratic=True,
        source="[arXiv:2403.19887; hf]",
    )


def make_smoke_config() -> ModelConfig:
    attn = AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=8)
    return ModelConfig(
        name="jamba-v0.1-52b-smoke", family="hybrid", d_model=32,
        vocab_size=256, d_ff=64,
        attention=attn,
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=16),
        mamba=MambaConfig(d_state=4, d_conv=2, expand=2),
        stages=(Stage(1, _pattern(attn)),),
        act="silu", subquadratic=True,
    )
