"""deepseek-v3-671b [moe] — 61L d_model=7168, MLA (128 heads),
vocab=129280, MoE 256 routed top-8 + 1 shared (d_expert=2048), MTP.
[arXiv:2412.19437; hf]

First 3 layers are dense (d_ff=18432 per HF config); the assignment's
d_ff=2048 is the per-expert hidden size.  MLA: q_lora=1536, kv_lora=512,
qk_nope=128, qk_rope=64, v_head=128.  MTP depth 1 (training-side head).
"""
from ..models.config import (BlockSpec, MLAConfig, ModelConfig,
                                 MoEConfig, Stage)

MLA = MLAConfig(n_heads=128, q_lora_rank=1536, kv_lora_rank=512,
                qk_nope_head_dim=128, qk_rope_head_dim=64,
                v_head_dim=128, rope_theta=10_000.0)


def make_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        d_model=7168,
        vocab_size=129_280,
        d_ff=18_432,                      # dense layers 0-2 only
        mla=MLA,
        moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1),
        stages=(
            Stage(3, (BlockSpec("mla", "mlp"),)),
            Stage(58, (BlockSpec("mla", "moe"),)),
        ),
        act="silu",
        mtp_depth=1,
        source="[arXiv:2412.19437; hf]",
    )


def make_smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-smoke", family="moe", d_model=32,
        vocab_size=256, d_ff=64,
        mla=MLAConfig(n_heads=4, q_lora_rank=16, kv_lora_rank=8,
                      qk_nope_head_dim=8, qk_rope_head_dim=4,
                      v_head_dim=8),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=16, n_shared=1),
        stages=(
            Stage(1, (BlockSpec("mla", "mlp"),)),
            Stage(2, (BlockSpec("mla", "moe"),)),
        ),
        act="silu",
        mtp_depth=1,
    )
