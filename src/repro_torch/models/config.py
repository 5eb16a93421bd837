"""Model configuration schema covering all assigned architecture families.

Copy of ``repro.models.config`` (pure dataclasses).  The stage/period
structure is kept; the port runs a stage's periods as a Python loop
over per-period parameter dicts instead of a ``lax.scan``.

A model is a sequence of *stages*; each stage is a ``lax.scan`` over
``n_periods`` repetitions of a *pattern* (a static list of blocks).  This
uniform structure keeps HLO size bounded at 512 devices for every family:

  dense          1 stage, pattern=[attn+mlp],         n_periods=n_layers
  gemma3 (5:1)   stage(pattern=[local x5, global]) + unrolled local tail
  deepseek-moe   stage(dense x1) + stage(moe x27)
  deepseek-v3    stage(dense x3) + stage(mla+moe x58)
  jamba          stage(pattern of 8: mamba/attn x moe/mlp interleave) x4
  rwkv6          1 stage, pattern=[rwkv_block]
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

__all__ = [
    "AttentionConfig", "MLAConfig", "MoEConfig", "MambaConfig",
    "BlockSpec", "Stage", "ModelConfig",
]


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10_000.0
    #: rotary applied to the first ``rotary_dim`` dims of each head
    #: (chatglm applies RoPE to half the head dim — "2d" RoPE)
    rotary_dim: Optional[int] = None
    #: sliding-window width for local attention layers (None = global)
    sliding_window: Optional[int] = None
    #: logit soft-capping (gemma-style); None disables
    logit_softcap: Optional[float] = None

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""
    n_heads: int
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    rope_theta: float = 10_000.0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    n_shared: int = 0             # shared ("always-on") experts
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    #: route in f32 for numerics even when activations are bf16
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # defaults to ceil(d_model/16)


@dataclass(frozen=True)
class BlockSpec:
    """One layer of a period pattern."""
    mixer: str                    # "attn" | "mla" | "mamba" | "rwkv6" | "none"
    ffn: str                      # "mlp" | "moe" | "rwkv6_cmix" | "none"
    #: overrides the model-level attention config (e.g. local layers)
    attn_override: Optional[AttentionConfig] = None


@dataclass(frozen=True)
class Stage:
    n_periods: int
    pattern: Tuple[BlockSpec, ...]

    @property
    def n_layers(self) -> int:
        return self.n_periods * len(self.pattern)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    vocab_size: int
    stages: Tuple[Stage, ...]
    d_ff: int
    attention: Optional[AttentionConfig] = None
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    #: rwkv6 head size (d_model / head_size heads)
    rwkv_head_size: int = 64
    norm_eps: float = 1e-6
    act: str = "silu"             # silu | gelu
    tie_embeddings: bool = False
    #: deepseek-v3 multi-token-prediction depth (training-side aux head)
    mtp_depth: int = 0
    #: modality frontend stub: None | "encodec" | "vision_patches".
    #: Stubs mean input_specs() feeds precomputed [B, S, d] embeddings.
    frontend: Optional[str] = None
    dtype: str = "bfloat16"
    #: sub-quadratic? (drives long_500k cell applicability)
    subquadratic: bool = False
    #: source annotation: [source; verification-tier]
    source: str = ""

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.stages)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d = self.d_model
        total = self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            total += d * self.vocab_size                 # lm head
        for stage in self.stages:
            per_period = 0
            for spec in stage.pattern:
                per_period += self._block_params(spec)
            total += per_period * stage.n_periods
        total += d                                       # final norm
        return total

    def _block_params(self, spec: BlockSpec) -> int:
        d = self.d_model
        n = 0
        if spec.mixer == "attn":
            a = spec.attn_override or self.attention
            n += d * a.q_dim + 2 * d * a.kv_dim + a.q_dim * d
            n += d  # input norm
        elif spec.mixer == "mla":
            m = self.mla
            n += d * m.q_lora_rank + m.q_lora_rank * m.n_heads * m.qk_head_dim
            n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            n += m.kv_lora_rank * m.n_heads * (m.qk_nope_head_dim
                                               + m.v_head_dim)
            n += m.n_heads * m.v_head_dim * d
            n += d + m.q_lora_rank + m.kv_lora_rank  # norms
        elif spec.mixer == "mamba":
            mb = self.mamba
            d_in = mb.expand * d
            dt_rank = mb.dt_rank or -(-d // 16)
            n += d * 2 * d_in            # in_proj
            n += d_in * mb.d_conv        # depthwise conv
            n += d_in * (dt_rank + 2 * mb.d_state)  # x_proj
            n += dt_rank * d_in + d_in   # dt_proj
            n += d_in * mb.d_state + d_in  # A_log, D
            n += d_in * d                # out_proj
            n += d
        elif spec.mixer == "rwkv6":
            h = d // self.rwkv_head_size
            n += 4 * d * d + d * d       # r,k,v,g,o
            n += 2 * 32 * d + 2 * 64 * d  # lora-ish mixers (approx)
            n += h * self.rwkv_head_size + d
        if spec.ffn == "mlp":
            n += 3 * d * self.d_ff + d if self.act == "silu" \
                else 2 * d * self.d_ff + d
        elif spec.ffn == "moe":
            m = self.moe
            n += m.n_experts * 3 * d * m.d_expert
            n += m.n_shared * 3 * d * m.d_expert
            n += d * m.n_experts         # router
            n += d
        elif spec.ffn == "rwkv6_cmix":
            n += d * int(3.5 * d) + int(3.5 * d) * d + 2 * d + d
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top_k experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        d = self.d_model
        m = self.moe
        moe_layers = sum(
            st.n_periods * sum(1 for sp in st.pattern if sp.ffn == "moe")
            for st in self.stages)
        inactive = moe_layers * (m.n_experts - m.top_k) * 3 * d * m.d_expert
        return full - inactive
