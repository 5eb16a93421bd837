"""Model zoo of the port in PyTorch: the dense attention + MLP families,
MoE (``moe``), MLA (``mla``), the recurrent mixers Mamba (``mamba``, in
the jamba hybrid) and RWKV-6 (``rwkv6``), and the modality frontend stubs.

Counterpart of ``repro.models`` with the same exports, as far as they
are ported (no ``loss_fn``: training is not ported yet).
"""
from .config import (AttentionConfig, BlockSpec, MambaConfig, MLAConfig,
                     ModelConfig, MoEConfig, Stage)
from .transformer import (ShardCtx, decode_step, forward, init_cache,
                          init_params, prefill)
from . import mamba, rwkv6  # noqa: F401  (the recurrent mixers' modules)

__all__ = [
    "AttentionConfig", "BlockSpec", "MambaConfig", "MLAConfig",
    "ModelConfig", "MoEConfig", "Stage",
    "ShardCtx", "decode_step", "forward", "init_cache", "init_params",
    "prefill",
]
