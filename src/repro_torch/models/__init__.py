"""Model zoo of the port in PyTorch: the dense attention + MLP families,
MoE (``moe``), MLA (``mla``), the recurrent mixers Mamba (``mamba``, in
the jamba hybrid) and RWKV-6 (``rwkv6``), and the modality frontend stubs.

Counterpart of ``repro.models`` with the same exports, ``loss_fn``
included: the training forward and loss run on one device (the
reference's ``ShardCtx`` mesh path raises ``NotImplementedError``).
"""
from .config import (AttentionConfig, BlockSpec, MambaConfig, MLAConfig,
                     ModelConfig, MoEConfig, Stage)
from .transformer import (ShardCtx, decode_step, forward, init_cache,
                          init_params, loss_fn, prefill)
from . import mamba, rwkv6  # noqa: F401  (the recurrent mixers' modules)

__all__ = [
    "AttentionConfig", "BlockSpec", "MambaConfig", "MLAConfig",
    "ModelConfig", "MoEConfig", "Stage",
    "ShardCtx", "decode_step", "forward", "init_cache", "init_params",
    "loss_fn", "prefill",
]
