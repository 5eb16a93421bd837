"""Optimizer of the port: AdamW with its schedule, and int8 gradient
compression with error feedback (counterpart of ``repro.optim``)."""
from .adamw import (AdamWConfig, adamw_update, clip_by_global_norm,
                    cosine_schedule, decay_mask, global_norm, init_opt_state,
                    tree_leaves, tree_map)
from .compression import compress, decompress, ef_roundtrip, init_ef

__all__ = [
    "AdamWConfig", "adamw_update", "clip_by_global_norm",
    "cosine_schedule", "decay_mask", "global_norm", "init_opt_state",
    "tree_leaves", "tree_map",
    "compress", "decompress", "ef_roundtrip", "init_ef",
]
