"""Checkpoints of the port, in the reference's on-disk format
(counterpart of ``repro.checkpoint``)."""
from .manager import (CheckpointManager, latest_step, restore_pytree,
                      save_pytree)

__all__ = ["CheckpointManager", "latest_step", "restore_pytree",
           "save_pytree"]
