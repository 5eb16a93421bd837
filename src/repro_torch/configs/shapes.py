"""Assigned input shapes (one set, shared by all LM archs).

  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> prefill_step
  decode_32k   seq 32,768  global_batch 128   -> serve_step (1 new token,
                                                 KV cache of seq_len)
  long_500k    seq 524,288 global_batch 1     -> serve_step; sub-quadratic
                                                 archs only (cfg.subquadratic)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

__all__ = ["ShapeSpec", "SHAPES", "cell_applicable"]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg, shape: ShapeSpec) -> bool:
    """long_500k runs only for sub-quadratic archs (DESIGN.md §4)."""
    if shape.name == "long_500k":
        return bool(cfg.subquadratic)
    return True
