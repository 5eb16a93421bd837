"""Workload configurations of the port.

``paper_workloads`` holds the paper's UTS, Mariani-Silver and BC rows.  The
architecture registry (``--arch <id>``) is the counterpart of
``repro.configs``: the same ids in the same order, each config a copy of
the reference's with only its imports changed.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from .shapes import SHAPES, ShapeSpec, cell_applicable

#: every arch id of the reference registry -> the port's module
_MODULES: Dict[str, str] = {
    "gemma3-1b": "gemma3_1b",
    "glm4-9b": "glm4_9b",
    "chatglm3-6b": "chatglm3_6b",
    "starcoder2-15b": "starcoder2_15b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "musicgen-medium": "musicgen_medium",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}

ARCH_IDS: List[str] = list(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"{__name__}.{_MODULES[arch]}")


def get_config(arch: str):
    return _module(arch).make_config()


def get_smoke_config(arch: str):
    return _module(arch).make_smoke_config()


__all__ = ["ARCH_IDS", "get_config", "get_smoke_config", "SHAPES",
           "ShapeSpec", "cell_applicable"]
