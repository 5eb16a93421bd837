"""Synthetic LM data of the port: a copy of ``repro.data``."""
from .pipeline import DataConfig, Prefetcher, SyntheticLM

__all__ = ["DataConfig", "Prefetcher", "SyntheticLM"]
