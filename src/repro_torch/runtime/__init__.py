"""Runtime helpers of the PyTorch port.

``straggler.py`` is a copy of ``repro.runtime.straggler``: the
``SpeculativeExecutor`` behind ``make_pool("speculative")``.  The
reference's ``elastic`` and ``sharding`` modules (multi-device training
runtime) are not ported yet.
"""
from .straggler import SpeculativeExecutor

__all__ = ["SpeculativeExecutor"]
