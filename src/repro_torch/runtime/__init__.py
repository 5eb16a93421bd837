"""Runtime helpers of the PyTorch port.

``straggler.py`` is a copy of ``repro.runtime.straggler``: the
``SpeculativeExecutor`` behind ``make_pool("speculative")``.
``elastic.py`` is the reference's elastic-restart loop (``ElasticRunner``,
``FailureInjector``, ``rescale_batch_schedule``) on one device.  The
reference's ``sharding`` module (multi-device training) is not ported yet
(ROADMAP.md, queue 4).
"""
from .elastic import (ElasticRunner, FailureInjector, rescale_batch_schedule,
                      reshard_tree)
from .straggler import SpeculativeExecutor

__all__ = ["ElasticRunner", "FailureInjector", "SpeculativeExecutor",
           "rescale_batch_schedule", "reshard_tree"]
