"""Runtime helpers of the PyTorch port.

``straggler.py`` is a copy of ``repro.runtime.straggler``: the
``SpeculativeExecutor`` behind ``make_pool("speculative")``.
``elastic.py`` is the reference's elastic-restart loop (``ElasticRunner``,
``FailureInjector``, ``rescale_batch_schedule``) on one device.
``sharding.py`` is the reference's rule engine (param, batch and cache
specs for a mesh), ``collectives.py`` the mesh axes and the differentiable
collectives over ``torch.distributed`` that the mesh path runs.
"""
from .elastic import (ElasticRunner, FailureInjector, rescale_batch_schedule,
                      reshard_tree)
from .straggler import SpeculativeExecutor

__all__ = ["ElasticRunner", "FailureInjector", "SpeculativeExecutor",
           "rescale_batch_schedule", "reshard_tree"]
