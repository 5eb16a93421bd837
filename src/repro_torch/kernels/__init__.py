"""Hand-written CUDA kernels of the port + the shared dispatch registry.

Each package's ``ops.py`` registers a
:class:`~repro_torch.kernels.dispatch.KernelOp` (CUDA body, plain
PyTorch reference body, elastic axes + pad constants, bucket floor, cost
hint) and exposes a public wrapper that calls
:func:`~repro_torch.kernels.dispatch.dispatch`.  The CUDA sources live
in ``csrc/`` and are built on first use by ``_build.py``.
"""
from .dispatch import (KernelOp, bucket, dispatch, estimate_cost,
                       get_kernel, launches, register_kernel,
                       registered_kernels, reset_launches)

__all__ = [
    "KernelOp", "bucket", "dispatch", "estimate_cost",
    "get_kernel", "launches", "register_kernel", "registered_kernels",
    "reset_launches",
]
