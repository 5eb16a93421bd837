"""The H100's peak rates, in one place, and the bound helpers built on them.

Every roofline figure of the port is reckoned against these constants:
the dry run's terms (``roofline.py``), the kernels' bounds (each kernel's
``work`` in ``kernels/*/ops.py``) and ``chip_smoke.py``'s bound column.
They are datasheet peaks, not measurements.

* ``PEAK_FLOPS``: dense bf16 tensor-core rate of one H100 SXM5 (NVIDIA
  H100 Tensor Core GPU datasheet, SXM5 column: 989 TFLOP/s without
  sparsity), ``PEAK_TF32_S`` its TF32 rate (495 TFLOP/s);
* ``PEAK_OPS_S``: the float32 rate outside the tensor cores (67 TFLOP/s,
  an FMA counted as two);
* ``HBM_BW``: HBM3 bandwidth, 3.35 TB/s;
* ``NVLINK_BW``: one direction of a GPU's fourth-generation NVLink inside
  a node of eight (900 GB/s both ways, the same datasheet), for a group
  whose ring stays inside one node;
* ``IB_BW``: one 400 Gb/s NDR InfiniBand port a GPU, as a DGX H100 has
  (NVIDIA DGX H100 datasheet: eight ConnectX-7 ports for eight GPUs),
  50 GB/s, for a group whose ring spans nodes.

A collective's ring moves at the rate of the slowest link it crosses
(:func:`link_bw`).  On the production mesh of 16 x 16 devices (32 nodes of
``NODE_GPUS``), ranks numbered model axis fastest, a model-axis group
spans 2 nodes and a data-axis group 16, so both axes run at ``IB_BW``; a
group of one rank crosses no link.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

__all__ = ["PEAK_FLOPS", "PEAK_TF32_S", "PEAK_OPS_S", "HBM_BW",
           "NVLINK_BW", "IB_BW", "NODE_GPUS", "link_class", "link_bw",
           "live_pairs", "product_s", "bound_ms"]

PEAK_FLOPS = 989e12
PEAK_TF32_S = 495e12
PEAK_OPS_S = 67e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
IB_BW = 50e9
NODE_GPUS = 8

#: bytes/s of each link class (:func:`link_class`); a group of one rank
#: moves nothing over a link
_LINK_BW = {"nvlink": NVLINK_BW, "ib": IB_BW}


def link_class(ranks: Iterable[int]) -> str:
    """"local" for a group of one rank, "nvlink" for a group inside one
    node of ``NODE_GPUS``, else "ib"."""
    ranks = list(ranks)
    if len(ranks) <= 1:
        return "local"
    return "nvlink" if len({r // NODE_GPUS for r in ranks}) == 1 else "ib"


def link_bw(cls: str) -> Optional[float]:
    """Bytes/s of a link class; None for "local" (no link)."""
    return _LINK_BW.get(cls)


def live_pairs(sq: int, skv: int, causal: bool, window) -> int:
    """(query, key) pairs one head attends to under the masks."""
    import numpy as np
    i = np.arange(sq, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    hi = np.minimum(i, skv - 1) if causal else np.full_like(i, skv - 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def product_s(flops: float, dtype) -> float:
    """Least seconds for a product of ``flops`` whose operands are of
    ``dtype``, kept to that type's accuracy.  bf16 runs at the bf16
    tensor-core rate.  A float32 product takes three TF32 passes (hi.hi +
    hi.lo + lo.hi of each operand split into two TF32 values): one pass
    keeps 10 of float32's 23 mantissa bits and misses the float32
    tolerance (``tests/test_torch_flash_attention.py`` holds both), and
    three passes at ``PEAK_TF32_S`` still beat the CUDA cores'
    ``PEAK_OPS_S``."""
    import torch
    if dtype == torch.bfloat16:
        return flops / PEAK_FLOPS
    return 3 * flops / PEAK_TF32_S


def bound_ms(n_bytes: float, n_ops: float, ops_s: float = PEAK_OPS_S
             ) -> Tuple[float, str]:
    """(least ms, "bytes" or "operations"): ``n_bytes`` at ``HBM_BW``
    against ``n_ops`` at ``ops_s``, the larger."""
    t_bytes = n_bytes / HBM_BW * 1e3
    t_ops = n_ops / ops_s * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")
