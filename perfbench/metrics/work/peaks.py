"""Datasheet peaks of one NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU
datasheet, dense rates, at the full 700 W limit), as the port states them
today; copied here so that the yardstick does not move with the program.

* ``PEAK_OPS_S``: float32 rate outside the tensor cores, 67 TFLOP/s (an
  FMA counted as two); the UTS bound holds 32-bit integer operations
  against it (the card has half as many INT32 lanes, so the bound is
  loose by design);
* ``HBM_BW``: HBM3 bandwidth, 3.35 TB/s.
"""
PEAK_OPS_S = 67e12
HBM_BW = 3.35e12
