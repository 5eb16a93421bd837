"""RWKV-6's WKV recurrence over time: hand CUDA kernel (``ops``) + plain version (``ref``)."""
