"""Mamba's selective scan over time: hand CUDA kernel (``ops``) + plain version (``ref``)."""
