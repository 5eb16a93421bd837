"""Brandes BFS levels over a CSR graph: hand CUDA kernels (``ops``) + plain versions (``ref``)."""
