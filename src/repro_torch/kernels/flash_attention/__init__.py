"""Fused flash attention (forward): hand-written CUDA kernel + plain version."""
