"""Fused flash attention, forward and backward: hand-written CUDA kernels
(csrc/flash_attention.cu, csrc/flash_attention_bwd.cu) and their plain
versions."""
