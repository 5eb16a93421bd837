"""PyTorch/CUDA port of the elastic-serverless irregular-algorithms system.

A second package beside the JAX reference ``repro``, with the same
layout and module names.  It imports ``torch`` and never ``jax``, and
nothing of ``repro``: what it needs of the reference it keeps as its own
copy.  Every entry point takes ``device=None``, which means the CUDA
card (``device.resolve_device``); the CPU is used only when asked for.

Ported so far: the dispatch registry and all three kernels of the
reference (``kernels``: ``uts_hash`` SHA-1, ``mandelbrot`` dwell and
``flash_attention_fwd``, each a hand-written CUDA kernel with a plain
PyTorch version), the elastic pool core (``core``), UTS and
Mariani-Silver (``algorithms``), and the dense model stack (``models``,
``configs``: gemma3-1b, glm4-9b) with prefill, decode and the elastic
serving loop (``serving``, ``launch.serve``).
"""
