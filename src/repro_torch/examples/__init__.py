"""Runnable tours of the port, twins of the reference's ``examples/``.

    python -m repro_torch.examples.quickstart
    python -m repro_torch.examples.mandelbrot_render
    python -m repro_torch.examples.betweenness_centrality

Each module has a ``main(device=None, ...)`` that runs on the CUDA card by
default (``device="cpu"`` when asked), takes its workload's sizes
(defaulting to the reference example's own), asserts its oracle as the
reference does, and returns what it measured as a dict.
"""
