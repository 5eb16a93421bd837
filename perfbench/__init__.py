"""The port's benchmark: data-driven cells over ``repro_torch``.

``python perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line (``harness.py``).  Nothing here imports JAX or the
JAX package; ``reference/`` imports nothing of the program either.
"""
