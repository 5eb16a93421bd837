"""The benchmark's plain reference: SHA-1 UTS.

Nothing here imports the program (``repro_torch``) or the JAX package;
``tests/test_perfbench_imports.py`` holds that.
"""
