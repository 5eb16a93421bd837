"""The work two kernels' rooflines count, frozen with the benchmark.

Each formula counts what any implementation of the step must do, from the
step's inputs and outputs alone, so a later change to a kernel cannot move
its own yardstick.  The peaks are in ``peaks.py``.
"""
