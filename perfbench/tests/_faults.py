"""Shared by the fault tests: one rehearsal run in this process, with the
program's task body broken underneath from the window's start, returning
the result line."""
import time

import torch

from perfbench import harness


def breaking(module, name: str, broken):
    """Set ``module.name`` to ``broken`` once the set-up has ended (so that
    a fault that never ends a job leaves the warm-up whole); returns the
    harness's log function that arms it."""
    def log_fn(message: str) -> None:
        if message.startswith("set-up"):
            setattr(module, name, broken)
    return log_fn


def rehearse(cell_name: str, seed: int = 11, seconds: float = 2.0,
             log_fn=lambda s: None):
    cell = harness.load_cell(cell_name)
    return harness.run_cell(cell, seed, seconds, False, torch.device("cpu"),
                            time.monotonic(),
                            overrides=cell.spec["rehearsal"], log_fn=log_fn)
