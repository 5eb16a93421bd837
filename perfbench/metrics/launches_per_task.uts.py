"""launches_per_task.uts (launches): uts_expand and uts_hash launches over
the window (kernels/dispatch.py launches()), a task counted."""
from perfbench.readers import launches_per_task


def read(ctx):
    return launches_per_task(ctx, ("uts_expand", "uts_hash"))
