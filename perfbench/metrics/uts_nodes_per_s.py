"""uts_nodes_per_s (nodes/s): nodes counted by the UTS tasks whose bodies
ended in the window, over the whole window (host clock)."""
from perfbench.readers import work_per_s


def read(ctx):
    return work_per_s(ctx)
