"""master_busy_share.uts (fraction): the union of the master's spans
(master.seed, master.fold with its split and dispatch, master.close; its
wait on completions left out) within the window, over the window."""
from perfbench.spans import master_busy_share


def read(ctx):
    return master_busy_share(ctx)
