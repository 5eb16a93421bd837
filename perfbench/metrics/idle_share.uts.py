"""idle_share.uts (fraction): 1 - (union of all device activity in the
window) / window, from the profiler's device trace."""
from perfbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
