"""idle_in_sync_share.uts (fraction): seconds of the window in which the
device is idle (profiler) while some thread is inside the program's
uts.wait span (the pinned read of a launch's state and the stream's
synchronize), over the window: the card done and the host not yet back."""
from perfbench.spans import idle_in_sync_share


def read(ctx):
    return idle_in_sync_share(ctx)
