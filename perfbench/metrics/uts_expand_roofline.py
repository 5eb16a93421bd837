"""uts_expand_roofline (%): the least time of the work of every UTS task
the profile saw (metrics/work/uts_expand.py: children hashed at 901
operations each against the float32 peak, or the bag read and leftover
written at HBM bandwidth, the larger) over the union of uts_expand_kernel's
device intervals in the same profile."""
from perfbench.metrics.work.uts_expand import least_s
from perfbench.readers import roofline_pct


def read(ctx):
    work = sum(least_s(r.info["bag_in"], int(r.work), r.info["leftover"])
               for r in ctx.tasks if not r.failed)
    return roofline_pct(ctx, ("uts_expand_kernel",), work)
