"""pool_settle_ms.uts (ms): the mean pool.settle span (a task body's
return to its future settled: slot released, record and completion event
written, the master woken) of the tasks whose pool records end in the
window; pool_overhead_ms.uts cannot see it, as a record ends before it."""
from perfbench.spans import pool_settle_ms


def read(ctx):
    return pool_settle_ms(ctx)
