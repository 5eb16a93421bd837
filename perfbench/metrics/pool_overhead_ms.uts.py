"""pool_overhead_ms.uts (ms): the mean time the pool's records
(pool.events, a program span) give a task that completed in the window,
less the mean of the benchmark's spans around the window's task bodies and
of the check's hooks beside them (timed on the host clock): invocation
overhead, admission and the worker's own bookkeeping."""
from perfbench.readers import pool_overhead_ms


def read(ctx):
    return pool_overhead_ms(ctx)
