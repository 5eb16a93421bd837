"""task_p95_ms (ms): 95th percentile over every task whose body ended in
the window of its body's time, the benchmark's span around the spec's
execute (host clock): what a straggler invocation lasts."""
from perfbench.readers import p95_ms


def read(ctx):
    return p95_ms(ctx)
