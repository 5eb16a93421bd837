"""setup_s (s): process start to the first timed task, on the host clock:
imports, the inputs made from the seed, the kernels built (first run in a
checkout) and loaded, the warm-up job."""


def read(ctx):
    return ctx.setup_s
