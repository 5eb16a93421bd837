"""launch_host_ms.uts (ms): over the tasks whose pool records end in the
window, the mean of each task's summed uts.stage_in, uts.launch and
uts.leftover spans (program spans matched by task id): the host's work on
a task's launches, their waits left out."""
from perfbench.spans import launch_host_ms


def read(ctx):
    return launch_host_ms(ctx)
