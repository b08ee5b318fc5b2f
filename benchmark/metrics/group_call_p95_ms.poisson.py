"""95th percentile of the group calls' wall time in the window."""

from benchmark.readings import group_call_ms


def read(run):
    return group_call_ms(run, 95)
