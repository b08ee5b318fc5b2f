"""Median wall time of the group calls (one row each) in the window."""

from benchmark.readings import group_call_ms


def read(run):
    return group_call_ms(run, 50)
