"""Seconds from the start of the run's process to the window's start."""

def read(run):
    return run.setup_s
