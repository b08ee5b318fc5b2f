"""Analytic FLOP of a step on each real utterance of the window, over the window and the bf16 peak, in %."""

from benchmark.readings import train_mfu as read  # noqa: F401
