"""Analytic FLOP of the requests completed in the window at their own lengths, over the window and the bf16 peak, in %."""

from benchmark.readings import serve_mfu as read  # noqa: F401
