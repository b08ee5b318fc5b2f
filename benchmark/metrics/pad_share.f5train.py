"""Padded and fill-row frames over all frames of the window's batches, in %."""

from benchmark.readings import pad_share as read  # noqa: F401
