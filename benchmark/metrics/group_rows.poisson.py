"""Mean requests per group call of the batcher in the window."""

from benchmark.readings import group_rows as read  # noqa: F401
