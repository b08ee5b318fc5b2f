"""Mean time the loop blocked waiting for its next batch from the prefetch thread."""

from benchmark.readings import batch_wait_ms as read  # noqa: F401
