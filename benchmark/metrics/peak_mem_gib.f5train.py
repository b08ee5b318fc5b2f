"""Peak device memory allocated in the window (reset at its start), GiB."""

from benchmark.readings import peak_mem_gib as read  # noqa: F401
