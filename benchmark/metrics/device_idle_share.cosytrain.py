"""Share of the traced slice in which no kernel, copy or set ran on the device, in %."""

from benchmark.readings import idle_share as read  # noqa: F401
