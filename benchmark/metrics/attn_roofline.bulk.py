"""K1 (masked attention forward): bounds of its launches in the traced slice over its device time there, in %."""

from benchmark.readings import attention_roofline as read  # noqa: F401
