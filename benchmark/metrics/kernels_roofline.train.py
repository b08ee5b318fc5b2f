"""K1 with lse, K1b and MAS together: bounds of their launches in the traced slice over their device time, in %."""

from benchmark.readings import training_kernels_roofline as read  # noqa: F401
