"""K1 with lse and K1b of the DiT's blocks: bounds of their launches in the traced slice over their device time, in %."""

from benchmark.readings import training_kernels_roofline as read  # noqa: F401
