"""Real coarse mel frames of the window's steps (no fill rows, no padding) over its seconds."""

from benchmark.readings import train_frames_per_s as read  # noqa: F401
