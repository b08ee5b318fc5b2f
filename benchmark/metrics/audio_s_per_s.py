"""Seconds of audio in the WAVs completed in the window, over the window's seconds."""

from benchmark.readings import audio_s_per_s as read  # noqa: F401
