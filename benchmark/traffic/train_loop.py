"""The training loop: the trainer's own epochs over the mix's corpus, step
after step until the window closes (``benchmark/training.py``)."""

from benchmark.training import Driver  # noqa: F401
