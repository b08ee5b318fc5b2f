"""95th percentile of request latency (due to WAV returned) over all requests due in the window."""

from benchmark.readings import latency_ms


def read(run):
    return latency_ms(run, 95)
